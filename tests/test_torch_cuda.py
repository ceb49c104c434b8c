"""The port's CUDA kernels on the card: build them from ``csrc/`` with
nvcc, then hold K1 and K3 against their plain versions at the main path's
shapes (``chip_smoke.py`` phases 2 and 3).  Skips without a card; on the
card run

    python -m pytest -m cuda tests/test_torch_cuda.py

Unlike the parity tests, this file does not import JAX, so that it runs
where only PyTorch is installed.
"""

import os
import shutil

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    if shutil.which("nvcc") is None and not os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.build_kernels()
    return torch.cuda.get_device_name(0)


def test_beam_attention_kernel_matches_plain_version(card):
    assert chip_smoke.check_beam_attention() >= 0.0


def test_flash_attention_kernel_matches_plain_version(card):
    assert chip_smoke.check_flash_attention() >= 0.0


def test_wrappers_count_launches_and_reject_what_the_kernels_do_not_take(card):
    from faster_whisper_tpu_torch.ops.attention import mha_flash
    from faster_whisper_tpu_torch.ops.beam_attention import beam_attend_append

    q, k, v = chip_smoke.k3_inputs(1, S=100)
    n = mha_flash.launches
    mha_flash(q, k, v)
    assert mha_flash.launches == n + 1
    with pytest.raises(TypeError):
        mha_flash(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        mha_flash(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))

    x = chip_smoke.k1_inputs(1, 3)
    n = beam_attend_append.launches
    chip_smoke._k1_call(beam_attend_append, x)
    assert beam_attend_append.launches == n + 1
    with pytest.raises(TypeError):
        beam_attend_append(
            0, x["pos_row"].long(), x["q"], x["k_new"], x["v_new"],
            x["self_k"], x["self_v"], x["anc"],
        )
