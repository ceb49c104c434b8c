"""The port's CUDA kernels on the card: build them from ``csrc/`` with
nvcc, then hold every form of K1, K2, K3 and K4 (bfloat16 and float32
activations, raw and int8 caches) against their plain versions at the
main path's shapes and at ragged ones (``chip_smoke.py`` phases 2 and 3:
K1/K2 with the write position on and beside their column chunks'
boundaries, and in a CUDA graph), and a small model at every compute type
against the CPU.  Skips without
a card; on the card run

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


def test_float32_beam_attention_kernel_matches_plain_version(card):
    assert chip_smoke.check_beam_attention(dtype=torch.float32) >= 0.0


def test_int8_beam_attention_kernel_matches_plain_version(card):
    err, _codes_one_unit_apart = chip_smoke.check_beam_attention_int8()
    assert err >= 0.0


def test_int8_beam_attention_kernel_with_float32_activations_matches_plain_version(card):
    err, _codes_one_unit_apart = chip_smoke.check_beam_attention_int8(dtype=torch.float32)
    assert err >= 0.0


def test_beam_attention_kernels_in_a_cuda_graph_reset_their_tickets(card):
    """Every form of K1/K2, two layers in one CUDA graph, replayed twice."""
    for form in chip_smoke.K1_FORMS:
        chip_smoke.check_beam_attention_graph(form)


def test_flash_attention_kernel_matches_plain_version(card):
    assert chip_smoke.check_flash_attention(**chip_smoke.K3_SHAPES) >= 0.0


def test_float32_flash_attention_kernel_matches_plain_version(card):
    assert chip_smoke.check_flash_attention(**chip_smoke.K3_SHAPES, dtype=torch.float32) >= 0.0


def test_cross_attention_kernel_matches_plain_version(card):
    """Every form at ragged and full T, 1 to 16 beams, two calls back to
    back and two layers in one CUDA graph."""
    worst = chip_smoke.check_cross_attention(
        batches=(1, 8), Ts=(1, 100, 1500, 1501), Ks=(1, 5, 16), L=2
    )
    assert set(worst) == {"bf16", "int8", "f32", "int8 f32", "int8 qmax7", "int8 qmax7 f32"}


def test_small_model_on_the_card_matches_the_cpu_at_every_compute_type(card):
    chip_smoke.check_small_model_against_cpu()


def test_int8_dense_on_the_card_matches_the_cpu(card):
    """The card's int8 product (rows padded to 17 for torch._int_mm) gives
    the CPU's exact int32 sums: at 5 rows, the decode's beam grid, and at
    the padded 51872-column logits head."""
    from faster_whisper_tpu_torch.ops.quant import int8_dense, quantize_weight

    g = torch.Generator().manual_seed(0)
    for rows, n_out in ((5, 1280), (40, 51872)):
        x = torch.randn((rows, 1280), generator=g)
        w = quantize_weight(0.02 * torch.randn((1280, n_out), generator=g))
        cpu = int8_dense(x, w, out_dtype=torch.float32)
        w_card = type(w)(w.q.cuda(), w.s.cuda())
        card = int8_dense(x.cuda(), w_card, out_dtype=torch.float32).cpu()
        torch.testing.assert_close(card, cpu, rtol=1e-6, atol=1e-6)


def test_grouped_int8_dense_on_the_card_matches_the_cpu(card):
    """int4's group-wise product on the card (one torch._int_mm per group
    of input rows; rows padded to 17, and to a multiple of 32 for groups
    below 128 rows) against the CPU's, at the beam grid's 5 rows, the
    batched pipeline's 40 and an encoder window's 1500 and 3000, over 1280
    and 5120 input rows in groups of 32, 64 and 128: exact int32 partials,
    the float32 sum over the groups within 1e-6."""
    from faster_whisper_tpu_torch.ops.quant import int8_dense, quantize_weight

    g = torch.Generator().manual_seed(1)
    for rows, n_in, group in ((5, 1280, 128), (40, 5120, 128), (5, 1280, 64), (40, 1280, 32),
                              (1500, 1280, 64), (3000, 256, 64), (1500, 5120, 128)):
        x = torch.randn((rows, n_in), generator=g)
        w = quantize_weight(0.02 * torch.randn((n_in, 1280), generator=g), qmax=7, group_size=group)
        cpu = int8_dense(x, w, out_dtype=torch.float32)
        card = int8_dense(x.cuda(), type(w)(w.q.cuda(), w.s.cuda()), out_dtype=torch.float32).cpu()
        torch.testing.assert_close(card, cpu, rtol=1e-6, atol=1e-6)


def test_wrappers_count_launches_and_reject_what_the_kernels_do_not_take(card):
    from faster_whisper_tpu_torch.ops.attention import mha_flash
    from faster_whisper_tpu_torch.ops.beam_attention import beam_attend_append

    q, k, v = chip_smoke.k3_inputs(1, S=100)
    n = (mha_flash.launches, mha_flash.launches_f32)
    mha_flash(q, k, v)
    mha_flash(q.float(), k.float(), v.float())
    assert (mha_flash.launches, mha_flash.launches_f32) == (n[0] + 1, n[1] + 1)
    with pytest.raises(TypeError):
        mha_flash(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        mha_flash(q, k.float(), v)
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
    with pytest.raises(ValueError):  # the kernel is built for a head dim of 64
        chip_smoke._k1_call(beam_attend_append, chip_smoke.k1_inputs(1, 3, D=32))

    x = chip_smoke.k2_inputs(1, 3)
    n, n1 = beam_attend_append.launches_int8, beam_attend_append.launches
    chip_smoke._k1_call(beam_attend_append, x)
    assert (beam_attend_append.launches_int8, beam_attend_append.launches) == (n + 1, n1)
    with pytest.raises(TypeError):  # f32 scales: the kernel takes bf16
        sk = type(x["self_k"])(x["self_k"].q, x["self_k"].s.float())
        beam_attend_append(
            0, x["pos_row"], x["q"], x["k_new"], x["v_new"], sk, x["self_v"], x["anc"],
        )

    from faster_whisper_tpu_torch.ops.cross_attention import cross_attend

    names = ("launches", "launches_f32", "launches_int8", "launches_int8_f32")
    for quant, dtype, counter in (
        (False, torch.bfloat16, "launches"), (False, torch.float32, "launches_f32"),
        (True, torch.bfloat16, "launches_int8"), (True, torch.float32, "launches_int8_f32"),
    ):
        layer, q, ck, cv = chip_smoke.k4_inputs(1, quant, T=100, dtype=dtype)
        n = {a: getattr(cross_attend, a) for a in names}
        cross_attend(layer, q, ck, cv)
        assert {a: getattr(cross_attend, a) for a in names} == {a: n[a] + (a == counter) for a in names}
        with pytest.raises(TypeError):
            cross_attend(layer, q.half(), ck, cv)
        with pytest.raises(ValueError):  # more beams than the kernel holds
            cross_attend(layer, q.repeat(1, 1, 4, 1), ck, cv)
        if not quant:
            with pytest.raises(TypeError):  # a raw cache in another dtype than q
                other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
                cross_attend(layer, q, ck.to(other), cv.to(other))


def test_speculative_encode_on_the_side_stream_equals_the_in_line_encode(card):
    """A small model at bf16, int8 and float32: the side stream's encode is
    ``torch.equal`` to the in-line one and launches K3 and no K1, K2 or
    K4; with speculation on, a sequential request gives the segments it
    gives with speculation off, with at least one hit."""
    chip_smoke.check_small_speculation()


def test_upload_with_vad_on_the_card_equals_the_serial_upload(card):
    """``upload_with_vad`` over ``docker/jfk.flac`` tiled to 150 s (three
    slices): the PCM equal to ``upload_audio``'s, the probabilities within
    the VAD's tolerance of the whole-buffer forward, equal speech
    timestamps."""
    jfk, speech = chip_smoke.tiled_speech(150.0)
    assert chip_smoke.check_pipelined_vad(speech, card) <= chip_smoke.VAD_PROB_TOL


def test_memory_report_on_the_card_returns_both_programs(card):
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    cfg, cpu, tok = chip_smoke.small_model_parts()
    for compute_type in ("bfloat16", "int8"):
        model = WhisperModel.from_parts(cpu, cfg, tok, compute_type=compute_type, device="cuda")
        rep = model.model.memory_report(batch_size=2, beam_size=2, max_new_tokens=8)
        assert list(rep) == ["weights_bytes", "encode", "decode"]
        for name in ("encode", "decode"):
            r = rep[name]
            assert list(r) == ["argument_bytes", "output_bytes", "temp_bytes", "code_bytes", "peak_bytes"]
            assert r["peak_bytes"] == r["argument_bytes"] + r["temp_bytes"]
            assert r["argument_bytes"] > rep["weights_bytes"] > 0 and r["temp_bytes"] >= r["output_bytes"] > 0
            assert r["code_bytes"] > 0


def test_mock_gate_on_the_card(card):
    from faster_whisper_tpu_torch import validate

    assert validate.main(["--mock"]) == 0
