"""``WhisperEngine.memory_report`` and ``utils.phase_timer`` of the port
on the host, against the JAX package's.

``memory_report`` keeps the JAX keys; on the CPU it measures nothing (the
port measures by running the programs on the card, where
``tests/test_torch_cuda.py`` holds it) and returns None for both
programs, and its ``weights_bytes`` equals the JAX engine's for the same
float32 micro tree.  ``phase_timer`` prints the JAX package's line under
``FWT_PHASE_LOG=1`` and nothing without it, and the batched pipeline
stamps its phases under the JAX package's names."""

import os
import re

import numpy as np
import pytest

import jax
import torch

import faster_whisper_tpu.utils as jax_utils
from faster_whisper_tpu.models.config import tiny_test_config as jax_config
from faster_whisper_tpu.models.load import random_params as jax_random_params
from faster_whisper_tpu.testing import build_synthetic_tokenizer as jax_tokenizer
from faster_whisper_tpu.transcribe import WhisperModel as JaxWhisperModel
from faster_whisper_tpu_torch import utils as port_utils
from faster_whisper_tpu_torch.audio import decode_audio
from faster_whisper_tpu_torch.models.config import tiny_test_config
from faster_whisper_tpu_torch.models.load import params_from_jax
from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer
from faster_whisper_tpu_torch.transcribe import BatchedInferencePipeline, WhisperModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = re.compile(r"^# phase (.+): \d+\.\d\ds \(at \+\d+\.\ds\)$")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's many small CPU ops: under the
    suite's parallel workers, more threads wait at every op's barrier for
    cores that the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return jax_random_params(jax_config(), seed=0, dtype="float32")


def _port_model(weights):
    return WhisperModel.from_parts(
        params_from_jax(jax.tree.map(np.asarray, weights), device="cpu"),
        tiny_test_config(),
        build_synthetic_tokenizer(),
        compute_type="float32",
        device="cpu",
    )


def test_memory_report_on_the_host(weights, monkeypatch):
    monkeypatch.setenv("FWT_CACHE_ARTIFACTS", "/nonexistent")
    kwargs = dict(batch_size=2, beam_size=2, max_new_tokens=8)
    ref = JaxWhisperModel.from_parts(weights, jax_config(), jax_tokenizer()).model.memory_report(**kwargs)
    ours = _port_model(weights).model.memory_report(**kwargs)
    assert list(ours) == list(ref) == ["weights_bytes", "encode", "decode"]
    assert ours["weights_bytes"] == ref["weights_bytes"] > 0
    assert ours["encode"] is None and ours["decode"] is None


def _stamp(module, name, capsys):
    with module.phase_timer(name):
        pass
    return capsys.readouterr().err


def test_phase_timer_prints_the_jax_line_only_when_asked(monkeypatch, capsys):
    monkeypatch.delenv("FWT_PHASE_LOG", raising=False)
    assert _stamp(port_utils, "quiet", capsys) == ""
    monkeypatch.setenv("FWT_PHASE_LOG", "0")
    assert _stamp(port_utils, "quiet", capsys) == ""
    monkeypatch.setenv("FWT_PHASE_LOG", "1")
    ours, ref = _stamp(port_utils, "vad", capsys), _stamp(jax_utils, "vad", capsys)
    assert LINE.match(ours.rstrip("\n")) and LINE.match(ref.rstrip("\n"))
    assert ours.endswith("\n") and ours.count("\n") == 1
    assert LINE.match(ours.rstrip("\n")).group(1) == "vad"


def _jax_phase_names():
    names = set()
    for path in ("transcribe.py", "vad.py"):
        with open(os.path.join(ROOT, "faster_whisper_tpu", path)) as f:
            names |= set(re.findall(r'phase_timer\("([^"]+)"\)', f.read()))
    return names


@pytest.mark.parametrize(
    "pipelined, upload",
    [("0", "pcm upload"), ("1", "pcm upload + vad dispatch (pipelined)")],
)
def test_pipeline_stamps_the_jax_phases(weights, monkeypatch, capsys, pipelined, upload):
    monkeypatch.setenv("FWT_PHASE_LOG", "1")
    monkeypatch.setenv("FWT_PIPELINED_VAD", pipelined)
    audio = decode_audio(os.path.join(ROOT, "docker", "jfk.flac"))
    capsys.readouterr()
    segments, _ = BatchedInferencePipeline(_port_model(weights)).transcribe(
        audio, language="en", max_new_tokens=4
    )
    list(segments)
    lines = capsys.readouterr().err.splitlines()
    names = [LINE.match(line).group(1) for line in lines if line.startswith("# phase ")]
    assert all(LINE.match(line) for line in lines if line.startswith("# phase "))
    want = [upload, "vad (compile+forward+state machine)", "assemble speech concat",
            "chunked mel features", "encode dispatch", "decode dispatch", "decode collect"]
    if pipelined == "0":
        want.insert(1, "vad forward (compile+exec+probs pull)")
    assert names == want
    assert set(names) <= _jax_phase_names()
