"""The port's CLI (``python -m faster_whisper_tpu_torch``) against the JAX
package's (``python -m faster_whisper_tpu``): the JAX ``tests/test_cli.py``
CLI cases, each run through both ``main()``s in-process with the same
float32 micro model patched in for ``WhisperModel``.

txt, srt, vtt and tsv output must be equal character for character (texts
and millisecond times); json output equal but for ``avg_logprob`` within
1e-4 and ``no_speech_prob`` within 1e-5.  The cases: each format on the
sequential path (``--no-vad``), ``--output-dir``, ``--no-vad`` on 35 s
(two windows), and the batched pipeline with the VAD on
``docker/jfk.flac``.  The JAX side runs with
FWT_CACHE_ARTIFACTS=/nonexistent."""

import io
import json
import os
import subprocess
import sys
import wave

import numpy as np
import pytest

import jax
import torch

from faster_whisper_tpu import __main__ as jax_cli
from faster_whisper_tpu.models.config import tiny_test_config as jax_config
from faster_whisper_tpu.models.load import random_params as jax_random_params
from faster_whisper_tpu.testing import build_synthetic_tokenizer as jax_tokenizer
from faster_whisper_tpu.transcribe import WhisperModel as JaxWhisperModel
from faster_whisper_tpu_torch import WhisperModel
from faster_whisper_tpu_torch import __main__ as cli
from faster_whisper_tpu_torch.models.config import tiny_test_config
from faster_whisper_tpu_torch.models.load import params_from_jax
from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JFK = os.path.join(ROOT, "docker", "jfk.flac")
LOGPROB_TOL = 1e-4
NO_SPEECH_TOL = 1e-5
# the JAX test's options: sequential, greedy, temperature 0
SEQUENTIAL = ("--language", "en", "--beam-size", "1", "--no-vad", "--batch-size", "2",
              "--temperature", "0")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's many small CPU ops (see
    test_torch_batched.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_shipped_compile_cache(monkeypatch):
    monkeypatch.setenv("FWT_CACHE_ARTIFACTS", "/nonexistent")


@pytest.fixture(scope="module")
def models():
    weights = jax_random_params(jax_config(), seed=0, dtype="float32")
    jm = JaxWhisperModel.from_parts(weights, jax_config(), jax_tokenizer())
    pm = WhisperModel.from_parts(
        params_from_jax(jax.tree.map(np.asarray, weights), device="cpu"),
        tiny_test_config(), build_synthetic_tokenizer(), compute_type="float32", device="cpu",
    )
    return jm, pm


def _write_wav(path, seconds, seed):
    rng = np.random.default_rng(seed)
    pcm = (rng.standard_normal(int(16000 * seconds)) * 3000).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return str(path)


@pytest.fixture(scope="module")
def wav_file(tmp_path_factory):
    return _write_wav(tmp_path_factory.mktemp("cli") / "a.wav", 2.0, 0)


def _run_both(monkeypatch, models, *argv):
    """stdout of the port's and of the JAX package's ``main(argv)``, each
    with its micro model patched in."""
    jm, pm = models
    out = []
    for module, package, model in ((cli, "faster_whisper_tpu_torch", pm), (jax_cli, "faster_whisper_tpu", jm)):
        monkeypatch.setattr(f"{package}.WhisperModel", lambda *a, _m=model, **k: _m)
        buf = io.StringIO()
        monkeypatch.setattr(sys, "stdout", buf)
        module.main(list(argv))
        monkeypatch.setattr(sys, "stdout", sys.__stdout__)
        out.append(buf.getvalue())
    return out


def assert_json_equal(ours, ref):
    a, b = json.loads(ours), json.loads(ref)
    assert len(a["segments"]) == len(b["segments"]) > 0
    for s, r in zip(a["segments"], b["segments"]):
        for k in ("avg_logprob", "no_speech_prob"):
            tol = LOGPROB_TOL if k == "avg_logprob" else NO_SPEECH_TOL
            assert s.pop(k) == pytest.approx(r.pop(k), abs=tol)
        assert s == r


@pytest.mark.parametrize("fmt", ["txt", "srt", "vtt", "json", "tsv"])
def test_cli_format_matches_jax(monkeypatch, models, wav_file, fmt):
    ours, ref = _run_both(monkeypatch, models, wav_file, *SEQUENTIAL, "--output-format", fmt)
    if fmt == "srt":
        assert "-->" in ours and ours.strip().split("\n")[0] == "1"
    elif fmt == "vtt":
        assert ours.startswith("WEBVTT")
    elif fmt == "tsv":
        assert ours.startswith("start\tend\ttext\n")
    if fmt == "json":
        for seg in json.loads(ours)["segments"]:
            assert seg["end"] >= seg["start"]
        assert_json_equal(ours, ref)
    else:
        assert ours == ref


def test_cli_help_runs():
    r = subprocess.run(
        [sys.executable, "-m", "faster_whisper_tpu_torch", "--help"],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""},
    )
    assert r.returncode == 0 and "transcribe" in r.stdout
    assert r.stdout.startswith("usage: faster_whisper_tpu_torch")


def test_cli_no_vad_long_audio(monkeypatch, models, tmp_path):
    """--no-vad routes 35 s (two windows) through the sequential path, not
    the batched pipeline's no-clips RuntimeError."""
    path = _write_wav(tmp_path / "long.wav", 35.0, 2)
    ours, ref = _run_both(monkeypatch, models, path, *SEQUENTIAL, "--output-format", "json")
    assert_json_equal(ours, ref)


def test_cli_output_dir(monkeypatch, models, wav_file, tmp_path):
    dirs = [tmp_path / "ours", tmp_path / "ref"]
    texts = []
    jm, pm = models
    for module, package, model, d in ((cli, "faster_whisper_tpu_torch", pm, dirs[0]),
                                      (jax_cli, "faster_whisper_tpu", jm, dirs[1])):
        monkeypatch.setattr(f"{package}.WhisperModel", lambda *a, _m=model, **k: _m)
        buf = io.StringIO()
        monkeypatch.setattr(sys, "stdout", buf)
        module.main([wav_file, "--language", "en", "--beam-size", "1", "--no-vad",
                     "--temperature", "0", "--output-format", "srt", "--output-dir", str(d)])
        monkeypatch.setattr(sys, "stdout", sys.__stdout__)
        files = list(d.glob("*.srt"))
        assert len(files) == 1 and files[0].name == "a.srt"
        assert buf.getvalue() == str(files[0]) + "\n"
        texts.append(files[0].read_text())
    assert "-->" in texts[0] and texts[0] == texts[1]


def test_cli_batched_pipeline_with_vad(monkeypatch, models):
    """Without --no-vad the batched pipeline runs on the VAD's chunks of
    ``docker/jfk.flac``."""
    ours, ref = _run_both(monkeypatch, models, JFK, "--language", "en", "--beam-size", "2",
                          "--batch-size", "2", "--output-format", "json")
    assert_json_equal(ours, ref)
    ours, ref = _run_both(monkeypatch, models, JFK, "--language", "en", "--beam-size", "2",
                          "--batch-size", "2", "--output-format", "srt")
    assert ours == ref
