"""The JAX package's policy knobs (default "1", off only on "0"), each
set in both packages.

Two change outputs, and the port reads them where and as the JAX package
reads them:

- ``FWT_I16_TRANSFER=0``: the PCM crosses to the device in float32, and the
  VAD does not round it to the int16 grid;
- ``FWT_SHARED_UPLOAD=0``: the pipeline's VAD reads the host audio and its
  features a float32 speech concat uploaded on its own.

Three only choose between paths that give the same outputs, and the port
has one path for each: the native VAD state machine
(``FWT_NATIVE_VAD_SM``), two pipeline batches in flight
(``FWT_PIPELINE_LOOKAHEAD``) and the fallback ladder's sampling rungs as
one batched call (``FWT_BATCHED_LADDER``).  At either value of those the
JAX package gives what the port gives.

For each knob at "0" and at "1" the port gives the JAX package's speech
chunks and pipeline segments on ``docker/jfk.flac`` tiled to 33 s and
scaled off the int16 grid.  The ladder's decisions are held as the JAX
package's ``tests/test_batched_ladder.py`` holds them, over a scripted
engine, and the shared upload as its ``tests/test_chunked_mel.py`` does,
on int16-grid audio.  The JAX side runs with
FWT_CACHE_ARTIFACTS=/nonexistent."""

import logging
import os

import numpy as np
import pytest

import jax
import torch

from faster_whisper_tpu import vad as jvad
from faster_whisper_tpu.audio import decode_audio as jax_decode_audio
from faster_whisper_tpu.models.config import tiny_test_config as jax_config
from faster_whisper_tpu.models.load import random_params as jax_random_params
from faster_whisper_tpu.ops import mel as jmel
from faster_whisper_tpu.testing import build_synthetic_tokenizer as jax_tokenizer
from faster_whisper_tpu.transcribe import BatchedInferencePipeline as JaxPipeline
from faster_whisper_tpu.transcribe import TranscriptionOptions as JaxOptions
from faster_whisper_tpu.transcribe import WhisperModel as JaxWhisperModel
from faster_whisper_tpu_torch import transcribe as ptranscribe
from faster_whisper_tpu_torch import vad as pvad
from faster_whisper_tpu_torch.models.config import tiny_test_config
from faster_whisper_tpu_torch.models.load import params_from_jax
from faster_whisper_tpu_torch.ops import mel as pmel
from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer
from faster_whisper_tpu_torch.transcribe import BatchedInferencePipeline, WhisperModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JFK = os.path.join(ROOT, "docker", "jfk.flac")
LOGPROB_TOL = 1e-4
# read by the port; read by the JAX package alone (their outputs are one)
PORTED_KNOBS = ["FWT_I16_TRANSFER", "FWT_SHARED_UPLOAD"]
JAX_ONLY_KNOBS = ["FWT_NATIVE_VAD_SM", "FWT_PIPELINE_LOOKAHEAD", "FWT_BATCHED_LADDER"]
# the pipeline's own VAD options (transcribe.py: 30 s chunks)
PIPELINE_VAD = dict(max_speech_duration_s=30, min_silence_duration_ms=160)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's many small CPU ops: under the
    suite's parallel workers, more threads wait at every op's barrier for
    cores that the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_shipped_compile_cache(monkeypatch):
    monkeypatch.setenv("FWT_CACHE_ARTIFACTS", "/nonexistent")


@pytest.fixture(scope="module")
def weights():
    return jax_random_params(jax_config(), seed=0, dtype="float32")


@pytest.fixture(scope="module")
def speech():
    """jfk.flac tiled to 33 s and scaled off the int16 grid."""
    return (np.tile(jax_decode_audio(JFK, sampling_rate=16000), 3) * 0.77).astype(np.float32)


@pytest.fixture
def models(weights):
    jm = JaxWhisperModel.from_parts(weights, jax_config(), jax_tokenizer())
    pm = WhisperModel.from_parts(
        params_from_jax(jax.tree.map(np.asarray, weights), device="cpu"),
        tiny_test_config(), build_synthetic_tokenizer(), compute_type="float32", device="cpu",
    )
    return jm, pm


def assert_segments_equal(segments, ref):
    assert len(segments) == len(ref) > 0
    for s, r in zip(segments, ref):
        assert (s.id, s.seek, s.text, s.tokens) == (r.id, r.seek, r.text, r.tokens)
        assert (s.start, s.end) == (r.start, r.end)
        assert s.avg_logprob == pytest.approx(r.avg_logprob, abs=LOGPROB_TOL)
        assert s.no_speech_prob == pytest.approx(r.no_speech_prob, abs=1e-5)


@pytest.mark.parametrize("value", ["0", "1"])
@pytest.mark.parametrize("knob", PORTED_KNOBS + JAX_ONLY_KNOBS)
def test_knob_gives_the_jax_packages_chunks_and_segments(models, speech, knob, value, monkeypatch):
    monkeypatch.setenv(knob, value)
    jm, pm = models

    # what the port runs under the knob, seen through spies
    calls = []

    def spy(name, owner, attr):
        inner = getattr(owner, attr)

        def wrapper(*args, **kwargs):
            calls.append(name)
            return inner(*args, **kwargs)

        monkeypatch.setattr(owner, attr, wrapper)

    spy("python state machine", pvad, "_hysteresis_py")
    spy("native state machine", pvad, "hysteresis_native")
    spy("shared upload", ptranscribe, "upload_audio")
    pipeline = BatchedInferencePipeline(pm)
    spy("dispatch", pipeline, "_dispatch_segment_batch")
    spy("collect", pipeline, "_forward_collect")

    ref_chunks = jvad.get_speech_timestamps(speech, jvad.VadOptions(**PIPELINE_VAD))
    chunks = pvad.get_speech_timestamps(speech, pvad.VadOptions(**PIPELINE_VAD), device="cpu")
    assert chunks == ref_chunks and len(chunks) >= 2

    kwargs = dict(language="en", beam_size=2, batch_size=1, max_new_tokens=16)
    ref_segments, ref_info = JaxPipeline(jm).transcribe(speech, **kwargs)
    ref_segments = list(ref_segments)
    segments, info = pipeline.transcribe(speech, **kwargs)
    segments = list(segments)
    assert info.duration_after_vad == ref_info.duration_after_vad
    assert_segments_equal(segments, ref_segments)

    # the port's one path under any knob: the native state machine (the
    # call above and the pipeline's), the second batch dispatched before
    # the first is collected
    assert calls.count("native state machine") == 2 and "python state machine" not in calls
    order = "".join(c[0] for c in calls if c in ("dispatch", "collect"))
    assert order.count("d") == order.count("c") >= 2 and order.startswith("dd")
    if knob == "FWT_SHARED_UPLOAD":
        assert calls.count("shared upload") == (1 if value == "1" else 0)
    if knob == "FWT_I16_TRANSFER":
        x = speech[: 16000 * 3] * 1.7  # past full scale: the int16 clip takes part
        ours = pmel.upload_audio(x, "cpu")
        np.testing.assert_array_equal(ours.numpy(), np.asarray(jmel.upload_audio(x))[: len(x)])
        assert np.array_equal(ours.numpy(), x) == (value == "0")
        # the VAD forward rounds its input to the int16 grid only under "1"
        from faster_whisper_tpu.models.silero import SileroVAD as JaxSileroVAD

        x = speech[: len(speech) // 512 * 512]
        probs = pvad.get_vad_model("cpu")(x).numpy()
        np.testing.assert_allclose(probs, JaxSileroVAD()(x), atol=2e-5, rtol=0)
        on_grid = pvad.get_vad_model("cpu")(np.round(x * 32768.0) / 32768.0).numpy()
        assert np.array_equal(probs, on_grid) == (value == "1")


@pytest.mark.parametrize("value", ["0", "1"])
def test_upload_with_vad_under_the_transfer_knob(speech, monkeypatch, value):
    """The pipelined upload's PCM equals ``upload_audio``'s (the float32
    samples themselves under "0"), and its probabilities the whole-buffer
    forward's, bit for bit, and the JAX package's pipelined forward's."""
    from faster_whisper_tpu_torch.models.silero import VAD_SLICE_SAMPLES

    monkeypatch.setenv("FWT_I16_TRANSFER", value)
    audio = np.tile(speech, 3)[: int(1.3 * VAD_SLICE_SAMPLES)]
    expected = len(audio) // 512 + 1
    ref = pvad.get_vad_model("cpu")(np.pad(audio, (0, expected * 512 - len(audio)))).numpy()
    audio_dev, probs = pvad.upload_with_vad(audio, device="cpu")
    np.testing.assert_array_equal(probs[:expected], ref)
    assert torch.equal(audio_dev, pmel.upload_audio(audio, "cpu"))
    assert np.array_equal(audio_dev.numpy(), audio) == (value == "0")
    _, jax_probs = jvad.upload_with_vad(audio, return_audio=False)
    np.testing.assert_allclose(probs[:expected], np.asarray(jax_probs)[:expected], atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# FWT_BATCHED_LADDER: the decisions over a scripted engine (the counterpart
# of the JAX package's tests/test_batched_ladder.py)
# ---------------------------------------------------------------------------


class _Result:
    def __init__(self, seq, score, nsp):
        self.sequences_ids = [list(seq)]
        self.scores = [score]
        self.no_speech_prob = nsp


class _ScriptedEngine:
    """Rung results keyed by temperature, for the serial calls (B=1) and
    the batched tail (B=n, a temperature per row); records each call's
    temperatures.  The JAX package dispatches and collects, the port
    calls ``generate``."""

    def __init__(self, by_temp):
        self.by_temp = by_temp
        self.dispatches = []

    def generate_dispatch(self, enc, prompts, **kw):
        t = kw["sampling_temperature"] if kw.get("beam_size") == 1 else 0.0
        temps = list(t) if isinstance(t, (list, tuple)) else [float(t)]
        assert len(temps) == len(prompts) == enc.shape[0]
        self.dispatches.append(temps)
        return temps

    def generate_collect(self, temps):
        return [_Result(*self.by_temp[t]) for t in temps]

    def generate(self, enc, prompts, **kw):
        return self.generate_collect(self.generate_dispatch(enc, prompts, **kw))


def _scripted(cls, script):
    m = object.__new__(cls)
    m.model = _ScriptedEngine(script)
    m.logger = logging.getLogger("batched-ladder")
    m.time_precision = 0.02
    m.max_length = 448
    return m


class _Tok:
    def decode(self, toks):
        return " ".join(str(t) for t in toks)


_DIVERSE = list(range(100, 130))
_REPEATED = [7, 7] * 40  # zlib-compressible: a compression ratio above 2.4
_TEMPS = [0.0, 0.2, 0.4, 0.6, 0.8, 1.0]


def _fallback_options(cls, **over):
    """The ladder's options, as the JAX package's ladder tests build them."""
    kw = dict(
        beam_size=5, best_of=5, patience=1.0, length_penalty=1.0,
        repetition_penalty=1.0, no_repeat_ngram_size=0,
        log_prob_threshold=-1.0, no_speech_threshold=0.6,
        compression_ratio_threshold=2.4,
        condition_on_previous_text=True, prompt_reset_on_temperature=0.5,
        temperatures=_TEMPS,
        initial_prompt=None, prefix=None, suppress_blank=True,
        suppress_tokens=[-1], without_timestamps=False,
        max_initial_timestamp=1.0, word_timestamps=False,
        prepend_punctuations="\"'([{-", append_punctuations="\"'.,!?:)]}",
        multilingual=False, max_new_tokens=None, clip_timestamps="0",
        hallucination_silence_threshold=None, hotwords=None,
    )
    kw.update(over)
    return cls(**kw)


def _scenarios():
    ok = (_DIVERSE, -0.2, 0.1)
    cr_fail = (_REPEATED, -0.3, 0.1)

    def lp_fail(i):
        return (list(_DIVERSE), -2.0 - 0.1 * i, 0.1)

    for k in range(len(_TEMPS)):
        yield {t: (ok if i == k else lp_fail(i)) for i, t in enumerate(_TEMPS)}, f"accept-at-{k}"
    yield {t: lp_fail(i) for i, t in enumerate(_TEMPS)}, "all-fail"
    yield {t: (cr_fail if i < 2 else lp_fail(i)) for i, t in enumerate(_TEMPS)}, "cr-then-lp-all-fail"


@pytest.mark.parametrize("value", ["0", "1"])
def test_ladder_decisions_and_calls_match_jax(monkeypatch, value):
    """The port's ladder (the beam rung, then the sampling tail as one
    batched call) takes the JAX package's decisions under its serial
    rungs ("0") and its batched tail ("1")."""
    monkeypatch.setenv("FWT_BATCHED_LADDER", value)
    opts = _fallback_options(ptranscribe.TranscriptionOptions)
    jopts = _fallback_options(JaxOptions)
    for script, name in _scenarios():
        jm, pm = _scripted(JaxWhisperModel, script), _scripted(WhisperModel, script)
        ref = jm.generate_with_fallback(np.zeros((1, 4, 8), np.float32), [1, 2, 3], _Tok(), jopts)
        ours = pm.generate_with_fallback(torch.zeros((1, 4, 8)), [1, 2, 3], _Tok(), opts)
        assert ours[0].sequences_ids == ref[0].sequences_ids, name
        assert ours[1] == pytest.approx(ref[1]), name
        assert ours[2] == ref[2], name  # the temperature reported
        assert ours[3] == pytest.approx(ref[3]), name
        calls, ref_calls = pm.model.dispatches, jm.model.dispatches
        accepted = _TEMPS.index(ours[2]) if name.startswith("accept") else len(_TEMPS) - 1
        # the beam rung, then at most one call for the whole tail
        assert calls == [[0.0]] + ([_TEMPS[1:]] if accepted else []), name
        if value == "0":  # one call per rung tried
            assert ref_calls == [[t] for t in _TEMPS[: accepted + 1]], name
        else:
            assert ref_calls == calls, name


@pytest.mark.parametrize("rungs", ["all-fail", "first-accepted"])
def test_transcribe_runs_the_sampling_tail_as_one_call(models, monkeypatch, rungs):
    """Through ``transcribe``: a window whose every rung fails costs one
    beam and one batched sampling call, one whose beam rung passes only
    the beam call."""
    _, pm = models
    calls = []
    generate = pm.model.generate

    def spy(enc, prompts, **kw):
        calls.append((len(prompts), kw.get("sampling_temperature")))
        return generate(enc, prompts, **kw)

    monkeypatch.setattr(pm.model, "generate", spy)
    audio = (np.random.default_rng(0).standard_normal(16000 * 4) * 0.1).astype(np.float32)
    thresholds = (
        dict(log_prob_threshold=100.0)  # every rung fails
        if rungs == "all-fail"
        else dict(log_prob_threshold=None, compression_ratio_threshold=None)
    )
    segments, _ = pm.transcribe(
        audio, language="en", beam_size=2, best_of=2, temperature=_TEMPS, vad_filter=False,
        max_new_tokens=8, condition_on_previous_text=False, **thresholds,
    )
    assert list(segments)
    assert calls == [(1, None)] + ([(5, _TEMPS[1:])] if rungs == "all-fail" else [])


# ---------------------------------------------------------------------------
# FWT_SHARED_UPLOAD on int16-grid audio (the counterpart of the JAX
# package's tests/test_chunked_mel.py::test_shared_upload_pipeline_matches_separate)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transfer", ["0", "1"])
def test_shared_upload_matches_separate_on_grid_audio(models, monkeypatch, transfer):
    monkeypatch.setenv("FWT_I16_TRANSFER", transfer)
    jm, pm = models
    rng = np.random.default_rng(5)
    audio = (rng.integers(-15000, 15000, 16000 * 8) / 32768.0).astype(np.float32)
    clips = [{"start": 0.5, "end": 3.0}, {"start": 4.0, "end": 7.5}]
    kwargs = dict(language="en", beam_size=2, clip_timestamps=clips, max_new_tokens=16)
    got = {}
    for shared in ("0", "1"):
        monkeypatch.setenv("FWT_SHARED_UPLOAD", shared)
        ref = list(JaxPipeline(jm).transcribe(audio, **kwargs)[0])
        got[shared] = list(BatchedInferencePipeline(pm).transcribe(audio, **kwargs)[0])
        assert_segments_equal(got[shared], ref)
    assert [s.tokens for s in got["0"]] == [s.tokens for s in got["1"]]
