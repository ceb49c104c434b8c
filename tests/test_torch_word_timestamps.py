"""``word_timestamps=True`` through the port's ``WhisperModel.transcribe``
and ``BatchedInferencePipeline.transcribe`` against the JAX package's, on
the float32 micro model and the synthetic vocabulary, at temperature 0 on
15-20 s clips.  Segments (ids, seeks, texts, tokens, start/end) and their
words (text, start, end) must be equal, each word's probability within
1e-5 (a mean of a few float32 softmax probabilities, whose sums run in
another order).  The cases: beam 5, ``hallucination_silence_threshold``,
``vad_filter=True`` on ``docker/jfk.flac`` (decoded by the JAX package)
tiled to 20 s, which maps the words back through the VAD,
``language="zh"`` (words split at unicode boundaries), int8 with the JAX
package's encoder states (the two int8 encoders differ by whole
activation-code steps, test_torch_transcribe.py), and the batched
pipeline.  The JAX side runs with FWT_CACHE_ARTIFACTS=/nonexistent."""

import os

import numpy as np
import pytest

import jax
import torch

from faster_whisper_tpu.audio import decode_audio as jax_decode_audio
from faster_whisper_tpu.models.config import tiny_test_config as jax_config
from faster_whisper_tpu.models.load import random_params as jax_random_params
from faster_whisper_tpu.testing import build_synthetic_tokenizer as jax_tokenizer
from faster_whisper_tpu.transcribe import BatchedInferencePipeline as JaxPipeline
from faster_whisper_tpu.transcribe import WhisperModel as JaxWhisperModel
from faster_whisper_tpu_torch import BatchedInferencePipeline, WhisperModel
from faster_whisper_tpu_torch.models.config import tiny_test_config
from faster_whisper_tpu_torch.models.load import params_from_jax
from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer

PROB_TOL = 1e-5
LOGPROB_TOL = 1e-4
JFK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docker", "jfk.flac")


def synth_audio(seconds: float, seed: int) -> np.ndarray:
    """A tone that switches on and off over noise, 16 kHz float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    gate = np.sin(2 * np.pi * 0.5 * t) > 0
    x = 0.3 * np.sin(2 * np.pi * 220 * t) * gate + 0.05 * rng.standard_normal(t.size)
    return x.astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's many small CPU ops (see
    test_torch_transcribe.py)."""
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


def _models(weights, jax_type="float32", port_type="float32"):
    jm = JaxWhisperModel.from_parts(weights, jax_config(), jax_tokenizer(), compute_type=jax_type)
    pm = WhisperModel.from_parts(
        params_from_jax(jax.tree.map(np.asarray, weights), device="cpu"),
        tiny_test_config(), build_synthetic_tokenizer(), compute_type=port_type, device="cpu",
    )
    return jm, pm


@pytest.fixture(scope="module")
def models(weights):
    return _models(weights)


@pytest.fixture(scope="module")
def jfk():
    """docker/jfk.flac decoded by the JAX package (11 s)."""
    return jax_decode_audio(JFK, sampling_rate=16000)


@pytest.fixture(scope="module")
def speech(jfk):
    return np.tile(jfk, 2)[: 20 * 16000]


def assert_words_equal(segments, ref):
    assert len(segments) == len(ref) > 0
    n_words = 0
    for s, r in zip(segments, ref):
        assert (s.id, s.seek, s.text, s.tokens) == (r.id, r.seek, r.text, r.tokens)
        assert (s.start, s.end) == (r.start, r.end)
        assert s.avg_logprob == pytest.approx(r.avg_logprob, abs=LOGPROB_TOL)
        assert s.words is not None and len(s.words) == len(r.words), s.id
        for a, b in zip(s.words, r.words):
            assert (a.word, a.start, a.end) == (b.word, b.start, b.end), s.id
            assert a.probability == pytest.approx(b.probability, abs=PROB_TOL)
            assert 0.0 <= a.probability <= 1.0 and a.start <= a.end
        n_words += len(s.words)
    assert n_words > 0  # the case aligned some words


CASES = {
    "beam5": dict(audio=("synth", 15.0, 1)),
    "hallucination-silence": dict(audio=("synth", 15.0, 1), hallucination_silence_threshold=1.0),
    # the 1608 specials of the micro vocabulary are suppressed, so that
    # the speech decodes text that the VAD's chunks then carry
    "vad-filter": dict(audio=("speech",), vad_filter=True, suppress_tokens=[-1] + list(range(257, 1865))),
    "zh": dict(audio=("synth", 18.0, 5), language="zh"),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_word_timestamps_match_jax(models, speech, case):
    jm, pm = models
    kwargs = dict(CASES[case])
    source = kwargs.pop("audio")
    audio = speech if source[0] == "speech" else synth_audio(source[1], seed=source[2])
    kwargs = dict(dict(language="en"), **kwargs, beam_size=5, temperature=0.0, max_new_tokens=48,
                  word_timestamps=True)
    ref_segments, ref_info = jm.transcribe(audio, **kwargs)
    ref_segments = list(ref_segments)
    segments, info = pm.transcribe(audio, **kwargs)
    segments = list(segments)
    assert info.language == ref_info.language == kwargs["language"]
    assert info.duration_after_vad == ref_info.duration_after_vad
    assert_words_equal(segments, ref_segments)


def test_int8_word_timestamps_match_jax(weights, monkeypatch):
    """The JAX package's int8 model (float32 activations) against the
    port's ``int8_float32``, each window decoded and aligned from the
    same encoder states: the JAX package's, recorded at its encode and
    handed to the port's."""
    jm, pm = _models(weights, "int8", "int8_float32")
    audio = synth_audio(15.0, seed=4)
    kwargs = dict(language="en", beam_size=5, temperature=0.0, max_new_tokens=48, word_timestamps=True)

    states = []
    jax_encode = jm.encode

    def record(features):
        out = jax_encode(features)
        states.append(np.array(out))
        return out

    monkeypatch.setattr(jm, "encode", record)
    ref_segments = list(jm.transcribe(audio, **kwargs)[0])

    replay = iter(states)
    monkeypatch.setattr(pm, "encode", lambda features: torch.from_numpy(next(replay)))
    segments = list(pm.transcribe(audio, **kwargs)[0])
    assert next(replay, None) is None and len(states) >= 1
    assert_words_equal(segments, ref_segments)


def test_pipeline_word_timestamps_match_jax(models, jfk):
    """``BatchedInferencePipeline`` with words over ``docker/jfk.flac``
    tiled to 66 s: three VAD chunks in one batch of 3 (bucketed to 4, a
    dummy row that the alignment drops), each chunk's words mapped back
    through the VAD."""
    jm, pm = models
    kwargs = dict(language="en", beam_size=5, batch_size=3, max_new_tokens=48, word_timestamps=True,
                  suppress_tokens=[-1] + list(range(257, 1865)))
    audio = np.tile(jfk, 6)
    ref_segments = list(JaxPipeline(jm).transcribe(audio, **kwargs)[0])
    segments = list(BatchedInferencePipeline(pm).transcribe(audio, **kwargs)[0])
    assert len({s.seek for s in segments}) >= 3  # several chunks
    assert_words_equal(segments, ref_segments)
    for s in segments:
        if s.words:  # a segment with words spans them
            assert (s.start, s.end) == (s.words[0].start, s.words[-1].end)
