"""The sequential path's speculative next-window encode, in the port
against the JAX package's.

While a window decodes, the window that follows a full-window advance is
encoded ahead (``generate_segments``, ``generate_with_fallback(
after_dispatch=)``); the next window takes it only when its seek is the
one predicted.  The output must not change: the port's segments with
speculation off (``FWT_SPEC_ENCODE=0``) and on are equal, and equal to
the JAX package's with speculation on, on ``docker/jfk.flac`` tiled to
40 s, beam 2, 24 new tokens, the float32 micro model on the JAX package's
weights (the counterpart of JAX ``tests/test_transcribe.py::
test_speculative_encode_parity``), where the first window ends on a
timestamp short of its end, so its speculation misses; and the same
request over 100 s, where a window ends on a single timestamp, so that the
next one starts where predicted: a hit.  The speculative encodes and the
hits are counted.  Both packages get the same array,
decoded once by the port's ``decode_audio``.  Text, tokens, start, end
and seek must be equal and ``avg_logprob`` within 1e-4 (float32 sums of
log-probabilities over a few dozen tokens, taken in another order).

``after_dispatch`` runs exactly once per window, inside the ladder's first
decode call, whether that call is the serial beam rung or the batched
sampling tail; with ``log_prob_threshold=0.0`` every rung falls back, so
the ladder runs all of its rungs.  Sampling cannot match the JAX
package's RNG, so those runs count the calls only."""

import os

import numpy as np
import pytest

import jax
import torch

from faster_whisper_tpu.models.config import tiny_test_config as jax_config
from faster_whisper_tpu.models.load import random_params as jax_random_params
from faster_whisper_tpu.testing import build_synthetic_tokenizer as jax_tokenizer
from faster_whisper_tpu.transcribe import WhisperModel as JaxWhisperModel
from faster_whisper_tpu_torch import transcribe as port_transcribe
from faster_whisper_tpu_torch.audio import decode_audio
from faster_whisper_tpu_torch.models.config import tiny_test_config
from faster_whisper_tpu_torch.models.load import params_from_jax
from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer
from faster_whisper_tpu_torch.transcribe import WhisperModel

LOGPROB_TOL = 1e-4
JFK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docker", "jfk.flac")
REQUEST = dict(language="en", beam_size=2, max_new_tokens=24)


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
def port_model(weights):
    return WhisperModel.from_parts(
        params_from_jax(jax.tree.map(np.asarray, weights), device="cpu"),
        tiny_test_config(),
        build_synthetic_tokenizer(),
        compute_type="float32",
        device="cpu",
    )


@pytest.fixture(scope="module")
def jfk():
    return decode_audio(JFK, sampling_rate=16000)


def _tiled(base, seconds):
    return np.tile(base, -(-seconds * 16000 // len(base)))[: seconds * 16000]


@pytest.fixture(scope="module")
def audio(jfk):
    return _tiled(jfk, 40)


def _rows(segments):
    return [(s.text, s.tokens, s.start, s.end, s.seek) for s in segments]


def _transcribe(model, audio, **kwargs):
    segments, _ = model.transcribe(audio, **REQUEST, **kwargs)
    return list(segments)


@pytest.mark.parametrize(
    "seconds, hit",
    [
        # the JAX package's request: the first window ends on a timestamp
        # short of its end, so the one speculation misses and is thrown away
        (40, False),
        # the third window's decode ends on a single timestamp, so the
        # fourth window starts where predicted: a hit
        (100, True),
    ],
    ids=["40s-miss", "100s-hit"],
)
def test_speculation_changes_no_segment_and_equals_jax(
    port_model, weights, jfk, monkeypatch, seconds, hit
):
    audio = _tiled(jfk, seconds)
    made, taken = [], []

    def counted(fn, log):
        def wrapped(self, *args):
            log.append(self)
            return fn(self, *args)

        return wrapped

    side = port_transcribe._SideEncode
    monkeypatch.setattr(side, "__init__", counted(side.__init__, made))
    monkeypatch.setattr(side, "result", counted(side.result, taken))
    monkeypatch.setenv("FWT_SPEC_ENCODE", "0")
    off = _transcribe(port_model, audio, temperature=[0.0])
    assert made == [] and taken == []
    monkeypatch.setenv("FWT_SPEC_ENCODE", "1")
    on = _transcribe(port_model, audio, temperature=[0.0])

    assert len(on) > 1
    assert len(made) >= 1
    assert (len(taken) >= 1) if hit else (taken == [])
    assert _rows(on) == _rows(off)
    assert [s.avg_logprob for s in on] == [s.avg_logprob for s in off]

    jm = JaxWhisperModel.from_parts(weights, jax_config(), jax_tokenizer())
    segments, _ = jm.transcribe(audio, **REQUEST, temperature=[0.0])
    ref = list(segments)
    assert _rows(on) == _rows(ref)
    np.testing.assert_allclose(
        [s.avg_logprob for s in on], [s.avg_logprob for s in ref], atol=LOGPROB_TOL, rtol=0
    )


@pytest.mark.parametrize(
    "temperature, first_call",
    [
        ([0.0, 0.2, 0.4], "serial beam rung"),
        ([0.2, 0.4], "batched sampling tail"),
    ],
)
def test_after_dispatch_runs_once_inside_the_first_decode(
    port_model, audio, monkeypatch, temperature, first_call
):
    """Per window: one call of ``after_dispatch``, while the ladder's first
    decode call runs, that call being the serial beam rung or the batched
    sampling tail; the ladder goes on to its later rungs without it."""
    decodes, fired, windows = [], [], []
    running = []
    generate = port_model.model.generate

    def traced_generate(encoder_output, prompts, **kwargs):
        form = (
            "batched sampling tail"
            if isinstance(kwargs.get("sampling_temperature"), list)
            else "serial beam rung" if kwargs.get("beam_size", 1) > 1 else "serial sampling rung"
        )
        decodes[-1].append(form)
        running.append(form)
        try:
            return generate(encoder_output, prompts, **kwargs)
        finally:
            running.pop()

    fallback = port_model.generate_with_fallback

    def traced_fallback(*args, after_dispatch=None, **kwargs):
        decodes.append([])
        windows.append(after_dispatch is not None)
        assert after_dispatch is not None

        def hook():
            fired.append((len(decodes) - 1, len(decodes[-1]), tuple(running)))
            after_dispatch()

        return fallback(*args, after_dispatch=hook, **kwargs)

    monkeypatch.setattr(port_model.model, "generate", traced_generate)
    monkeypatch.setattr(port_model, "generate_with_fallback", traced_fallback)
    monkeypatch.setenv("FWT_SPEC_ENCODE", "1")
    segments = _transcribe(port_model, audio, temperature=temperature, log_prob_threshold=0.0)

    assert segments and len(windows) > 1
    # every rung fell back, so each window ran the whole ladder
    assert all(len(calls) == (2 if len(temperature) == 3 else 1) for calls in decodes)
    assert decodes[0][0] == first_call
    # once per window, while its first decode call ran
    assert fired == [(w, 1, (first_call,)) for w in range(len(decodes))]
