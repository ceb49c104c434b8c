"""``WhisperModel.transcribe`` of the port against the JAX package's on a
45 s clip synthesized with numpy from a seed, over the same float32 micro
model and the same synthetic vocabulary, at float32 and at int8 (the
port's ``int8_float32`` on the CPU against the JAX package's ``int8`` on
float32 weights: both quantize the weights and the KV caches to int8 and
keep float32 activations).  Text, tokens and start/end must
be equal and ``avg_logprob`` within 1e-4 (float32 sums of log-probs over a
few dozen tokens, taken in another order).  ``vad_filter=True`` runs on
``docker/jfk.flac`` tiled to 33 s, each package with its own Silero VAD.
The JAX side runs with FWT_CACHE_ARTIFACTS=/nonexistent, so no shipped
compile-cache entry takes part."""

import io
import os
import re

import numpy as np
import pytest

import jax
import torch

from faster_whisper_tpu.audio import decode_audio as jax_decode_audio
from faster_whisper_tpu.models.config import tiny_test_config as jax_config
from faster_whisper_tpu.models.load import random_params as jax_random_params
from faster_whisper_tpu.testing import build_synthetic_tokenizer as jax_tokenizer
from faster_whisper_tpu.transcribe import WhisperModel as JaxWhisperModel
from faster_whisper_tpu_torch.models.config import tiny_test_config
from faster_whisper_tpu_torch.models.load import params_from_jax
from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer
from faster_whisper_tpu_torch.transcribe import WhisperModel

LOGPROB_TOL = 1e-4
JFK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docker", "jfk.flac")

OPTION_SETS = {
    "initial-prompt": dict(initial_prompt="hello world"),
    "prefix": dict(prefix="abc"),
    "hotwords": dict(hotwords="xyz"),
    "no-conditioning": dict(condition_on_previous_text=False),
    "patience": dict(patience=2.0),
    "length-penalty": dict(length_penalty=0.5),
    "clip-timestamps": dict(clip_timestamps="5,20,25"),
    "repetition-penalty": dict(repetition_penalty=1.5),
    "no-repeat-ngram": dict(no_repeat_ngram_size=2),
    "translate": dict(task="translate"),
    "multilingual": dict(multilingual=True, language=None),
    "detection-segments": dict(language_detection_segments=3, language=None),
}


def synth_audio(seconds: float, seed: int) -> np.ndarray:
    """A tone that switches on and off over noise, 16 kHz float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    gate = np.sin(2 * np.pi * 0.5 * t) > 0
    x = 0.3 * np.sin(2 * np.pi * 220 * t) * gate + 0.05 * rng.standard_normal(t.size)
    return x.astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's many small CPU ops: under the
    suite's parallel workers, more threads wait at every op's barrier for
    cores that the other workers hold (a VAD call took 35 s so, 0.3 s on
    one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return jax_random_params(jax_config(), seed=0, dtype="float32")


@pytest.fixture
def models(weights, monkeypatch):
    monkeypatch.setenv("FWT_CACHE_ARTIFACTS", "/nonexistent")
    jm = JaxWhisperModel.from_parts(weights, jax_config(), jax_tokenizer())
    pm = WhisperModel.from_parts(
        params_from_jax(jax.tree.map(np.asarray, weights), device="cpu"),
        tiny_test_config(),
        build_synthetic_tokenizer(),
        compute_type="float32",
        device="cpu",
    )
    return jm, pm


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(beam_size=5),  # language detection, timestamps
        # In the micro vocabulary 1608 of 1865 tokens are specials (ids
        # 257..1864: sot, languages, tasks, timestamps), and without the
        # timestamp rules nothing keeps a random model off them; they are
        # suppressed here so that the windows decode text.
        dict(
            beam_size=5, language="en", without_timestamps=True,
            suppress_tokens=[-1] + list(range(257, 1865)),
        ),
        dict(beam_size=1, language="en"),
        # the options of the seek loop, the prompt and the decode policy,
        # each beside beam 5 in English
        *({"beam_size": 5, "language": "en", **opts} for opts in OPTION_SETS.values()),
    ],
    ids=["beam5-detect", "beam5-no-timestamps", "greedy", *OPTION_SETS],
)
def test_transcribe_segments_match_jax(models, kwargs):
    jm, pm = models
    audio = synth_audio(45.0, seed=1)
    kwargs = dict(kwargs, temperature=0.0, max_new_tokens=48)
    ref_segments, ref_info = jm.transcribe(audio, **kwargs)
    ref_segments = list(ref_segments)
    segments, info = pm.transcribe(audio, **kwargs)
    segments = list(segments)

    assert info.language == ref_info.language
    assert info.language_probability == pytest.approx(ref_info.language_probability, abs=1e-5)
    assert len(segments) == len(ref_segments) > 0
    # the seek loop crossed into the second window
    assert max(s.seek for s in segments) > 0
    for s, r in zip(segments, ref_segments):
        assert (s.id, s.seek, s.text, s.tokens) == (r.id, r.seek, r.text, r.tokens)
        assert (s.start, s.end) == (r.start, r.end)
        assert s.avg_logprob == pytest.approx(r.avg_logprob, abs=LOGPROB_TOL)
        assert s.temperature == r.temperature
        assert s.compression_ratio == pytest.approx(r.compression_ratio)


def test_fallback_ladder_samples_and_yields_well_formed_segments(models):
    _, pm = models
    segments, info = pm.transcribe(synth_audio(20.0, seed=2), language="en", max_new_tokens=24)
    segments = list(segments)
    assert info.duration == pytest.approx(20.0)
    assert [s.id for s in segments] == list(range(1, len(segments) + 1))
    for s in segments:
        assert s.tokens and 0.0 <= s.start <= s.end
        assert s.temperature in (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


@pytest.mark.parametrize(
    "option,item",
    [("int4", 11), ("checkpoint", 10)],
)
def test_options_outside_the_slice_raise(weights, option, item, tmp_path, monkeypatch):
    """Items 11 and 10 are ported: ``compute_type="int4"`` builds and
    transcribes, and bytes that no backend decodes raise the JAX package's
    ``RuntimeError`` (here the libav shim cannot decode them and there is
    no ffmpeg CLI), not a refusal naming the item.  A model name that is
    not in the local Hugging Face cache raises that the port downloads
    nothing."""
    pm = WhisperModel.from_parts(
        params_from_jax(jax.tree.map(np.asarray, weights), device="cpu"),
        tiny_test_config(), build_synthetic_tokenizer(), compute_type="float32", device="cpu",
    )
    if option == "int4":
        m4 = WhisperModel.from_parts(
            pm.model.params, tiny_test_config(), build_synthetic_tokenizer(),
            compute_type="int4", device="cpu",
        )
        assert m4.model.int4 and m4.model.params["decoder"]["token_embed"].dtype == torch.bfloat16
        segments, info = m4.transcribe(synth_audio(10.0, seed=3), language="en", max_new_tokens=8)
        assert all(0.0 <= s.start <= s.end for s in segments)
        assert info.duration == pytest.approx(10.0)
    else:  # bytes no backend decodes; a checkpoint not on this machine
        # no ffmpeg CLI in either package
        monkeypatch.setattr("faster_whisper_tpu.audio._have_ffmpeg", lambda: False)
        monkeypatch.setattr("faster_whisper_tpu_torch.audio._have_ffmpeg", lambda: False)
        data = b"ID3\x04" + bytes(60)
        with pytest.raises(RuntimeError) as ref:
            jax_decode_audio(io.BytesIO(data))
        with pytest.raises(RuntimeError, match=re.escape(str(ref.value))) as ours:
            pm.transcribe(io.BytesIO(data))
        assert "could not decode" in str(ours.value)
        assert f"item {item}" not in str(ours.value)
        monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
        with pytest.raises(FileNotFoundError, match="downloads nothing"):
            WhisperModel("large-v3", device="cpu")


@pytest.fixture(scope="module")
def speech():
    """docker/jfk.flac decoded by the JAX package, tiled to 33 s."""
    return np.tile(jax_decode_audio(JFK, sampling_rate=16000), 3)


@pytest.mark.parametrize(
    "vad_parameters",
    [None, dict(min_silence_duration_ms=160, speech_pad_ms=100)],
    ids=["default", "short-silences"],
)
def test_vad_filter_segments_match_jax(models, speech, vad_parameters):
    """``vad_filter=True`` on the sequential path: the speech of the
    Silero VAD (the port's on the CPU, the JAX package's), concatenated,
    transcribed, and its times mapped back to the original clock."""
    jm, pm = models
    kwargs = dict(
        beam_size=5, temperature=0.0, max_new_tokens=48, vad_filter=True,
        vad_parameters=vad_parameters, suppress_tokens=[-1] + list(range(257, 1865)),
    )
    ref_segments, ref_info = jm.transcribe(speech, **kwargs)
    ref_segments = list(ref_segments)
    segments, info = pm.transcribe(speech, **kwargs)
    segments = list(segments)

    assert info.duration_after_vad == ref_info.duration_after_vad <= info.duration
    if vad_parameters:  # silences between the sentences are cut
        assert info.duration_after_vad < info.duration - 1.0
    assert vars(info.vad_options) == vars(ref_info.vad_options)
    assert info.language == ref_info.language
    assert len(segments) == len(ref_segments) > 0
    for s, r in zip(segments, ref_segments):
        assert (s.id, s.seek, s.text, s.tokens) == (r.id, r.seek, r.text, r.tokens)
        assert (s.start, s.end) == (r.start, r.end)
        assert s.avg_logprob == pytest.approx(r.avg_logprob, abs=LOGPROB_TOL)
    # the language of the speech only, as the JAX package detects it
    ours = pm.detect_language(speech, vad_filter=True, vad_parameters=info.vad_options)
    ref = jm.detect_language(speech, vad_filter=True, vad_parameters=ref_info.vad_options)
    assert ours[0] == ref[0] and ours[1] == pytest.approx(ref[1], abs=1e-5)


@pytest.mark.parametrize("base_vocab", [256, 50257])
def test_pure_python_tokenizer_matches_tokenizers_library(base_vocab):
    ours, ref = build_synthetic_tokenizer(base_vocab=base_vocab), jax_tokenizer(base_vocab=base_vocab)
    assert ours.get_vocab_size() == ref.get_vocab_size()
    for tok in ["<|endoftext|>", "<|yue|>", "<|notimestamps|>", "<|30.00|>", "<unused300>", "Ġ", "x", "none"]:
        assert ours.token_to_id(tok) == ref.token_to_id(tok), tok
    for text in [" hello world", "héllo ♪♪ 「」", " -", "\n\t x"]:
        assert ours.encode(text).ids == ref.encode(text, add_special_tokens=False).ids
    rng = np.random.default_rng(base_vocab)
    for _ in range(100):
        ids = rng.integers(0, min(base_vocab + 20, 2000), rng.integers(1, 30)).tolist()
        assert ours.decode(ids) == ref.decode(ids), ids


@pytest.fixture
def int8_models(weights, monkeypatch):
    """The JAX package's int8 model on the float32 weights (float32
    activations) and the port's ``int8_float32`` on the CPU."""
    monkeypatch.setenv("FWT_CACHE_ARTIFACTS", "/nonexistent")
    jm = JaxWhisperModel.from_parts(weights, jax_config(), jax_tokenizer(), compute_type="int8")
    pm = WhisperModel.from_parts(
        params_from_jax(jax.tree.map(np.asarray, weights), device="cpu"),
        tiny_test_config(),
        build_synthetic_tokenizer(),
        compute_type="int8_float32",
        device="cpu",
    )
    return jm, pm


def test_int8_encoder_matches_jax_to_an_activation_code(int8_models):
    """The int8 encoders agree to 1% of the output scale.  Each int8 dense
    quantizes its input rows, so a float32 difference of one unit in the
    last place ahead of a rounding boundary (convolution and attention sum
    in other orders; the float32 encoders agree to ~1e-6) moves an
    activation code by one step of 1/127 of its row's scale."""
    jm, pm = int8_models
    feats = pm.feature_extractor(synth_audio(30.0, seed=4))[:, :3000]
    ref = np.asarray(jm.model.encode(feats))
    ours = pm.model.encode(feats).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-2 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize(
    "kwargs", [dict(beam_size=5), dict(beam_size=1, language="en")], ids=["beam5-detect", "greedy"],
)
def test_int8_transcribe_segments_match_jax(int8_models, monkeypatch, kwargs):
    """The seek loop, the prompts and the int8 decode against the JAX
    package's, each window decoded from the same encoder states: the port's
    decode of window i is handed the states the JAX package decoded window
    i from.  Its own int8 states differ from those by whole activation-code
    steps (the test above; the log-mel features of the two packages differ
    in the last float32 bits too), which a random model's near-flat logits
    turn into other tokens.  Language detection runs on the port's own
    states, held to 1e-3."""
    jm, pm = int8_models
    assert pm.model.kv_int8
    audio = synth_audio(45.0, seed=4)
    kwargs = dict(kwargs, temperature=0.0, max_new_tokens=48)

    states = []  # the JAX package's encoder states, one per decoded window
    jax_dispatch = jm.model.generate_dispatch

    def record(encoder_output, prompts, **kw):
        states.append(np.array(encoder_output))
        return jax_dispatch(encoder_output, prompts, **kw)

    monkeypatch.setattr(jm.model, "generate_dispatch", record)
    ref_segments, ref_info = jm.transcribe(audio, **kwargs)
    ref_segments = list(ref_segments)

    replay = iter(states)
    port_generate = pm.model.generate
    monkeypatch.setattr(
        pm.model, "generate",
        lambda encoder_output, prompts, **kw: port_generate(
            torch.from_numpy(next(replay)), prompts, **kw
        ),
    )
    segments, info = pm.transcribe(audio, **kwargs)
    segments = list(segments)

    assert info.language == ref_info.language
    assert info.language_probability == pytest.approx(ref_info.language_probability, abs=1e-3)
    assert next(replay, None) is None  # as many windows decoded as the JAX package
    assert len(segments) == len(ref_segments) > 0
    assert max(s.seek for s in segments) > 0
    for s, r in zip(segments, ref_segments):
        assert (s.id, s.seek, s.text, s.tokens) == (r.id, r.seek, r.text, r.tokens)
        assert (s.start, s.end) == (r.start, r.end)
        assert s.avg_logprob == pytest.approx(r.avg_logprob, abs=LOGPROB_TOL)
        assert s.temperature == r.temperature
