"""The port's ``BatchedInferencePipeline`` and device log-mel against the
JAX package's, on the same float32 micro model and synthetic vocabulary.

The speech is ``docker/jfk.flac`` (decoded by the JAX ``decode_audio``)
tiled to 66 s: the pipeline's VAD cuts it into three chunks of at most
30 s.  Each case runs both pipelines on the same input: tokens, texts,
seeks and start/end must be equal, ``avg_logprob`` within 1e-4 (float32
sums of log-probs in another order).  The device log-mel is held to the
JAX ``chunked_log_mel`` within 1e-4 (float32 DFT sums over 400 samples in
another order, through log10; measured ~2e-5), the upload and the
speech concat exactly.  The JAX side runs with
FWT_CACHE_ARTIFACTS=/nonexistent."""

import os

import numpy as np
import pytest

import jax
import torch

from faster_whisper_tpu.audio import decode_audio as jax_decode_audio
from faster_whisper_tpu.feature_extractor import FeatureExtractor as JaxFeatureExtractor
from faster_whisper_tpu.models.config import tiny_test_config as jax_config
from faster_whisper_tpu.models.load import random_params as jax_random_params
from faster_whisper_tpu.ops import mel as jmel
from faster_whisper_tpu.testing import build_synthetic_tokenizer as jax_tokenizer
from faster_whisper_tpu.transcribe import BatchedInferencePipeline as JaxPipeline
from faster_whisper_tpu.transcribe import WhisperModel as JaxWhisperModel
from faster_whisper_tpu_torch import BatchedInferencePipeline, WhisperModel
from faster_whisper_tpu_torch.feature_extractor import FeatureExtractor
from faster_whisper_tpu_torch.models.config import tiny_test_config
from faster_whisper_tpu_torch.models.load import params_from_jax
from faster_whisper_tpu_torch.ops import mel as pmel
from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer
from faster_whisper_tpu_torch.tokenizer import Tokenizer
from faster_whisper_tpu_torch.transcribe import TranscriptionOptions

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JFK = os.path.join(ROOT, "docker", "jfk.flac")
LOGPROB_TOL = 1e-4
MEL_TOL = 1e-4
# 1608 of the micro vocabulary's 1865 tokens are specials; suppressing them
# makes a random model decode text instead of timestamps
SPECIALS = [-1] + list(range(257, 1865))
CLIPS = [
    {"start": 0.0, "end": 9.5},
    {"start": 10.0, "end": 21.0},
    {"start": 21.0, "end": 30.0},
    {"start": 33.0, "end": 40.5},
    {"start": 41.0, "end": 60.0},
]

CASES = {
    # three chunks: one batch, padded to the pow2 bucket of 4 rows
    "vad-beam5-batch3": dict(batch_size=3),
    # five clips: batches of 3 + 2 (the tail padded to the full batch's 3)
    # and of 2 + 2 + 1 (padded to 2)
    "clips-batch3": dict(batch_size=3, clip_timestamps=CLIPS, suppress_tokens=SPECIALS),
    "clips-batch2": dict(batch_size=2, clip_timestamps=CLIPS, suppress_tokens=SPECIALS),
    "multilingual-detect": dict(batch_size=3, multilingual=True, language=None),
    "timestamps-patience": dict(batch_size=3, without_timestamps=False, patience=2.0),
}


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


@pytest.fixture(autouse=True)
def _no_shipped_compile_cache(monkeypatch):
    monkeypatch.setenv("FWT_CACHE_ARTIFACTS", "/nonexistent")


@pytest.fixture(scope="module")
def weights():
    return jax_random_params(jax_config(), seed=0, dtype="float32")


@pytest.fixture(scope="module")
def speech():
    return np.tile(jax_decode_audio(JFK, sampling_rate=16000), 6)


def port_model(weights, compute_type="float32"):
    return WhisperModel.from_parts(
        params_from_jax(jax.tree.map(np.asarray, weights), device="cpu"),
        tiny_test_config(), build_synthetic_tokenizer(), compute_type=compute_type, device="cpu",
    )


def assert_segments_equal(segments, ref):
    assert len(segments) == len(ref) > 0
    for s, r in zip(segments, ref):
        assert (s.id, s.seek, s.text, s.tokens) == (r.id, r.seek, r.text, r.tokens)
        assert (s.start, s.end) == (r.start, r.end)
        assert s.avg_logprob == pytest.approx(r.avg_logprob, abs=LOGPROB_TOL)
        assert s.no_speech_prob == pytest.approx(r.no_speech_prob, abs=1e-5)
        assert s.compression_ratio == pytest.approx(r.compression_ratio)
        assert s.temperature == r.temperature


# ---------------------------------------------------------------------------
# device PCM and log-mel
# ---------------------------------------------------------------------------


def test_upload_audio_and_assemble_segments_match_jax(speech):
    x = speech[: 16000 * 20] * 1.7  # past full scale: the int16 clip takes part
    ours = pmel.upload_audio(x, "cpu")
    ref = np.asarray(jmel.upload_audio(x))
    assert ours.dtype == torch.float32 and ours.shape == (len(x),)
    np.testing.assert_array_equal(ours.numpy(), ref[: len(x)])
    spans = [(0, 1000), (5000, 5000), (16000, 120000), (100000, 320000), (319000, 320000)]
    got = pmel.assemble_segments(ours, spans)
    want = np.asarray(jmel.assemble_segments(jax.numpy.asarray(ref[: len(x)]), spans))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_chunk_features_match_jax(speech, n_mels):
    audio = speech[: 16000 * 62]
    # ragged, tiny, exactly a window, and longer than the window (cut to it)
    lengths = [16000 * 20 + 37, 16000 * 12 - 37, 20, 161, 16000 * 30, 16000 * 31]
    starts = [0, 16000 * 20 + 37, 16000 * 3, 5, 16000 * 32, 0]
    ref = np.asarray(JaxFeatureExtractor(feature_size=n_mels).chunk_features(audio, starts, lengths))
    ours = FeatureExtractor(feature_size=n_mels).chunk_features(
        torch.from_numpy(audio), starts, lengths
    )
    assert ours.shape == ref.shape == (6, n_mels, 3000) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, atol=MEL_TOL, rtol=0)
    # zeros past each chunk's own frames
    for i, n in enumerate(lengths):
        assert np.all(ours[i, :, max((min(n, 480000) + 160) // 160 - 1, 0):].numpy() == 0.0)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


@pytest.fixture
def models(weights):
    return JaxWhisperModel.from_parts(weights, jax_config(), jax_tokenizer()), port_model(weights)


@pytest.mark.parametrize("kwargs", list(CASES.values()), ids=list(CASES))
def test_pipeline_segments_match_jax(models, speech, kwargs):
    jm, pm = models
    kwargs = dict({"language": "en"}, **kwargs, beam_size=5, max_new_tokens=48)
    ref_segments, ref_info = JaxPipeline(jm).transcribe(speech, **kwargs)
    ref_segments = list(ref_segments)
    segments, info = BatchedInferencePipeline(pm).transcribe(speech, **kwargs)
    segments = list(segments)

    assert info.language == ref_info.language
    assert info.language_probability == pytest.approx(ref_info.language_probability, abs=1e-5)
    assert info.duration == ref_info.duration
    assert info.duration_after_vad == ref_info.duration_after_vad
    if ref_info.vad_options is None:
        assert info.vad_options is None
    else:
        assert vars(info.vad_options) == vars(ref_info.vad_options)
    assert_segments_equal(segments, ref_segments)
    assert len({s.seek for s in segments}) >= 3  # several chunks


def test_pipeline_defaults_on_a_file(models, speech):
    """The defaults (VAD on, beam 5, batch 8, language detection) on
    ``docker/jfk.flac`` given as a path; the JAX side gets the same file
    decoded by its own ``decode_audio`` (the two decoders agree exactly,
    test_torch_audio.py)."""
    jm, pm = models
    ref_segments, ref_info = JaxPipeline(jm).transcribe(speech[:176000], max_new_tokens=48)
    segments, info = BatchedInferencePipeline(pm).transcribe(JFK, max_new_tokens=48)
    assert (info.language, info.duration) == (ref_info.language, ref_info.duration)
    assert_segments_equal(list(segments), list(ref_segments))


def test_int8_pipeline_matches_jax(weights, speech, monkeypatch):
    """The JAX package's int8 model (float32 activations) against the
    port's ``int8_float32``, each batch decoded from the same encoder
    states: the JAX package's are recorded and handed to the port's
    decode, as in the sequential int8 test (test_torch_transcribe.py: the
    two int8 encoders differ by whole activation-code steps)."""
    jm = JaxWhisperModel.from_parts(weights, jax_config(), jax_tokenizer(), compute_type="int8")
    pm = port_model(weights, "int8_float32")
    assert pm.model.kv_int8
    kwargs = dict(language="en", beam_size=5, batch_size=2, max_new_tokens=48)

    states = []
    jax_dispatch = jm.model.generate_dispatch

    def record(encoder_output, prompts, **kw):
        states.append(np.array(encoder_output))
        return jax_dispatch(encoder_output, prompts, **kw)

    monkeypatch.setattr(jm.model, "generate_dispatch", record)
    ref_segments = list(JaxPipeline(jm).transcribe(speech, **kwargs)[0])

    replay = iter(states)
    port_dispatch = pm.model.generate_dispatch
    monkeypatch.setattr(
        pm.model, "generate_dispatch",
        lambda encoder_output, prompts, **kw: port_dispatch(
            torch.from_numpy(next(replay)), prompts, **kw
        ),
    )
    segments = list(BatchedInferencePipeline(pm).transcribe(speech, **kwargs)[0])
    assert next(replay, None) is None and len(states) == 2  # batches of 2 + 1 (padded)
    assert_segments_equal(segments, ref_segments)


def test_partial_trailing_batch_matches_unpadded(models, speech):
    """The counterpart of the JAX suite's
    ``test_transcribe.py::test_partial_trailing_batch_matches_unpadded``:
    four 24 s clips of ``docker/jfk.flac`` tiled 9 times, at batch 3 (the
    trailing chunk padded to the full batches' 3 rows) and at batch 2
    (which divides the chunks evenly), give equal starts, ends and texts,
    equal to the JAX package's pipeline on the same audio and weights."""
    jm, pm = models
    audio = np.tile(speech[: len(speech) // 6], 9)  # ~99 s
    clips = [{"start": i * 24.0, "end": (i + 1) * 24.0} for i in range(4)]
    kwargs = dict(language="en", beam_size=1, vad_filter=False, max_new_tokens=16, clip_timestamps=clips)

    def rows(segments):
        return [(s.start, s.end, s.text) for s in segments]

    pipe = BatchedInferencePipeline(pm)
    padded = rows(pipe.transcribe(audio, batch_size=3, **kwargs)[0])
    even = rows(pipe.transcribe(audio, batch_size=2, **kwargs)[0])
    ref = rows(JaxPipeline(jm).transcribe(audio, batch_size=2, **kwargs)[0])
    assert padded == even == ref
    assert len({start for start, _, _ in ref}) >= 4  # every clip gave a segment


def test_stale_batch_bucket_recomputed_for_larger_forward(models):
    """A tail bucket left behind by a generator run must not stop a larger
    direct call from taking its pow2 bucket: 12 rows run as 16, not 12."""
    _, pm = models
    pipe = BatchedInferencePipeline(pm)
    pipe._batch_bucket = 8  # what _batched_segments_generator leaves set
    fe = pm.feature_extractor
    feats = torch.zeros((12, fe.feature_size, fe.nb_max_frames))
    opts = TranscriptionOptions(**{
        **{f: None for f in TranscriptionOptions.__dataclass_fields__},
        "beam_size": 1, "best_of": 1, "patience": 1.0, "length_penalty": 1.0,
        "repetition_penalty": 1.0, "no_repeat_ngram_size": 0, "temperatures": [0.0],
        "suppress_blank": True, "suppress_tokens": [-1], "without_timestamps": True,
        "multilingual": False, "max_new_tokens": 4,
    })
    tok = Tokenizer(pm.hf_tokenizer, multilingual=True, task="transcribe", language="en")
    encoder_output, _ = pipe._dispatch_segment_batch(feats, tok, opts)
    assert encoder_output.shape[0] == 16
    # a direct generate_segment_batched call drops the stale bucket: 3 -> 4
    encoder_output, outputs = pipe.generate_segment_batched(feats[:3], tok, opts)
    assert encoder_output.shape[0] == 4 and len(outputs) == 4


def test_no_speech_and_no_chunks(models):
    _, pm = models
    pipe = BatchedInferencePipeline(pm)
    segments, info = pipe.transcribe(np.zeros(16000, np.float32), language="en", beam_size=1)
    assert list(segments) == [] and info.duration_after_vad == 0
    with pytest.raises(RuntimeError, match="No clip timestamps"):
        pipe.transcribe(np.zeros(16000 * 40, np.float32), language="en", vad_filter=False)
