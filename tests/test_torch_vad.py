"""The port's Silero VAD and speech-chunk bookkeeping against the JAX
package's.

The audio is ``docker/jfk.flac`` decoded by the JAX ``decode_audio``,
tiled three times and put on the int16 grid that both packages' uploads
apply.  Both VADs read the same ``silero_vad_v6.npz``.  Probabilities
within 2e-5: float32 on both sides (the JAX forward at HIGHEST precision),
with the STFT, the conv tower and the 128-wide LSTM gates summed in other
orders over ~2,000 windows (measured ~7e-6).  Speech timestamps, chunk
buffers, their metadata and the restored times must be equal.  The JAX
side runs with FWT_CACHE_ARTIFACTS=/nonexistent."""

import os

import numpy as np
import pytest

import jax  # noqa: F401  (test files import both frameworks)
import torch

from faster_whisper_tpu import vad as jvad
from faster_whisper_tpu.audio import decode_audio as jax_decode_audio
from faster_whisper_tpu.models.silero import SileroVAD as JaxSileroVAD
from faster_whisper_tpu.transcribe import Segment as JaxSegment
from faster_whisper_tpu.transcribe import restore_speech_timestamps as jax_restore
from faster_whisper_tpu_torch import vad as pvad
from faster_whisper_tpu_torch.models.silero import SileroVAD
from faster_whisper_tpu_torch.transcribe import Segment, restore_speech_timestamps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JFK = os.path.join(ROOT, "docker", "jfk.flac")
PROB_TOL = 2e-5
SR = 16000

CHUNK_LISTS = {
    "none": [],
    "one": [{"start": 1000, "end": 9000}],
    "gaps": [{"start": 0, "end": 4000}, {"start": 6000, "end": 20000}, {"start": 20500, "end": 40000}],
    "long": [{"start": 100, "end": 200000}, {"start": 260000, "end": 300000}],
    "many-short": [{"start": 5000 * i + 700, "end": 5000 * i + 3100} for i in range(12)],
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
def speech():
    """jfk.flac, 16 kHz mono, tiled to 33 s, on the int16 grid."""
    audio = np.tile(jax_decode_audio(JFK, sampling_rate=SR), 3)
    q = np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16)
    return (q / 32768.0).astype(np.float32)


def test_silero_probabilities_match_jax(speech):
    x = speech[: len(speech) // 512 * 512]
    ref = JaxSileroVAD()(x)
    ours = SileroVAD("cpu")(x)
    assert ours.device.type == "cpu" and ours.dtype == torch.float32
    assert ours.shape == ref.shape == (len(x) // 512,)
    np.testing.assert_allclose(ours.numpy(), ref, atol=PROB_TOL, rtol=0)
    # speech and silence both occur, so the thresholds are exercised
    assert ref.max() > 0.9 and ref.min() < 0.1


@pytest.mark.parametrize(
    "options",
    [{}, dict(max_speech_duration_s=30, min_silence_duration_ms=160),
     dict(threshold=0.6, min_speech_duration_ms=250, speech_pad_ms=100)],
    ids=["default", "pipeline", "stricter"],
)
def test_speech_timestamps_match_jax(speech, options):
    ref = jvad.get_speech_timestamps(speech, jvad.VadOptions(**options))
    ours = pvad.get_speech_timestamps(speech, pvad.VadOptions(**options), device="cpu")
    assert ours == ref and len(ref) >= 1
    # a tensor already on the device gives the same chunks
    on_device = pvad.get_speech_timestamps(torch.from_numpy(speech), pvad.VadOptions(**options))
    assert on_device == ref


def test_speech_timestamps_of_silence_and_of_nothing():
    for audio in (np.zeros(16000, np.float32), np.zeros(0, np.float32), np.zeros(1024, np.float32)):
        assert pvad.get_speech_timestamps(audio, device="cpu") == jvad.get_speech_timestamps(audio)


@pytest.mark.parametrize("max_duration", [float("inf"), 2.0, 30.0])
@pytest.mark.parametrize("chunks", list(CHUNK_LISTS.values()), ids=list(CHUNK_LISTS))
def test_collect_chunks_matches_jax(chunks, max_duration):
    audio = np.random.default_rng(0).standard_normal(320000).astype(np.float32)
    ref_audio, ref_meta = jvad.collect_chunks(audio, chunks, max_duration=max_duration)
    ours_audio, ours_meta = pvad.collect_chunks(audio, chunks, max_duration=max_duration)
    assert ours_meta == ref_meta
    assert len(ours_audio) == len(ref_audio)
    for a, b in zip(ours_audio, ref_audio):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "chunks", [c for c in CHUNK_LISTS.values() if c], ids=[k for k, c in CHUNK_LISTS.items() if c]
)
def test_speech_timestamps_map_and_restore_match_jax(chunks):
    ref_map = jvad.SpeechTimestampsMap(chunks, SR)
    ours_map = pvad.SpeechTimestampsMap(chunks, SR)
    kept = sum(c["end"] - c["start"] for c in chunks) / SR
    # a grid over the kept audio, and each chunk's end exactly (is_end)
    times = list(np.linspace(0.0, kept + 0.5, 97)) + [e / SR for e in ref_map.chunk_end_sample]
    for t in times:
        for is_end in (False, True):
            assert ours_map.get_chunk_index(t, is_end) == ref_map.get_chunk_index(t, is_end)
            assert ours_map.get_original_time(t, is_end=is_end) == ref_map.get_original_time(t, is_end=is_end)

    spans = [(float(a), float(b)) for a, b in zip(times[:-1:3], times[1::3]) if b >= a]

    def segments(cls):
        return [
            cls(id=i, seek=0, start=a, end=b, text="x", tokens=[1], avg_logprob=-0.5,
                compression_ratio=1.0, no_speech_prob=0.1, words=None, temperature=0.0)
            for i, (a, b) in enumerate(spans)
        ]

    ref = list(jax_restore(segments(JaxSegment), chunks, SR))
    ours = list(restore_speech_timestamps(segments(Segment), chunks, SR))
    assert [(s.start, s.end) for s in ours] == [(s.start, s.end) for s in ref]
    assert len(ours) == len(spans) > 10


# ---------------------------------------------------------------------------
# The native state machine (csrc/vad_sm.cpp) against its plain version
# ---------------------------------------------------------------------------

# (threshold, neg_threshold, min_speech, max_speech, min_silence, silence at
# max speech) in samples: the option corners of the JAX package's
# tests/test_vad.py::test_native_hysteresis_matches_python
HYSTERESIS_CORNERS = [
    (0.5, 0.35, 4000.0, float("inf"), 2000.0, 1568.0),
    (0.5, 0.35, 0.0, 16000 * 4.0, 32000.0, 1568.0),
    (0.3, 0.15, 250.0, 16000 * 2.5, 1600.0, 1568.0),
    (0.8, 0.65, 0.0, 16000 * 1.0, 500.0, 1568.0),
]


@pytest.mark.parametrize("corner", HYSTERESIS_CORNERS, ids=["defaults", "max-4s", "low", "max-1s"])
def test_native_hysteresis_matches_the_python_loop(corner):
    """``hysteresis_native`` equals ``_hysteresis_py`` (and the JAX
    package's Python loop) on random slow-moving probability streams."""
    n = 4000
    for seed in range(6):
        r = np.random.default_rng(seed)
        probs = np.clip(np.cumsum(r.normal(0, 0.08, n)) % 2, 0, None)
        probs = np.abs(1 - np.abs(1 - probs)).astype(np.float32)
        args = (512, *corner, n * 512)
        py = pvad._hysteresis_py(probs, *args)
        assert pvad.hysteresis_native(probs, *args) == py == jvad._hysteresis_py(probs, *args), seed


def test_native_hysteresis_threshold_boundaries():
    """Probabilities exactly at the float32-rounded thresholds: the Python
    loop compares a float32 probability with the threshold in float32
    (numpy 2), and so does the native loop."""
    probs = np.array(
        [0.9, 0.9, np.float32(0.35), 0.2, 0.2, 0.9, np.float32(0.5), 0.34, 0.1, 0.1, 0.9, 0.9],
        dtype=np.float32,
    )
    args = (512, 0.5, 0.35, 0.0, float("inf"), 1024.0, 1568.0, len(probs) * 512)
    assert pvad.hysteresis_native(probs, *args) == pvad._hysteresis_py(probs, *args)
    assert pvad.hysteresis_native(probs[:0], *args[:-1], 0) == []


def test_get_speech_timestamps_runs_the_native_state_machine(speech, monkeypatch):
    """Every ``get_speech_timestamps`` call goes through
    ``hysteresis_native``, and its speech equals the Python loop's."""
    calls = []
    native = pvad.hysteresis_native

    def counted(probs, *args):
        out = native(probs, *args)
        assert out == pvad._hysteresis_py(probs, *args)
        calls.append(len(out))
        return out

    monkeypatch.setattr(pvad, "hysteresis_native", counted)
    for opts in (pvad.VadOptions(), pvad.VadOptions(max_speech_duration_s=2.0, min_silence_duration_ms=160)):
        assert pvad.get_speech_timestamps(speech, opts, device="cpu")
    assert len(calls) == 2 and all(calls)


# ---------------------------------------------------------------------------
# The pipelined sliced upload (upload_with_vad, FWT_PIPELINED_VAD=1): the
# counterparts of the JAX package's tests/test_vad.py upload_with_vad tests,
# at its slice of 2048 windows (65.5 s)
# ---------------------------------------------------------------------------


def _tiled(base, n):
    return np.tile(base, -(-n // len(base)))[:n]


def test_upload_with_vad_matches_whole_buffer_forward(speech):
    """The sliced forward (the LSTM state and the 64-sample context carried
    across slices) is bit for bit the whole-buffer forward, whose length
    ends inside a slice; the device PCM equals ``upload_audio``'s; the
    probabilities agree with the JAX package's pipelined forward."""
    from faster_whisper_tpu_torch.models.silero import VAD_SLICE_SAMPLES
    from faster_whisper_tpu_torch.ops.mel import upload_audio

    audio = _tiled(speech, int(2.3 * VAD_SLICE_SAMPLES))
    expected = len(audio) // 512 + 1
    ref = pvad.get_vad_model("cpu")(np.pad(audio, (0, expected * 512 - len(audio)))).numpy()

    audio_dev, probs = pvad.upload_with_vad(audio, device="cpu")
    assert isinstance(probs, np.ndarray) and probs.shape[0] >= expected
    np.testing.assert_array_equal(probs[:expected], ref)
    assert torch.equal(audio_dev, upload_audio(audio, "cpu"))

    _, jax_probs = jvad.upload_with_vad(audio, return_audio=False)
    np.testing.assert_allclose(probs[:expected], np.asarray(jax_probs)[:expected], atol=PROB_TOL, rtol=0)


def test_upload_with_vad_exact_bucket_multiple(speech):
    """A length of whole slices: the reference pads one more window past
    the end, which a zero slice made on the device supplies; the PCM copy
    keeps the audio's length."""
    from faster_whisper_tpu_torch.models.silero import VAD_SLICE_SAMPLES

    audio = _tiled(speech, 2 * VAD_SLICE_SAMPLES)
    expected = len(audio) // 512 + 1
    ref = pvad.get_vad_model("cpu")(np.pad(audio, (0, 512))).numpy()

    audio_dev, probs = pvad.upload_with_vad(audio, device="cpu")
    assert probs.shape[0] >= expected
    assert audio_dev.shape[0] == len(audio)
    np.testing.assert_array_equal(probs[:expected], ref)
    assert pvad.upload_with_vad(audio, return_audio=False, device="cpu")[0] is None


def test_pipelined_vad_same_speech_timestamps(speech, monkeypatch):
    """``get_speech_timestamps`` decides the same with the pipelined sliced
    path off and on, and so does ``BatchedInferencePipeline`` (its speech
    chunks, and the segments decoded from them)."""
    from faster_whisper_tpu_torch.testing import build_test_model
    from faster_whisper_tpu_torch.transcribe import BatchedInferencePipeline

    audio = _tiled(speech, int(1.5 * SR * 30))
    opts = pvad.VadOptions(max_speech_duration_s=30, min_silence_duration_ms=160)
    uploads = []
    upload = pvad.upload_with_vad

    def counted(*args, **kwargs):
        uploads.append(kwargs.get("return_audio", True))
        return upload(*args, **kwargs)

    monkeypatch.setattr(pvad, "upload_with_vad", counted)
    monkeypatch.setattr("faster_whisper_tpu_torch.transcribe.upload_with_vad", counted)
    pipeline = BatchedInferencePipeline(build_test_model(device="cpu"))

    def run():
        chunks = pvad.get_speech_timestamps(audio, opts, device="cpu")
        segments, info = pipeline.transcribe(audio, language="en", max_new_tokens=4, batch_size=4)
        return chunks, [(s.start, s.end, s.tokens) for s in segments], info.duration_after_vad

    monkeypatch.setenv("FWT_PIPELINED_VAD", "0")
    ref = run()
    assert uploads == []
    monkeypatch.setenv("FWT_PIPELINED_VAD", "1")
    got = run()
    assert uploads == [False, True]  # get_speech_timestamps, then the pipeline
    assert got == ref
    assert len(ref[0]) > 1 and ref[2] > 0
