"""The port's cross-request ``ContinuousBatcher`` (``scheduler.py``) and
``BatchedInferencePipeline(model, scheduler=...)`` against the JAX
package's, on the same float32 micro model and synthetic vocabulary.

Concurrent requests must share device batches (fewer batches than
chunks), and the scheduled path's segments must equal the port's
unscheduled pipeline's and the JAX package's scheduled path's: ids,
seeks, texts, tokens and start/end exactly, ``avg_logprob`` within 1e-4
(float32 sums of log-probs in another order; the JAX package's beam score
also moves by up to 1e-4 with the other rows of its batch) and
``no_speech_prob`` within 1e-5.  Words through the scheduler equal the
JAX package's, probabilities within 1e-5.

Two thread hazards of serving, each with a test that fails without its
repair: a float32 encode launched while another thread is inside
``utils.exact_float32`` (whose process-wide TF32 flags it must not
see), and ``ops/cross_attention.py::_buffer`` called from two threads at
once (which returned the other thread's, smaller, buffer).  The JAX side
runs with FWT_CACHE_ARTIFACTS=/nonexistent."""

import concurrent.futures
import io
import os
import threading
import time
import wave

import numpy as np
import pytest

import jax
import torch

from faster_whisper_tpu.audio import decode_audio as jax_decode_audio
from faster_whisper_tpu.models.config import tiny_test_config as jax_config
from faster_whisper_tpu.models.load import random_params as jax_random_params
from faster_whisper_tpu.scheduler import ContinuousBatcher as JaxBatcher
from faster_whisper_tpu.scheduler import GenKey as JaxGenKey
from faster_whisper_tpu.scheduler import _Entry as JaxEntry
from faster_whisper_tpu.testing import build_synthetic_tokenizer as jax_tokenizer
from faster_whisper_tpu.transcribe import BatchedInferencePipeline as JaxPipeline
from faster_whisper_tpu.transcribe import WhisperModel as JaxWhisperModel
from faster_whisper_tpu_torch import BatchedInferencePipeline, WhisperModel
from faster_whisper_tpu_torch.audio import decode_audio
from faster_whisper_tpu_torch.models import model as port_model_module
from faster_whisper_tpu_torch.models.config import tiny_test_config
from faster_whisper_tpu_torch.models.load import params_from_jax
from faster_whisper_tpu_torch.ops import cross_attention
from faster_whisper_tpu_torch.scheduler import ContinuousBatcher, GenKey, _Entry
from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer
from faster_whisper_tpu_torch.utils import exact_float32

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JFK = os.path.join(ROOT, "docker", "jfk.flac")
LOGPROB_TOL = 1e-4
PROB_TOL = 1e-5
SPECIALS = [-1] + list(range(257, 1865))
# the JAX test's request: one 3 s chunk, beam 2, 16 new tokens
KWARGS = dict(language="en", beam_size=2, vad_filter=False, max_new_tokens=16, temperature=[0.0])


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
def weights():
    return jax_random_params(jax_config(), seed=0, dtype="float32")


@pytest.fixture(scope="module")
def models(weights):
    jm = JaxWhisperModel.from_parts(weights, jax_config(), jax_tokenizer())
    pm = WhisperModel.from_parts(
        params_from_jax(jax.tree.map(np.asarray, weights), device="cpu"),
        tiny_test_config(), build_synthetic_tokenizer(), compute_type="float32", device="cpu",
    )
    return jm, pm


def wav_bytes(seconds=3.0, sr=16000, seed=5):
    rng = np.random.default_rng(seed)
    pcm = (rng.standard_normal(int(sr * seconds)) * 3000).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def assert_segments_equal(segments, ref, words=False):
    assert len(segments) == len(ref) > 0
    for s, r in zip(segments, ref):
        assert (s.id, s.seek, s.text, s.tokens) == (r.id, r.seek, r.text, r.tokens)
        assert (s.start, s.end) == (r.start, r.end)
        assert s.avg_logprob == pytest.approx(r.avg_logprob, abs=LOGPROB_TOL)
        assert s.no_speech_prob == pytest.approx(r.no_speech_prob, abs=1e-5)
        assert s.compression_ratio == pytest.approx(r.compression_ratio)
        assert s.temperature == r.temperature
        if words:
            assert s.words is not None and len(s.words) == len(r.words), s.id
            for a, b in zip(s.words, r.words):
                assert (a.word, a.start, a.end) == (b.word, b.start, b.end), s.id
                assert a.probability == pytest.approx(b.probability, abs=PROB_TOL)


def concurrent_requests(pipeline_of, audio, n, **kwargs):
    """``n`` requests of ``audio`` started together, each through its own
    pipeline; returns their segment lists."""
    barrier = threading.Barrier(n)

    def one_request(_):
        barrier.wait()  # maximize overlap
        segments, _ = pipeline_of().transcribe(audio, **kwargs)
        return list(segments)

    with concurrent.futures.ThreadPoolExecutor(n) as ex:
        return list(ex.map(one_request, range(n)))


def test_genkey_and_entry_match_jax():
    assert GenKey._fields == JaxGenKey._fields
    assert GenKey.__annotations__ == JaxGenKey.__annotations__
    assert GenKey._field_defaults == JaxGenKey._field_defaults == {}
    assert _Entry.__slots__ == JaxEntry.__slots__
    key = dict(beam_size=5, patience=1.0, length_penalty=1.0, repetition_penalty=1.0,
               no_repeat_ngram_size=0, max_length=132, suppress_blank=True,
               suppress_tokens=(1, 2), sampling=False, with_timestamps=False)
    assert tuple(GenKey(**key)) == tuple(JaxGenKey(**key))
    assert hash(GenKey(**key)) == hash(JaxGenKey(**key))


def test_continuous_batcher_coalesces_and_matches_unscheduled(models):
    """Four concurrent one-chunk requests share batches, and give the port's
    unscheduled segments and the JAX package's scheduled ones."""
    jm, pm = models
    payload = wav_bytes()
    audio = decode_audio(io.BytesIO(payload))
    np.testing.assert_array_equal(audio, jax_decode_audio(io.BytesIO(payload)))

    ref = list(BatchedInferencePipeline(pm).transcribe(audio, batch_size=2, **KWARGS)[0])

    batcher = ContinuousBatcher(pm, max_batch=4, max_wait_ms=300)
    try:
        outs = concurrent_requests(
            lambda: BatchedInferencePipeline(pm, scheduler=batcher), audio, 4, batch_size=4, **KWARGS
        )
        assert batcher.chunks_processed == 4
        # coalescing is the point: 4 concurrent single-chunk requests share
        # batches instead of running one device batch each
        assert batcher.batches_dispatched <= 2, batcher.batches_dispatched
    finally:
        batcher.close()

    jax_batcher = JaxBatcher(jm, max_batch=4, max_wait_ms=300)
    try:
        jax_outs = concurrent_requests(
            lambda: JaxPipeline(jm, scheduler=jax_batcher), audio, 4, batch_size=4, **KWARGS
        )
    finally:
        jax_batcher.close()
    for out, jax_out in zip(outs, jax_outs):
        assert_segments_equal(out, ref)
        assert_segments_equal(out, jax_out)


def test_batcher_shares_batches_across_temperatures(models):
    """Requests that differ ONLY in sampling temperature coalesce: the
    temperature is a per-row argument of the sampling decode, so a t=0.3
    and a t=0.8 request ride one device batch."""
    _, pm = models
    audio = decode_audio(io.BytesIO(wav_bytes()))
    eng = pm.model
    dispatched = []
    orig = eng.generate_dispatch

    def spy(enc, prompts, **kw):
        dispatched.append(kw.get("sampling_temperature"))
        return orig(enc, prompts, **kw)

    eng.generate_dispatch = spy
    batcher = ContinuousBatcher(pm, max_batch=4, max_wait_ms=300)
    try:
        barrier = threading.Barrier(2)

        def one_request(temp):
            barrier.wait()
            pipeline = BatchedInferencePipeline(pm, scheduler=batcher)
            segments, _ = pipeline.transcribe(
                audio, language="en", beam_size=1, temperature=[temp],
                vad_filter=False, max_new_tokens=16, batch_size=4,
            )
            return [(s.start, s.end, s.temperature) for s in segments]

        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            outs = list(ex.map(one_request, [0.3, 0.8]))

        assert all(outs), outs
        assert [{t for _, _, t in out} for out in outs] == [{0.3}, {0.8}]
        assert batcher.chunks_processed == 2
        assert batcher.batches_dispatched == 1, (batcher.batches_dispatched, dispatched)
        # one batched dispatch carrying BOTH temperatures per row
        temps = dispatched[-1]
        assert isinstance(temps, list) and sorted(set(temps)) == [0.3, 0.8]
    finally:
        del eng.generate_dispatch
        batcher.close()


def test_scheduler_path_all_silence_yields_no_segments(models):
    """When the VAD removes all speech, collect_chunks still emits one
    empty chunk with metadata; the scheduled path submits zero rows."""
    _, pm = models
    batcher = ContinuousBatcher(pm, max_batch=4)
    try:
        pipeline = BatchedInferencePipeline(pm, scheduler=batcher)
        segments, info = pipeline.transcribe(np.zeros(16000, dtype=np.float32), language="en", beam_size=1)
        assert list(segments) == []
        assert info.duration_after_vad == 0
        assert batcher.batches_dispatched == 0
    finally:
        batcher.close()


def test_scheduled_word_timestamps_match_jax(models):
    """``docker/jfk.flac`` tiled to 66 s (three VAD chunks, one batch
    bucketed to 4) with words, through each package's batcher: each
    chunk's alignment runs on the request's thread over its row of the
    shared batch's encoder states."""
    jm, pm = models
    audio = np.tile(jax_decode_audio(JFK, sampling_rate=16000), 6)
    kwargs = dict(language="en", beam_size=5, batch_size=8, max_new_tokens=48,
                  word_timestamps=True, suppress_tokens=SPECIALS)
    jax_batcher = JaxBatcher(jm, max_batch=8)
    try:
        ref = list(JaxPipeline(jm, scheduler=jax_batcher).transcribe(audio, **kwargs)[0])
    finally:
        jax_batcher.close()
    batcher = ContinuousBatcher(pm, max_batch=8)
    try:
        segments = list(BatchedInferencePipeline(pm, scheduler=batcher).transcribe(audio, **kwargs)[0])
        assert (batcher.batches_dispatched, batcher.chunks_processed) == (1, 3)
    finally:
        batcher.close()
    assert len({s.seek for s in segments}) >= 3  # several chunks
    assert sum(len(s.words) for s in segments) > 0
    assert_segments_equal(segments, ref, words=True)
    unscheduled = list(BatchedInferencePipeline(pm).transcribe(audio, **kwargs)[0])
    assert_segments_equal(segments, unscheduled, words=True)


def test_a_batcher_error_reaches_every_waiting_request(models, monkeypatch):
    _, pm = models
    audio = decode_audio(io.BytesIO(wav_bytes()))
    batcher = ContinuousBatcher(pm, max_batch=4)
    try:
        def broken(*args, **kwargs):
            raise RuntimeError("decode failed")

        monkeypatch.setattr(pm.model, "generate_dispatch", broken)
        with pytest.raises(RuntimeError, match="decode failed"):
            list(BatchedInferencePipeline(pm, scheduler=batcher).transcribe(audio, **KWARGS)[0])
    finally:
        batcher.close()
    with pytest.raises(RuntimeError, match="shut down"):
        batcher.submit(None, [[1]], None)


# ---------------------------------------------------------------------------
# thread hazards
# ---------------------------------------------------------------------------


def test_float32_encode_is_not_inside_another_threads_exact_float32_block(models, monkeypatch):
    """The TF32 flags are process-wide, and a server's request threads run
    the VAD and the log-mel inside ``exact_float32`` while the batcher's
    thread encodes.  A float32 encode must launch its convolutions under
    the process's own settings: it waits until the other thread's block
    has ended."""
    _, pm = models
    feats = torch.zeros((1, pm.model.n_mels, 3000))
    outside = torch.backends.cudnn.allow_tf32
    assert outside  # PyTorch's default: TF32 convolutions on the card
    seen = []
    conv1d = torch.nn.functional.conv1d

    def recording_conv1d(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return conv1d(*args, **kwargs)

    monkeypatch.setattr(port_model_module.F, "conv1d", recording_conv1d)
    inside, release = threading.Event(), threading.Event()

    def exact_block():
        with exact_float32():
            inside.set()
            release.wait(10)

    blocker = threading.Thread(target=exact_block)
    blocker.start()
    assert inside.wait(10)
    encoder = threading.Thread(target=pm.model.encode, args=(feats,))
    encoder.start()
    time.sleep(0.3)  # without the repair, the encode runs in the block
    release.set()
    blocker.join(10)
    encoder.join(30)
    assert not encoder.is_alive()
    matmul = torch.backends.cuda.matmul.allow_tf32
    assert seen == [(outside, matmul)] * 2


def test_kernel_buffer_is_never_smaller_than_asked_from_two_threads():
    """Two threads ask ``_buffer`` for the same use at once, the one for a
    batch of 8 rows (2000 elements) between the other's first look and its
    append of a 256-element buffer: each must get a buffer of at least its
    own size (the wrappers hand the kernel its address; a smaller one would
    be written past its end)."""
    dev, use = torch.device("cpu"), "test scratch"
    small_checked, large_appended = threading.Event(), threading.Event()

    class Interleaved(list):
        """The small caller's first look waits for the large caller's
        append; the large caller's append waits for the small caller's."""

        def __bool__(self):
            empty = list.__len__(self) == 0
            if threading.current_thread().name == "small" and not small_checked.is_set():
                small_checked.set()
                large_appended.wait(5)
            return not empty

        def append(self, buf):
            list.append(self, buf)
            if threading.current_thread().name == "large":
                large_appended.set()
                time.sleep(0.3)  # the small caller appends in between

    cross_attention._buffers[(dev, use)] = Interleaved()
    got = {}

    def ask(n):
        got[threading.current_thread().name] = cross_attention._buffer(dev, use, n, torch.int32)

    small = threading.Thread(target=ask, args=(100,), name="small")
    small.start()
    assert small_checked.wait(5)
    large = threading.Thread(target=ask, args=(2000,), name="large")
    large.start()
    small.join(10)
    large.join(10)
    try:
        assert got["small"].numel() >= 100
        assert got["large"].numel() >= 2000
        assert not got["large"].any()  # zero-initialised
    finally:
        del cross_attention._buffers[(dev, use)]
