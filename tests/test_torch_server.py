"""The port's HTTP server (``server.py``) against the JAX package's, on the
same float32 micro model and synthetic vocabulary: the JAX
``tests/test_server.py`` cases, each request sent to both servers.

Every JSON body must equal the JAX server's for the same bytes: text,
language, durations, segment ids, seeks, tokens, texts and start/end
exactly, ``avg_logprob`` within 1e-4 and ``no_speech_prob`` within 1e-5
(as in ``tests/test_torch_batched.py``), ``compression_ratio`` and
``temperature`` to float precision.  Error responses (400, 413) carry the
same bodies; the SSE stream carries the same events; ``/metrics`` counts
the same way.  Sequential requests ask for ``temperature=0``: a fallback
to sampling draws from each framework's own RNG.  The JAX side runs with
FWT_CACHE_ARTIFACTS=/nonexistent."""

import concurrent.futures
import io
import json
import os
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest

import jax
import torch

from faster_whisper_tpu.models.config import tiny_test_config as jax_config
from faster_whisper_tpu.models.load import random_params as jax_random_params
from faster_whisper_tpu.server import make_server as jax_make_server
from faster_whisper_tpu.testing import build_synthetic_tokenizer as jax_tokenizer
from faster_whisper_tpu.transcribe import WhisperModel as JaxWhisperModel
from faster_whisper_tpu_torch import WhisperModel
from faster_whisper_tpu_torch.models.config import tiny_test_config
from faster_whisper_tpu_torch.models.load import params_from_jax
from faster_whisper_tpu_torch.server import TranscriptionService, _LockedDrain, make_server
from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer

LOGPROB_TOL = 1e-4
NO_SPEECH_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's many small CPU ops (see
    test_torch_batched.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _no_shipped_compile_cache():
    old = os.environ.get("FWT_CACHE_ARTIFACTS")
    os.environ["FWT_CACHE_ARTIFACTS"] = "/nonexistent"
    yield
    if old is None:
        del os.environ["FWT_CACHE_ARTIFACTS"]
    else:
        os.environ["FWT_CACHE_ARTIFACTS"] = old


def _serve(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


@pytest.fixture(scope="module")
def servers():
    """(port server, JAX server) on the same weights, each serving on its
    own thread at an ephemeral port."""
    weights = jax_random_params(jax_config(), seed=0, dtype="float32")
    jm = JaxWhisperModel.from_parts(weights, jax_config(), jax_tokenizer())
    pm = WhisperModel.from_parts(
        params_from_jax(jax.tree.map(np.asarray, weights), device="cpu"),
        tiny_test_config(), build_synthetic_tokenizer(), compute_type="float32", device="cpu",
    )
    ours = _serve(make_server(pm, model_name="test-tiny"))
    ref = _serve(jax_make_server(jm, model_name="test-tiny"))
    yield ours, ref
    for server in (ours, ref):
        server.shutdown()
        server.service.close()


@pytest.fixture(scope="module")
def urls(servers):
    return tuple(f"http://127.0.0.1:{s.server_port}" for s in servers)


def _wav_bytes(seconds=2.0, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    pcm = (rng.standard_normal(int(sr * seconds)) * 3000).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def _post_multipart(url, payload, fields):
    boundary = "fwtboundary"
    parts = []
    for k, v in fields.items():
        parts.append(
            f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"'
            f"\r\n\r\n{v}\r\n".encode()
        )
    parts.append(
        f'--{boundary}\r\nContent-Disposition: form-data; name="file"; '
        f'filename="a.wav"\r\nContent-Type: audio/wav\r\n\r\n'.encode()
        + payload
        + b"\r\n"
    )
    parts.append(f"--{boundary}--\r\n".encode())
    req = urllib.request.Request(
        url + "/v1/audio/transcriptions",
        data=b"".join(parts),
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"},
    )
    return urllib.request.urlopen(req)


def _both(urls, send):
    """``send(url)`` against the port's server and the JAX server."""
    return [send(url) for url in urls]


def _error(send, url):
    """(status, body) of a request that must fail."""
    with pytest.raises(urllib.error.HTTPError) as info:
        send(url)
    return info.value.code, json.loads(info.value.read())


def assert_segment_equal(s, r):
    exact = ("id", "seek", "start", "end", "text", "tokens")
    assert {k: s[k] for k in exact if k in r} == {k: r[k] for k in exact if k in r}
    assert set(s) == set(r)
    if "avg_logprob" in r:
        assert s["avg_logprob"] == pytest.approx(r["avg_logprob"], abs=LOGPROB_TOL)
        assert s["no_speech_prob"] == pytest.approx(r["no_speech_prob"], abs=NO_SPEECH_TOL)
        assert s["compression_ratio"] == pytest.approx(r["compression_ratio"])
        assert s["temperature"] == pytest.approx(r["temperature"])


def assert_body_equal(ours, ref):
    assert set(ours) == set(ref)
    for k in ref:
        if k != "segments":
            assert ours[k] == pytest.approx(ref[k]) if isinstance(ref[k], float) else ours[k] == ref[k], k
    assert len(ours.get("segments", [])) == len(ref.get("segments", []))
    for s, r in zip(ours.get("segments", []), ref.get("segments", [])):
        assert_segment_equal(s, r)


def test_healthz(urls):
    bodies = []
    for url in urls:
        with urllib.request.urlopen(url + "/healthz") as r:
            bodies.append(json.load(r))
    assert bodies[0] == bodies[1] == {"status": "ok", "model": "test-tiny"}


def test_transcription_multipart(urls):
    fields = {
        "language": "en",
        "beam_size": "2",
        "vad_filter": "false",
        "response_format": "verbose_json",
        "batch_size": "2",
    }
    ours, ref = _both(urls, lambda url: json.load(_post_multipart(url, _wav_bytes(), fields)))
    assert ours["language"] == "en" and ours["segments"]
    for seg in ours["segments"]:
        assert seg["end"] >= seg["start"]
        assert "avg_logprob" in seg
    assert_body_equal(ours, ref)


def test_transcription_raw_body_query_options(urls):
    def send(url):
        req = urllib.request.Request(
            url
            + "/transcribe?language=en&beam_size=1&vad_filter=false"
            + "&response_format=text&batch_size=0&temperature=0",
            data=_wav_bytes(seed=1),
            headers={"Content-Type": "application/octet-stream"},
        )
        with urllib.request.urlopen(req) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            return r.read().decode()

    ours, ref = _both(urls, send)
    assert ours == ref


def test_bad_option_is_400(urls):
    send = lambda url: _post_multipart(url, _wav_bytes(), {"beam_size": "not-a-number"})  # noqa: E731
    ours, ref = (_error(send, url) for url in urls)
    assert ours == ref and ours[0] == 400


def test_missing_file_is_400(urls):
    def send(url):
        req = urllib.request.Request(
            url + "/v1/audio/transcriptions",
            data=b"",
            headers={"Content-Type": "application/octet-stream"},
        )
        return urllib.request.urlopen(req)

    ours, ref = (_error(send, url) for url in urls)
    assert ours == ref == (400, {"error": "no audio payload ('file' part)"})


def test_oversized_body_is_413(urls):
    def send(url):
        req = urllib.request.Request(
            url + "/v1/audio/transcriptions",
            data=b"x",
            headers={
                "Content-Type": "application/octet-stream",
                "Content-Length": str(600 * 1024 * 1024),
            },
        )
        return urllib.request.urlopen(req, timeout=10)

    ours, ref = (_error(send, url) for url in urls)
    assert ours == ref and ours[0] == 413


def test_concurrent_requests_serialize(urls):
    """Two simultaneous uploads both succeed, each with the JAX server's
    body."""
    fields = {"language": "en", "beam_size": "1", "vad_filter": "false", "batch_size": "2"}

    def two(url):
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            futs = [
                ex.submit(lambda seed: json.load(_post_multipart(url, _wav_bytes(seed=seed), fields)), s)
                for s in (10, 11)
            ]
            return [f.result(timeout=300) for f in futs]

    ours, ref = _both(urls, two)
    for o, r in zip(ours, ref):
        assert_body_equal(o, r)


def test_server_concurrent_requests_share_batches(servers, urls):
    """End-to-end over HTTP: concurrent uploads ride the shared batcher."""
    fields = {"language": "en", "beam_size": "1", "vad_filter": "false",
              "batch_size": "4", "max_new_tokens": "16", "temperature": "0",
              "response_format": "verbose_json"}
    batcher = servers[0].service.batcher
    assert batcher is not None
    b0, c0 = batcher.batches_dispatched, batcher.chunks_processed

    def four(url):
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            futs = [
                ex.submit(lambda seed: json.load(_post_multipart(url, _wav_bytes(seed=seed), fields)), s)
                for s in (20, 21, 22, 23)
            ]
            return [f.result(timeout=600) for f in futs]

    ours = four(urls[0])
    chunks = batcher.chunks_processed - c0
    batches = batcher.batches_dispatched - b0
    assert chunks == 4
    assert batches < chunks, (batches, chunks)  # overlap happened
    for o, r in zip(ours, four(urls[1])):
        assert_body_equal(o, r)


def _parse_sse(raw: bytes):
    events = []
    for block in raw.decode().split("\n\n"):
        block = block.strip()
        if not block:
            continue
        assert block.startswith("data: "), block
        data = block[len("data: "):]
        events.append(data if data == "[DONE]" else json.loads(data))
    return events


def test_sse_streaming_batched(urls):
    """stream=true yields one transcript.segment event per segment, a
    transcript.text.done summary, then [DONE]; the streamed segments equal
    the non-streaming response's and the JAX server's events."""
    fields = {
        "language": "en", "beam_size": "2", "vad_filter": "false",
        "batch_size": "2", "response_format": "verbose_json",
    }

    def send(url):
        with _post_multipart(url, _wav_bytes(), dict(fields)) as r:
            plain = json.load(r)
        with _post_multipart(url, _wav_bytes(), dict(fields, stream="true")) as r:
            assert r.headers["Content-Type"].startswith("text/event-stream")
            return plain, _parse_sse(r.read())

    (plain, events), (_, ref_events) = _both(urls, send)
    assert events[-1] == "[DONE]"
    done = events[-2]
    assert done["type"] == "transcript.text.done"
    assert done["text"] == plain["text"]
    assert done["language"] == plain["language"]
    seg_events = events[:-2]
    assert all(e["type"] == "transcript.segment" for e in seg_events)
    assert [e["segment"] for e in seg_events] == plain["segments"]
    assert len(events) == len(ref_events) and ref_events[-1] == "[DONE]"
    for e, r in zip(seg_events, ref_events[:-2]):
        assert e["type"] == r["type"]
        assert_segment_equal(e["segment"], r["segment"])
    assert_body_equal(done, ref_events[-2])


def test_sse_streaming_sequential_releases_lock(servers, urls):
    """batch_size=0 streams through the service lock; a second request
    afterwards does not deadlock (the _LockedDrain released it)."""
    fields = {
        "language": "en", "beam_size": "1", "vad_filter": "false",
        "batch_size": "0", "stream": "true", "temperature": "0",
    }
    runs = []
    for url in urls:
        for _ in range(2):
            with _post_multipart(url, _wav_bytes(seed=2), dict(fields)) as r:
                events = _parse_sse(r.read())
            assert events[-1] == "[DONE]"
            assert events[-2]["type"] == "transcript.text.done"
            runs.append(events)
    assert runs[0] == runs[1]
    assert [e["type"] for e in runs[0][:-1]] == [e["type"] for e in runs[2][:-1]]
    assert runs[0][-2] == runs[2][-2]
    lock = servers[0].service._lock
    assert lock.acquire(timeout=5)
    lock.release()


def test_locked_drain_releases_once_when_dropped_unstarted():
    lock = threading.Lock()
    lock.acquire()
    drain = _LockedDrain(iter([1, 2]), lock)
    drain.close()
    assert not lock.locked()
    drain.close()  # a second release would raise
    lock.acquire()
    drain = _LockedDrain(iter([1]), lock)
    assert list(drain) == [1] and not lock.locked()


def _scrape_metrics(url):
    with urllib.request.urlopen(url + "/metrics") as r:
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        name, value = line.rsplit(" ", 1)
        out[name] = float(value)
    return out


def test_metrics_endpoint_counts_requests(urls):
    deltas, names = [], []
    for url in urls:
        before = _scrape_metrics(url)
        with _post_multipart(url, _wav_bytes(1.0), {"language": "en", "beam_size": "1"}) as r:
            n_segments = len(json.load(r).get("segments", []))
        with pytest.raises(urllib.error.HTTPError):
            _post_multipart(url, b"", {})  # no payload -> 400

        after = _scrape_metrics(url)
        ok = 'fwt_requests_total{status="ok"}'
        bad = 'fwt_requests_total{status="bad_request"}'
        assert after[ok] == before.get(ok, 0) + 1
        assert after[bad] == before.get(bad, 0) + 1
        assert after["fwt_segments_total"] >= before.get("fwt_segments_total", 0) + n_segments
        assert after["fwt_audio_seconds_total"] > before.get("fwt_audio_seconds_total", 0)
        assert after["fwt_request_seconds_total"] > before.get("fwt_request_seconds_total", 0)
        assert after["fwt_requests_in_flight"] == 0
        # the shared ContinuousBatcher's efficiency counters are exported too
        assert "fwt_batcher_batches_dispatched_total" in after
        assert "fwt_batcher_chunks_processed_total" in after
        names.append(sorted(after))
        deltas.append({k: after[k] - before.get(k, 0) for k in after
                       if k not in ("fwt_request_seconds_total",)})
    assert names[0] == names[1]
    assert deltas[0] == deltas[1]


def test_service_without_batcher_runs_every_request_under_the_lock(servers):
    """``batched=False``: no batcher, and requests go through the
    sequential path under the service lock."""
    model = servers[0].service.model
    service = TranscriptionService(model, batched=False)
    try:
        assert service.batcher is None
        segments, info = service.transcribe_bytes(
            _wav_bytes(seed=3), dict(language="en", beam_size=1, temperature=0.0)
        )
        assert info.language == "en" and not service._lock.locked()
        assert "fwt_batcher" not in service.metrics.render(service.batcher)
    finally:
        service.close()
