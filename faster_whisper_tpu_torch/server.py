"""Minimal transcription server over BatchedInferencePipeline.

Counterpart of ``faster_whisper_tpu/server.py``, with the same endpoints,
options, metrics and error codes: a dependency-free HTTP front end whose
batched requests share device batches through one ``ContinuousBatcher``
(``scheduler.py``), while sequential requests serialize on a lock.

Endpoints (OpenAI-audio-compatible surface, the schema those community
wrappers expose):

  POST /v1/audio/transcriptions
      multipart/form-data with a ``file`` part plus optional fields
      (language, task, beam_size, batch_size, temperature,
      word_timestamps, vad_filter, initial_prompt, hotwords,
      response_format: json|verbose_json|text), or a raw audio body with
      options in the query string.  With ``stream=true`` the response is
      Server-Sent Events: one ``transcript.segment`` event per segment AS
      DECODED (the pipeline is a generator — segments stream while later
      windows are still on the device), a final ``transcript.text.done``
      event with the full text and info, then ``data: [DONE]``.
  GET  /healthz       -> {"status": "ok", "model": ...}
  GET  /metrics       -> Prometheus text format: request/segment/audio-second
                         counters, request latency sum, in-flight gauge, and
                         the ContinuousBatcher's device-batch vs chunk
                         counters (batching efficiency = chunks/batches).

Run:  python -m faster_whisper_tpu_torch.server --model <model dir> --port 8000
"""

import argparse
import io
import json
import logging
import threading
import time
from email import policy
from email.parser import BytesParser
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

logger = logging.getLogger("faster_whisper_tpu_torch.server")

_BOOL = {"1": True, "true": True, "yes": True, "0": False, "false": False,
         "no": False}


class _TooLarge(Exception):
    """Request body over the configured limit (-> HTTP 413)."""

# transcribe() kwargs settable over HTTP, with parsers
_OPTION_PARSERS = {
    "language": str,
    "task": str,
    "beam_size": int,
    "best_of": int,
    "patience": float,
    "length_penalty": float,
    "repetition_penalty": float,
    "no_repeat_ngram_size": int,
    "temperature": lambda v: [float(t) for t in str(v).split(",")],
    "compression_ratio_threshold": float,
    "log_prob_threshold": float,
    "no_speech_threshold": float,
    "condition_on_previous_text": lambda v: _BOOL[str(v).lower()],
    "initial_prompt": str,
    "prefix": str,
    "without_timestamps": lambda v: _BOOL[str(v).lower()],
    "word_timestamps": lambda v: _BOOL[str(v).lower()],
    "vad_filter": lambda v: _BOOL[str(v).lower()],
    "max_new_tokens": int,
    "chunk_length": int,
    "batch_size": int,
    "hotwords": str,
    "multilingual": lambda v: _BOOL[str(v).lower()],
}


def _segment_dict(seg, verbose):
    d = {
        "id": seg.id,
        "start": seg.start,
        "end": seg.end,
        "text": seg.text,
    }
    if verbose:
        d.update(
            seek=seg.seek,
            tokens=seg.tokens,
            temperature=seg.temperature,
            avg_logprob=seg.avg_logprob,
            compression_ratio=seg.compression_ratio,
            no_speech_prob=seg.no_speech_prob,
        )
        if seg.words:
            d["words"] = [
                {
                    "start": w.start,
                    "end": w.end,
                    "word": w.word,
                    "probability": w.probability,
                }
                for w in seg.words
            ]
    return d


class ServiceMetrics:
    """Lock-protected serving counters exported at GET /metrics."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests_total = {"ok": 0, "error": 0, "bad_request": 0}
        self.request_seconds_total = 0.0
        self.audio_seconds_total = 0.0
        self.segments_total = 0
        self.in_flight = 0

    def start(self):
        with self._lock:
            self.in_flight += 1

    def bad_request(self):
        with self._lock:
            self.requests_total["bad_request"] += 1

    def finish(self, status, seconds, audio_seconds=0.0, n_segments=0):
        with self._lock:
            self.in_flight -= 1
            self.requests_total[status] = self.requests_total.get(status, 0) + 1
            self.request_seconds_total += seconds
            self.audio_seconds_total += audio_seconds
            self.segments_total += n_segments

    def render(self, batcher=None) -> str:
        with self._lock:
            lines = [
                "# TYPE fwt_requests_total counter",
                *(
                    f'fwt_requests_total{{status="{k}"}} {v}'
                    for k, v in sorted(self.requests_total.items())
                ),
                "# TYPE fwt_request_seconds_total counter",
                f"fwt_request_seconds_total {self.request_seconds_total:.3f}",
                "# TYPE fwt_audio_seconds_total counter",
                f"fwt_audio_seconds_total {self.audio_seconds_total:.3f}",
                "# TYPE fwt_segments_total counter",
                f"fwt_segments_total {self.segments_total}",
                "# TYPE fwt_requests_in_flight gauge",
                f"fwt_requests_in_flight {self.in_flight}",
            ]
        if batcher is not None:
            lines += [
                "# TYPE fwt_batcher_batches_dispatched_total counter",
                f"fwt_batcher_batches_dispatched_total {batcher.batches_dispatched}",
                "# TYPE fwt_batcher_chunks_processed_total counter",
                f"fwt_batcher_chunks_processed_total {batcher.chunks_processed}",
            ]
        return "\n".join(lines) + "\n"


class TranscriptionService:
    """Owns the model and a process-wide chunk batcher.

    Batched requests run CONCURRENTLY: each handler thread does its own
    host phases (audio decode, VAD hysteresis, tokenization) and submits
    its VAD chunks to one shared ContinuousBatcher, which merges chunks
    from all in-flight requests into shared device batches (see
    scheduler.py).  Only the request shapes the batcher cannot merge —
    sequential mode (batch_size=0) and multilingual — serialize on
    ``_lock``; they run beside the batcher's thread, on the same (default)
    CUDA stream.
    """

    def __init__(self, model, batched=True, max_batch=8):
        self.model = model
        self.batched = batched
        self.metrics = ServiceMetrics()
        self.batcher = None
        if batched:
            from faster_whisper_tpu_torch.scheduler import ContinuousBatcher

            self.batcher = ContinuousBatcher(model, max_batch=max_batch)
        self._lock = threading.Lock()

    def close(self):
        if self.batcher is not None:
            self.batcher.close()

    def transcribe_bytes(self, payload: bytes, options: dict):
        segments, info = self.stream_bytes(payload, options)
        return list(segments), info

    def stream_bytes(self, payload: bytes, options: dict):
        """Like ``transcribe_bytes`` but returns the LAZY segment
        generator: callers (the SSE route) see each segment as soon as
        its window is decoded.  Lock-requiring shapes (sequential mode,
        multilingual) hold ``_lock`` for the lifetime of the generator,
        so streaming consumers should drain promptly."""
        from faster_whisper_tpu_torch.audio import decode_audio
        from faster_whisper_tpu_torch.transcribe import BatchedInferencePipeline

        audio = decode_audio(io.BytesIO(payload))
        batch_size = options.pop("batch_size", 8)
        if self.batched and batch_size and not options.get("multilingual"):
            # off-lock: the shared batcher serializes only device batches
            pipeline = BatchedInferencePipeline(
                self.model, scheduler=self.batcher
            )
            return pipeline.transcribe(audio, batch_size=batch_size, **options)
        # lock-requiring shapes: the eager phase of transcribe() (features,
        # language detection) also touches the device, so take the lock
        # before the call and hold it until the generator is drained
        self._lock.acquire()
        try:
            if self.batched and batch_size:
                pipeline = BatchedInferencePipeline(self.model)
                segments, info = pipeline.transcribe(
                    audio, batch_size=batch_size, **options
                )
            else:
                segments, info = self.model.transcribe(audio, **options)
        except BaseException:
            self._lock.release()
            raise

        return _LockedDrain(segments, self._lock), info


class _LockedDrain:
    """Iterates ``segments`` and releases ``lock`` exactly once when the
    iteration finishes, errors, or the iterator is dropped (a plain
    generator's ``finally`` never runs if the generator is never
    started — that would leak the service lock and wedge the server)."""

    def __init__(self, segments, lock):
        self._segments = iter(segments)
        self._lock = lock
        self._released = False

    def _release(self):
        if not self._released:
            self._released = True
            self._lock.release()

    def __iter__(self):
        return self

    def __next__(self):
        if self._released:
            raise StopIteration
        try:
            return next(self._segments)
        except BaseException:
            self._release()
            raise

    def close(self):
        self._release()

    def __del__(self):
        self._release()


class _Handler(BaseHTTPRequestHandler):
    service: TranscriptionService = None  # set by serve()
    model_name: str = "?"

    # -- helpers ---------------------------------------------------------
    def _send_json(self, code, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code, text):
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", "text/plain; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):
        logger.info("%s " + fmt, self.address_string(), *args)

    # -- routes ----------------------------------------------------------
    def do_GET(self):
        path = urlparse(self.path).path
        if path in ("/healthz", "/health"):
            self._send_json(200, {"status": "ok", "model": self.model_name})
        elif path == "/metrics":
            body = self.service.metrics.render(self.service.batcher)
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(body.encode())))
            self.end_headers()
            self.wfile.write(body.encode())
        else:
            self._send_json(404, {"error": "not found"})

    def do_POST(self):
        path = urlparse(self.path).path
        if path not in ("/v1/audio/transcriptions", "/transcribe"):
            self._send_json(404, {"error": "not found"})
            return
        metrics = self.service.metrics
        try:
            payload, fields = self._read_request()
        except _TooLarge as exc:
            metrics.bad_request()
            self._send_json(413, {"error": str(exc)})
            return
        except Exception as exc:  # malformed multipart / body
            metrics.bad_request()
            self._send_json(400, {"error": f"bad request: {exc}"})
            return
        if not payload:
            metrics.bad_request()
            self._send_json(400, {"error": "no audio payload ('file' part)"})
            return

        options, response_format, stream = {}, "json", False
        try:
            for key, value in fields.items():
                if key == "response_format":
                    response_format = value
                elif key == "stream":
                    stream = _BOOL[str(value).lower()]
                elif key in _OPTION_PARSERS:
                    options[key] = _OPTION_PARSERS[key](value)
        except (KeyError, ValueError) as exc:
            metrics.bad_request()
            self._send_json(400, {"error": f"bad option value: {exc}"})
            return

        if stream:
            self._stream_response(payload, options, response_format)
            return

        metrics.start()
        t0 = time.perf_counter()
        try:
            segments, info = self.service.transcribe_bytes(payload, options)
        except Exception as exc:
            metrics.finish("error", time.perf_counter() - t0)
            logger.exception("transcription failed")
            self._send_json(500, {"error": str(exc)})
            return
        metrics.finish(
            "ok", time.perf_counter() - t0,
            audio_seconds=float(getattr(info, "duration", 0.0) or 0.0),
            n_segments=len(segments),
        )

        text = "".join(s.text for s in segments)
        if response_format == "text":
            self._send_text(200, text.strip())
            return
        verbose = response_format == "verbose_json"
        out = {"text": text.strip()}
        if verbose:
            out.update(
                task="transcribe",
                language=info.language,
                language_probability=info.language_probability,
                duration=info.duration,
                duration_after_vad=info.duration_after_vad,
            )
        out["segments"] = [_segment_dict(s, verbose) for s in segments]
        self._send_json(200, out)

    def _stream_response(self, payload, options, response_format):
        """Server-Sent Events: one ``transcript.segment`` event per
        segment as it is decoded, then ``transcript.text.done`` with the
        full text/info, then the ``[DONE]`` sentinel.  Transport errors
        after the 200 status can only be signalled in-band (a
        ``transcript.error`` event), as with any SSE stream."""
        verbose = response_format == "verbose_json"
        metrics = self.service.metrics
        metrics.start()
        t0 = time.perf_counter()
        try:
            segments, info = self.service.stream_bytes(payload, options)
        except Exception as exc:
            metrics.finish("error", time.perf_counter() - t0)
            logger.exception("transcription failed")
            self._send_json(500, {"error": str(exc)})
            return

        def emit(obj):
            self.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
            self.wfile.flush()

        texts = []
        status = "ok"
        try:
            # Header write inside the metrics try: a client that
            # disconnects before the 200 lands raises BrokenPipeError
            # here, and the finally below must still run finish() or
            # fwt_requests_in_flight leaks upward permanently.
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-store")
            self.send_header("Connection", "close")
            self.end_headers()
            try:
                for seg in segments:
                    texts.append(seg.text)
                    emit({
                        "type": "transcript.segment",
                        "segment": _segment_dict(seg, verbose),
                    })
            finally:
                close = getattr(segments, "close", None)
                if close is not None:
                    close()  # release the service lock on client abort
            done = {"type": "transcript.text.done",
                    "text": "".join(texts).strip()}
            if verbose:
                done.update(
                    language=info.language,
                    language_probability=info.language_probability,
                    duration=info.duration,
                    duration_after_vad=info.duration_after_vad,
                )
            emit(done)
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except BrokenPipeError:
            logger.info("SSE client disconnected mid-stream")
        except Exception as exc:
            status = "error"
            logger.exception("streaming transcription failed")
            try:
                emit({"type": "transcript.error", "error": str(exc)})
            except OSError:
                pass
        finally:
            metrics.finish(
                status, time.perf_counter() - t0,
                audio_seconds=float(getattr(info, "duration", 0.0) or 0.0),
                n_segments=len(texts),
            )

    max_body_bytes = 512 * 1024 * 1024  # reject larger uploads with 413

    def _read_request(self):
        """Returns (audio_bytes, option_fields) from multipart/form-data
        or a raw body with query-string options."""
        if "chunked" in self.headers.get("Transfer-Encoding", "").lower():
            raise ValueError(
                "chunked transfer encoding not supported; send "
                "Content-Length"
            )
        length = int(self.headers.get("Content-Length", 0))
        if length > self.max_body_bytes:
            raise _TooLarge(
                f"body of {length} bytes exceeds the "
                f"{self.max_body_bytes}-byte limit"
            )
        body = self.rfile.read(length)
        ctype = self.headers.get("Content-Type", "")
        if ctype.startswith("multipart/form-data"):
            parser = BytesParser(policy=policy.default)
            msg = parser.parsebytes(
                b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body
            )
            payload, fields = None, {}
            for part in msg.iter_parts():
                name = part.get_param(
                    "name", header="content-disposition"
                )
                if name == "file":
                    payload = part.get_payload(decode=True)
                elif name:
                    fields[name] = part.get_content().strip()
            return payload, fields
        # raw body + query-string options
        qs = parse_qs(urlparse(self.path).query)
        return body, {k: v[0] for k, v in qs.items()}


def serve(model, host="0.0.0.0", port=8000, model_name="?", batched=True):
    """Start the HTTP server (blocking).  Returns the server object when
    constructed with port=0 via ``make_server`` for tests."""
    server = make_server(model, host, port, model_name, batched)
    logger.info("serving %s on %s:%d", model_name, host, server.server_port)
    try:
        server.serve_forever()
    finally:
        server.server_close()


def make_server(model, host="127.0.0.1", port=0, model_name="?", batched=True):
    service = TranscriptionService(model, batched=batched)
    handler = type(
        "BoundHandler",
        (_Handler,),
        {"service": service, "model_name": model_name},
    )
    server = ThreadingHTTPServer((host, port), handler)
    server.service = service  # reachable for shutdown/metrics
    return server


def main(argv=None):
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="large-v3")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--compute-type", default="default")
    ap.add_argument("--num-mesh-devices", type=int, default=0,
                    help="mesh size in devices (0 = single device; more "
                    "than one: a data-parallel mesh, one model replica per "
                    "device, each batch split over them)")
    ap.add_argument("--tensor-parallel", type=int, default=1,
                    help="model-axis size of the mesh: each replica is "
                    "column/row-sharded over this many of the mesh's "
                    "devices (it must divide --num-mesh-devices and the "
                    "head counts)")
    ap.add_argument("--no-warm", action="store_true",
                    help="skip the startup warm (precompile.warm_parallel "
                    "builds the kernels, opens the CUDA context and runs "
                    "every batch bucket's encode and decode before the "
                    "port opens, so the first request does not pay them)")
    ap.add_argument("--warm-beam-size", type=int, default=5)
    ap.add_argument(
        "--warm-max-new-tokens", default="128,none",
        help="comma list of decode budgets to warm ('none' = the model's "
        "full context, what a request WITHOUT max_new_tokens decodes)")
    ap.add_argument("--warm-word-timestamps", action="store_true",
                    help="also warm the word-timestamp alignment pass")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    kwargs = {}
    if args.num_mesh_devices:
        kwargs["device_index"] = list(range(args.num_mesh_devices))
    if args.tensor_parallel > 1:
        kwargs["tensor_parallel"] = args.tensor_parallel
    model = WhisperModel(
        args.model, compute_type=args.compute_type, **kwargs
    )
    if not args.no_warm:
        from faster_whisper_tpu_torch.precompile import warm_parallel

        budgets = tuple(
            None if t.strip().lower() in ("none", "") else int(t)
            for t in str(args.warm_max_new_tokens).split(",")
            if t.strip() or t.strip().lower() == "none"
        )
        warm_parallel(
            model,
            durations_s=(30.0, 780.0),
            batch_size=8,
            beam_size=args.warm_beam_size,
            max_new_tokens=budgets or (128, None),
            word_timestamps=args.warm_word_timestamps,
            language="en",
            log=lambda m: logging.getLogger("faster_whisper").info(m),
        )
    serve(model, args.host, args.port, model_name=args.model)


if __name__ == "__main__":
    main()
