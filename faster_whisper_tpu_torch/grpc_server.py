"""gRPC transcription service (the HTTP server's RPC twin).

Counterpart of ``faster_whisper_tpu/grpc_server.py``: the same service
(``fwt.Transcription``), messages and status codes, so a client of either
package talks to a server of the other.  It shares
``TranscriptionService`` (and therefore the process-wide
ContinuousBatcher: concurrent Transcribe calls merge into shared device
batches) with the HTTP server.

Service definition: ``protos/transcription.proto``; ``transcription_pb2.py``
is the JAX package's generated module, copied byte for byte, so that both
copies can load into one process and share one descriptor.  The service
layer is hand-rolled on grpc's generic-handler API.  This module needs
``grpcio`` and ``protobuf``; nothing else of the package imports it.

RPCs:
  Transcribe        -> whole-result response
  TranscribeStream  -> server stream: info, one event per segment AS
                       DECODED (the pipeline is a generator), done_text
  Health            -> liveness + model name

Run:  python -m faster_whisper_tpu_torch.grpc_server --model <model dir> --port 50051
"""

import argparse
import logging
from concurrent import futures

import grpc

from faster_whisper_tpu_torch.protos import transcription_pb2 as pb

logger = logging.getLogger("faster_whisper_tpu_torch.grpc_server")

_SERVICE = "fwt.Transcription"


def _options_from_request(req: pb.TranscribeRequest) -> dict:
    """Proto -> transcribe() kwargs; proto3 zero-values mean 'default'."""
    options = {}
    if req.language:
        options["language"] = req.language
    if req.task:
        options["task"] = req.task
    if req.beam_size:
        options["beam_size"] = req.beam_size
    if req.temperature:
        options["temperature"] = list(req.temperature)
    if req.word_timestamps:
        options["word_timestamps"] = True
    options["vad_filter"] = bool(req.vad_filter)
    if req.initial_prompt:
        options["initial_prompt"] = req.initial_prompt
    if req.hotwords:
        options["hotwords"] = req.hotwords
    if req.max_new_tokens:
        options["max_new_tokens"] = req.max_new_tokens
    if req.without_timestamps:
        options["without_timestamps"] = True
    if req.prefix:
        options["prefix"] = req.prefix
    if req.multilingual:
        options["multilingual"] = True
    # proto3 bools default to false while the library defaults this
    # option ON, so the wire field is inverted (see the .proto comment)
    if req.no_condition_on_previous_text:
        options["condition_on_previous_text"] = False
    options["batch_size"] = 0 if req.sequential else (req.batch_size or 8)
    return options


def _segment_msg(seg, verbose: bool) -> pb.Segment:
    msg = pb.Segment(
        id=seg.id, seek=seg.seek, start=seg.start, end=seg.end, text=seg.text
    )
    if verbose:
        msg.tokens.extend(seg.tokens)
        msg.temperature = seg.temperature or 0.0
        msg.avg_logprob = seg.avg_logprob
        msg.compression_ratio = seg.compression_ratio
        msg.no_speech_prob = seg.no_speech_prob
        if seg.words:
            msg.words.extend(
                pb.Word(
                    start=w.start, end=w.end, word=w.word,
                    probability=w.probability,
                )
                for w in seg.words
            )
    return msg


def _info_msg(info) -> pb.TranscriptionInfo:
    return pb.TranscriptionInfo(
        language=info.language,
        language_probability=info.language_probability,
        duration=info.duration,
        duration_after_vad=info.duration_after_vad,
    )


class TranscriptionServicer:
    """Handlers bound through grpc.method_handlers_generic_handler."""

    def __init__(self, service, model_name: str = "?"):
        self.service = service  # faster_whisper_tpu_torch.server.TranscriptionService
        self.model_name = model_name

    # -- RPCs -------------------------------------------------------------
    def Transcribe(self, request, context):
        try:
            segments, info = self.service.transcribe_bytes(
                bytes(request.audio), _options_from_request(request)
            )
        except Exception as exc:  # noqa: BLE001 — map to RPC status
            logger.exception("transcription failed")
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))
        return pb.TranscribeResponse(
            info=_info_msg(info),
            segments=[_segment_msg(s, request.verbose) for s in segments],
            text="".join(s.text for s in segments).strip(),
        )

    def TranscribeStream(self, request, context):
        try:
            segments, info = self.service.stream_bytes(
                bytes(request.audio), _options_from_request(request)
            )
        except Exception as exc:  # noqa: BLE001
            logger.exception("transcription failed")
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(exc))
            return
        yield pb.StreamEvent(info=_info_msg(info))
        texts = []
        try:
            for seg in segments:
                texts.append(seg.text)
                yield pb.StreamEvent(segment=_segment_msg(seg, request.verbose))
        finally:
            close = getattr(segments, "close", None)
            if close is not None:
                close()  # release the service lock on client cancel
        yield pb.StreamEvent(done_text="".join(texts).strip())

    def Health(self, request, context):
        return pb.HealthResponse(status="ok", model=self.model_name)


def _handlers(servicer: TranscriptionServicer):
    return grpc.method_handlers_generic_handler(
        _SERVICE,
        {
            "Transcribe": grpc.unary_unary_rpc_method_handler(
                servicer.Transcribe,
                request_deserializer=pb.TranscribeRequest.FromString,
                response_serializer=pb.TranscribeResponse.SerializeToString,
            ),
            "TranscribeStream": grpc.unary_stream_rpc_method_handler(
                servicer.TranscribeStream,
                request_deserializer=pb.TranscribeRequest.FromString,
                response_serializer=pb.StreamEvent.SerializeToString,
            ),
            "Health": grpc.unary_unary_rpc_method_handler(
                servicer.Health,
                request_deserializer=pb.HealthRequest.FromString,
                response_serializer=pb.HealthResponse.SerializeToString,
            ),
        },
    )


def make_server(
    model, host="127.0.0.1", port=0, model_name="?", batched=True,
    max_workers=8, max_message_mb=512,
):
    """Build (server, bound_port).  port=0 binds an ephemeral port."""
    from faster_whisper_tpu_torch.server import TranscriptionService

    service = TranscriptionService(model, batched=batched)
    servicer = TranscriptionServicer(service, model_name=model_name)
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=[
            ("grpc.max_receive_message_length", max_message_mb * 1024 * 1024),
            ("grpc.max_send_message_length", max_message_mb * 1024 * 1024),
        ],
    )
    server.add_generic_rpc_handlers((_handlers(servicer),))
    bound = server.add_insecure_port(f"{host}:{port}")
    server.service = service  # for shutdown in tests/embedders
    return server, bound


class TranscriptionClient:
    """Thin typed client over a channel (plugin-less stub equivalent)."""

    def __init__(self, target_or_channel):
        if isinstance(target_or_channel, str):
            self._channel = grpc.insecure_channel(target_or_channel)
        else:
            self._channel = target_or_channel
        u = self._channel.unary_unary
        s = self._channel.unary_stream
        self.transcribe = u(
            f"/{_SERVICE}/Transcribe",
            request_serializer=pb.TranscribeRequest.SerializeToString,
            response_deserializer=pb.TranscribeResponse.FromString,
        )
        self.transcribe_stream = s(
            f"/{_SERVICE}/TranscribeStream",
            request_serializer=pb.TranscribeRequest.SerializeToString,
            response_deserializer=pb.StreamEvent.FromString,
        )
        self.health = u(
            f"/{_SERVICE}/Health",
            request_serializer=pb.HealthRequest.SerializeToString,
            response_deserializer=pb.HealthResponse.FromString,
        )

    def close(self):
        self._channel.close()


def main(argv=None):
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="large-v3")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=50051)
    ap.add_argument("--compute-type", default="default")
    ap.add_argument("--max-workers", type=int, default=8)
    ap.add_argument("--no-warm", action="store_true",
                    help="skip the startup warm (precompile.warm_parallel)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    model = WhisperModel(args.model, compute_type=args.compute_type)
    if not args.no_warm:
        from faster_whisper_tpu_torch.precompile import warm_parallel

        warm_parallel(
            model, durations_s=(30.0, 780.0), batch_size=8, beam_size=5,
            max_new_tokens=(128, None),  # None = the default request's length
            language="en",
            log=lambda m: logger.info(m),
        )
    server, bound = make_server(
        model, args.host, args.port, model_name=args.model,
        max_workers=args.max_workers,
    )
    server.start()
    logger.info("gRPC serving %s on %s:%d", args.model, args.host, bound)
    server.wait_for_termination()


if __name__ == "__main__":
    main()
