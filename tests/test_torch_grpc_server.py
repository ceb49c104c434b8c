"""The port's gRPC server (``grpc_server.py``) against the JAX package's, on
the same float32 micro model: the JAX ``tests/test_grpc_server.py`` cases,
each call made to both servers, and across the packages (a JAX
``TranscriptionClient`` against the port's server, the port's client
against the JAX server: one service, ``fwt.Transcription``).

The responses must be equal: texts, infos, segment ids, seeks, tokens,
texts and start/end exactly, ``avg_logprob`` within 1e-4 and
``no_speech_prob`` within 1e-5 (float32 on the wire).  Both copies of
``transcription_pb2`` load into one process and share one descriptor.
Sequential requests ask for temperature 0: a fallback to sampling draws
from each framework's own RNG.  The JAX side runs with
FWT_CACHE_ARTIFACTS=/nonexistent."""

import inspect
import io
import os
import wave

import numpy as np
import pytest

grpc = pytest.importorskip("grpc")

import jax  # noqa: E402
import torch  # noqa: E402

import faster_whisper_tpu.grpc_server as jax_grpc_server  # noqa: E402
import faster_whisper_tpu_torch.grpc_server as port_grpc_server  # noqa: E402
from faster_whisper_tpu.grpc_server import TranscriptionClient as JaxClient  # noqa: E402
from faster_whisper_tpu.grpc_server import _options_from_request as jax_options  # noqa: E402
from faster_whisper_tpu.grpc_server import make_server as jax_make_server  # noqa: E402
from faster_whisper_tpu.models.config import tiny_test_config as jax_config  # noqa: E402
from faster_whisper_tpu.models.load import random_params as jax_random_params  # noqa: E402
from faster_whisper_tpu.protos import transcription_pb2 as jax_pb  # noqa: E402
from faster_whisper_tpu.testing import build_synthetic_tokenizer as jax_tokenizer  # noqa: E402
from faster_whisper_tpu.transcribe import WhisperModel as JaxWhisperModel  # noqa: E402
from faster_whisper_tpu_torch import WhisperModel  # noqa: E402
from faster_whisper_tpu_torch.grpc_server import (  # noqa: E402
    TranscriptionClient,
    _options_from_request,
    make_server,
)
from faster_whisper_tpu_torch.models.config import tiny_test_config  # noqa: E402
from faster_whisper_tpu_torch.models.load import params_from_jax  # noqa: E402
from faster_whisper_tpu_torch.protos import transcription_pb2 as pb  # noqa: E402
from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


@pytest.fixture(scope="module")
def targets():
    """(port target, JAX target) on the same weights."""
    weights = jax_random_params(jax_config(), seed=0, dtype="float32")
    jm = JaxWhisperModel.from_parts(weights, jax_config(), jax_tokenizer())
    pm = WhisperModel.from_parts(
        params_from_jax(jax.tree.map(np.asarray, weights), device="cpu"),
        tiny_test_config(), build_synthetic_tokenizer(), compute_type="float32", device="cpu",
    )
    servers = [make_server(pm, model_name="test-tiny"), jax_make_server(jm, model_name="test-tiny")]
    for server, _ in servers:
        server.start()
    yield tuple(f"127.0.0.1:{port}" for _, port in servers)
    for server, _ in servers:
        server.stop(grace=None)
        server.service.close()


@pytest.fixture(scope="module")
def clients(targets):
    """(port client -> port server, JAX client -> JAX server)."""
    cs = (TranscriptionClient(targets[0]), JaxClient(targets[1]))
    yield cs
    for c in cs:
        c.close()


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


def assert_segments_equal(ours, ref):
    assert len(ours) == len(ref)
    for s, r in zip(ours, ref):
        assert (s.id, s.seek, s.start, s.end, s.text, list(s.tokens)) == (
            r.id, r.seek, r.start, r.end, r.text, list(r.tokens)
        )
        assert s.avg_logprob == pytest.approx(r.avg_logprob, abs=LOGPROB_TOL)
        assert s.no_speech_prob == pytest.approx(r.no_speech_prob, abs=NO_SPEECH_TOL)
        assert s.compression_ratio == pytest.approx(r.compression_ratio)
        assert s.temperature == r.temperature
        assert len(s.words) == len(r.words)


def assert_response_equal(ours, ref):
    assert ours.text == ref.text
    assert ours.info == ref.info
    assert_segments_equal(ours.segments, ref.segments)


def test_both_transcription_pb2_copies_share_one_descriptor():
    assert pb is not jax_pb
    assert pb.DESCRIPTOR is jax_pb.DESCRIPTOR
    assert pb.DESCRIPTOR.serialized_pb == jax_pb.DESCRIPTOR.serialized_pb
    assert pb.TranscribeRequest is jax_pb.TranscribeRequest
    with open(os.path.join(ROOT, "faster_whisper_tpu_torch", "protos", "transcription_pb2.py"), "rb") as f:
        ours = f.read()
    with open(os.path.join(ROOT, "faster_whisper_tpu", "protos", "transcription_pb2.py"), "rb") as f:
        assert ours == f.read()
    assert [s.full_name for s in pb.DESCRIPTOR.services_by_name.values()] == ["fwt.Transcription"]


def test_health(clients):
    for c in clients:
        resp = c.health(pb.HealthRequest())
        assert (resp.status, resp.model) == ("ok", "test-tiny")


def test_transcribe_unary(clients):
    req = pb.TranscribeRequest(audio=_wav_bytes(), language="en", beam_size=2, batch_size=2, verbose=True)
    ours, ref = (c.transcribe(req) for c in clients)
    assert ours.info.language == "en"
    assert ours.info.duration > 0
    assert len(ours.segments) >= 1
    for seg in ours.segments:
        assert seg.end >= seg.start
        assert list(seg.tokens)  # verbose populates tokens
    assert ours.text == "".join(s.text for s in ours.segments).strip()
    assert_response_equal(ours, ref)


def test_transcribe_stream_matches_unary(clients):
    req = pb.TranscribeRequest(audio=_wav_bytes(seed=1), language="en", beam_size=2, batch_size=2)
    streams = []
    for c in clients:
        unary = c.transcribe(req)
        events = list(c.transcribe_stream(req))
        assert events[0].WhichOneof("event") == "info"
        assert events[0].info.language == unary.info.language
        assert events[-1].WhichOneof("event") == "done_text"
        assert events[-1].done_text == unary.text
        assert all(e.WhichOneof("event") == "segment" for e in events[1:-1])
        segs = [e.segment for e in events[1:-1]]
        assert [(s.start, s.end, s.text) for s in segs] == [
            (s.start, s.end, s.text) for s in unary.segments
        ]
        streams.append(events)
    ours, ref = streams
    assert ours[0] == ref[0] and ours[-1] == ref[-1]
    assert_segments_equal([e.segment for e in ours[1:-1]], [e.segment for e in ref[1:-1]])


def test_transcribe_stream_sequential_releases_lock(clients):
    """sequential=true streams under the service lock; back-to-back calls
    do not deadlock."""
    req = pb.TranscribeRequest(
        audio=_wav_bytes(seed=2), language="en", beam_size=1, sequential=True, temperature=[0.0]
    )
    done = []
    for c in clients:
        for _ in range(2):
            events = list(c.transcribe_stream(req))
            assert events[-1].WhichOneof("event") == "done_text"
            done.append(events[-1].done_text)
    assert len(set(done)) == 1


def test_bad_audio_is_invalid_argument(clients):
    for c in clients:
        with pytest.raises(grpc.RpcError) as exc_info:
            c.transcribe(pb.TranscribeRequest(audio=b"not audio at all"))
        assert exc_info.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_clients_and_servers_of_both_packages_talk(targets):
    """A JAX client against the port's server and the port's client
    against the JAX server: the same responses as each package's own."""
    req = pb.TranscribeRequest(audio=_wav_bytes(seed=4), language="en", beam_size=2, batch_size=2,
                               verbose=True)
    jax_to_port, port_to_jax = JaxClient(targets[0]), TranscriptionClient(targets[1])
    port_to_port = TranscriptionClient(targets[0])
    try:
        assert jax_to_port.health(jax_pb.HealthRequest()).model == "test-tiny"
        a, b = jax_to_port.transcribe(req), port_to_jax.transcribe(req)
        assert a == port_to_port.transcribe(req)
        assert_response_equal(a, b)
    finally:
        for c in (jax_to_port, port_to_jax, port_to_port):
            c.close()


def test_options_mapping():
    full = pb.TranscribeRequest(
        language="fr", task="translate", beam_size=3,
        temperature=[0.0, 0.5], word_timestamps=True, vad_filter=True,
        initial_prompt="bonjour", hotwords="jax tpu", max_new_tokens=64,
        without_timestamps=True, prefix="le", multilingual=True,
        no_condition_on_previous_text=True, batch_size=4,
    )
    opts = _options_from_request(full)
    assert opts == {
        "language": "fr", "task": "translate", "beam_size": 3,
        "temperature": [0.0, 0.5], "word_timestamps": True,
        "vad_filter": True, "initial_prompt": "bonjour",
        "hotwords": "jax tpu", "max_new_tokens": 64,
        "without_timestamps": True, "prefix": "le", "multilingual": True,
        "condition_on_previous_text": False, "batch_size": 4,
    }
    # proto zero-values fall through to library defaults
    defaults = _options_from_request(pb.TranscribeRequest())
    assert defaults == {"vad_filter": False, "batch_size": 8}
    # sequential forces the seek-loop path
    seq = _options_from_request(pb.TranscribeRequest(sequential=True))
    assert seq["batch_size"] == 0
    for req in (full, pb.TranscribeRequest(), pb.TranscribeRequest(sequential=True)):
        assert _options_from_request(req) == jax_options(req)


@pytest.mark.parametrize(
    "name", ["make_server", "TranscriptionServicer.__init__", "TranscriptionClient.__init__"]
)
def test_signature_matches_jax(name):
    def params(module):
        obj = module
        for part in name.split("."):
            obj = getattr(obj, part)
        return [(p.name, p.kind, p.default) for p in inspect.signature(obj).parameters.values()]

    assert params(port_grpc_server) == params(jax_grpc_server)


def test_command_line_matches_jax(monkeypatch):
    from test_torch_signatures import command_line

    want = command_line(jax_grpc_server, monkeypatch)
    assert len(want) > 5
    assert command_line(port_grpc_server, monkeypatch) == want
