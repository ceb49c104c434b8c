"""The port stands alone: it runs where there is no JAX, no ``tokenizers``,
no ``regex``, no ``huggingface_hub``, no ``safetensors``, no
``transformers``, no PyAV, no ``tqdm``, no ``grpc``, no ``protobuf`` and no
JAX package.  A subprocess refuses those imports with a meta-path finder,
imports every module of ``faster_whisper_tpu_torch`` but the gRPC server
and its generated messages (whose import must then raise ``ImportError``)
and ``chip_smoke``, serves one request through the HTTP server after its
startup warm, runs a tiny transcribe and
a tiny batched transcribe of ``docker/jfk.flac`` (decoded by the port's
native FLAC decoder, built from its own ``csrc/flac_decoder.cpp``, VAD
on, with word timestamps through the native DTW of ``csrc/dtw.cpp``) on
the CPU, loads a CTranslate2 and an HF directory written by the
port with their ``tokenizer.json`` through ``WhisperModel(directory)``,
and checks that the card is the default device.  A second test reads the
sources for such imports: only the gRPC server imports ``grpc`` and only
its generated messages ``google.protobuf``.  scipy, which resamples in ``decode_audio``, is
imported there lazily and is installed wherever the port runs."""

import ast
import os
import subprocess
import sys
import textwrap

import jax  # noqa: F401  (test files import both frameworks)
import torch  # noqa: F401

# Imported while every xdist worker collects the suite, before any test
# runs: the module fixture of tests/test_reference_parity.py leaves a stub
# ``onnxruntime`` without ``__spec__`` in sys.modules, and a first import of
# torch._dynamo after it (through transformers' generate, in
# tests/test_hf_*_parity.py on the same worker) raises (ROADMAP.md, Queue 3).
import torch._dynamo  # noqa: F401,E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "faster_whisper_tpu_torch")
BLOCKED = (
    "jax", "jaxlib", "tokenizers", "regex", "huggingface_hub", "safetensors", "transformers",
    "av", "tqdm", "faster_whisper_tpu",
)
# The card's machine has neither: the modules that need them are imported
# by nothing else of the port.
GRPC = ("grpc", "google.protobuf")
GRPC_MODULES = {
    "faster_whisper_tpu_torch.grpc_server": "grpc",
    "faster_whisper_tpu_torch.protos.transcription_pb2": "google.protobuf",
}


def _blocked(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


CHILD = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = %r

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError("refused import of " + name)
            return None

    sys.meta_path.insert(0, Refuse())

    import numpy as np
    import torch
    import faster_whisper_tpu_torch as pkg
    import chip_smoke  # its __main__ is guarded: importing runs nothing

    GRPC_MODULES = %r
    for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        if mod.name not in GRPC_MODULES:
            importlib.import_module(mod.name)
    for name in GRPC_MODULES:
        try:
            importlib.import_module(name)
        except ImportError as e:
            assert "refused import" in str(e), e
        else:
            raise AssertionError(name + " imported without grpc and protobuf")

    from faster_whisper_tpu_torch import (
        BatchedInferencePipeline, WhisperModel, decode_audio, format_timestamp,
    )
    from faster_whisper_tpu_torch.models.config import tiny_test_config
    from faster_whisper_tpu_torch.models.load import random_params
    from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer

    cfg = tiny_test_config()
    params = random_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    model = WhisperModel.from_parts(
        params, cfg, build_synthetic_tokenizer(), compute_type="float32", device="cpu"
    )
    audio = chip_smoke.synth_audio(8.0, seed=0)
    segments, info = model.transcribe(audio, beam_size=2, temperature=0.0, max_new_tokens=16)
    segments = list(segments)
    assert info.language in model.supported_languages
    print("segments", len(segments), format_timestamp(info.duration))

    import io, json, threading, urllib.request, wave
    from faster_whisper_tpu_torch.precompile import warm_parallel
    from faster_whisper_tpu_torch.server import make_server

    assert warm_parallel(model, durations_s=(30.0,), batch_size=2, beam_size=2,
                         max_new_tokens=8) == []
    server = make_server(model, model_name="micro")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = "http://127.0.0.1:%%d" %% server.server_port
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1); w.setsampwidth(2); w.setframerate(16000)
        w.writeframes((audio[: 16000 * 3] * 32767).astype(np.int16).tobytes())
    req = urllib.request.Request(
        url + "/v1/audio/transcriptions?language=en&beam_size=2&max_new_tokens=8&vad_filter=false",
        data=buf.getvalue(), headers={"Content-Type": "audio/wav"})
    body = json.load(urllib.request.urlopen(req))
    assert "segments" in body and server.service.batcher.chunks_processed == 1, body
    server.shutdown(); server.service.close()
    print("served", len(body["segments"]))

    speech = decode_audio("docker/jfk.flac")
    segments, info = BatchedInferencePipeline(model).transcribe(
        speech, batch_size=2, beam_size=2, max_new_tokens=8, word_timestamps=True,
        suppress_tokens=[-1] + list(range(257, 1865)),  # text, not the micro vocabulary's specials
    )
    segments = list(segments)
    assert segments and 0 < info.duration_after_vad <= info.duration == 11.0
    assert all(s.words is not None for s in segments) and any(s.words for s in segments)
    print("batched segments", len(segments), info.language)

    import os, tempfile
    from faster_whisper_tpu_torch.ops import _build
    from faster_whisper_tpu_torch.testing import (
        tokenizer_json, word_merges, write_ct2_dir, write_hf_dir,
    )

    flac_lib = str(_build.library_path("flac_decoder.cpp"))
    maps = open("/proc/self/maps").read()
    assert flac_lib in maps and "libfwt_flac" not in maps, flac_lib
    dtw_lib = str(_build.library_path("dtw.cpp"))
    assert dtw_lib in maps and "libfwt_dtw" not in maps, dtw_lib
    assert _build.CSRC_DIR.parent.name == "faster_whisper_tpu_torch"

    tok = tokenizer_json(512, word_merges([" ask", " not", " what"]))
    cfg = tiny_test_config(n_vocab=512 + 1609)
    params = random_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        for kind in ("ct2", "hf"):
            path = os.path.join(tmp, kind)
            if kind == "ct2":
                write_ct2_dir(path, params, cfg, tok, weights="int8_float16")
            else:
                write_hf_dir(path, params, cfg, tok)
            model = WhisperModel(path, device="cpu", compute_type="int8_float32")
            segments, info = model.transcribe(audio, beam_size=2, max_new_tokens=8,
                                              initial_prompt=" ask not what")
            print(kind, "directory segments", len(list(segments)))
            try:
                WhisperModel(path)
            except RuntimeError as e:
                assert "cuda" in str(e).lower(), e
            else:
                raise AssertionError("WhisperModel(directory) ran without a card")

    assert not torch.cuda.is_available()
    try:
        WhisperModel.from_parts(params, cfg, build_synthetic_tokenizer())
    except RuntimeError as e:
        assert "cuda" in str(e).lower(), e
    else:
        raise AssertionError("from_parts without device= ran without a card")

    loaded = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
    assert not loaded, loaded
    print("ISOLATED-OK")
    """
)


def test_port_runs_without_jax_tokenizers_or_the_jax_package():
    # one intra-op thread, as the other port tests run (test_torch_vad.py)
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD % (BLOCKED + GRPC, GRPC_MODULES)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0 and "ISOLATED-OK" in proc.stdout, (
        proc.stdout[-3000:] + proc.stderr[-3000:]
    )


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_sources_import_nothing_of_jax_or_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PACKAGE):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    bad = [(f, m) for f in files for m in _imports(f) if _blocked(m)]
    assert not bad, bad
    # grpc and protobuf only where the gRPC server needs them
    allowed = {os.path.join(ROOT, *name.split(".")) + ".py": lib for name, lib in GRPC_MODULES.items()}
    grpc = {
        (f, g) for f in files for m in _imports(f) for g in GRPC
        if m == g or m.startswith(g + ".")
    }
    assert grpc == set(allowed.items()), grpc
    # the prefix trap: the port's own name starts with the JAX package's
    assert not _blocked("faster_whisper_tpu_torch")
    assert _blocked("faster_whisper_tpu") and _blocked("faster_whisper_tpu.models")
