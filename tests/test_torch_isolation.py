"""The port stands alone: it runs where there is no JAX, no ``tokenizers``,
no ``huggingface_hub``, no PyAV and no JAX package.  A subprocess refuses those imports with a meta-path finder,
imports every module of ``faster_whisper_tpu_torch`` and ``chip_smoke``,
runs a tiny transcribe on the CPU, and checks that the card is the default
device.  A second test reads the sources for such imports."""

import ast
import os
import subprocess
import sys
import textwrap

import jax  # noqa: F401  (test files import both frameworks)
import torch  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "faster_whisper_tpu_torch")
BLOCKED = ("jax", "jaxlib", "tokenizers", "huggingface_hub", "av", "faster_whisper_tpu")


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

    for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(mod.name)

    from faster_whisper_tpu_torch import WhisperModel, format_timestamp
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
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD % (BLOCKED,)],
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
    # the prefix trap: the port's own name starts with the JAX package's
    assert not _blocked("faster_whisper_tpu_torch")
    assert _blocked("faster_whisper_tpu") and _blocked("faster_whisper_tpu.models")
