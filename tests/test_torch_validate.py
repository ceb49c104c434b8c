"""The port's acceptance gate (``validate.py``) and offline warm CLI
(``precompile.main``) on the host.

The gate in ``--mock`` mode over the float32 micro model, built on the
CPU from the JAX package's ``random_params`` (seed 0), the weights of the
JAX gate's own mock model, carried across with ``params_from_jax``:
``testing.build_test_model`` is patched to it, the CPU test's way to the
host (the gate has no device flag, as the JAX gate has none).  The data
directory holds a copy of ``docker/jfk.flac`` only, so of the four checks
asked for, two pass and two skip (no ``hotwords.mp3``, no LibriSpeech
directory).  The gate's checks, their names and their order are the JAX
gate's.

The warm CLI builds the micro model with random weights on the CPU
(``precompile.build_model`` patched to ``device="cpu"``) at its default
compute type, int8, and prints the JAX package's report keys."""

import ast
import contextlib
import functools
import io
import json
import os
import shutil

import numpy as np
import pytest

import jax
import torch

import faster_whisper_tpu.precompile as jax_precompile
import faster_whisper_tpu.validate as jax_validate
import faster_whisper_tpu_torch.precompile as port_precompile
import faster_whisper_tpu_torch.testing as port_testing
import faster_whisper_tpu_torch.validate as port_validate
from faster_whisper_tpu.models.config import tiny_test_config as jax_config
from faster_whisper_tpu.models.load import random_params as jax_random_params
from faster_whisper_tpu_torch.models.config import tiny_test_config
from faster_whisper_tpu_torch.models.load import params_from_jax
from faster_whisper_tpu_torch.transcribe import WhisperModel

JFK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docker", "jfk.flac")
CHECKS = "jfk sequential + words,jfk batched,hotwords,librispeech wer"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's many small CPU ops: under the
    suite's parallel workers, more threads wait at every op's barrier for
    cores that the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def data_dir(tmp_path):
    shutil.copy(JFK, tmp_path / "jfk.flac")
    return str(tmp_path)


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _check_names(module, monkeypatch, data_dir):
    """The names of a gate's checks, in order, read off ``Gate.run``
    without running them."""
    names = []
    monkeypatch.setattr(module.Gate, "run", lambda self, name, fn: (
        names.append(name), self.results.append((name, "SKIP", "")))
    )
    testing = port_testing if module is port_validate else __import__(
        "faster_whisper_tpu.testing", fromlist=["build_test_model"]
    )
    monkeypatch.setattr(testing, "build_test_model", lambda: None)
    rc, out, _ = _run(module.main, ["--mock", "--data-dir", data_dir])
    monkeypatch.undo()
    assert rc == 0 and json.loads(out.splitlines()[-1])["skip"] == len(names)
    return names


def test_gate_checks_are_the_jax_gates(monkeypatch, data_dir):
    ours = _check_names(port_validate, monkeypatch, data_dir)
    assert ours == _check_names(jax_validate, monkeypatch, data_dir)
    assert len(ours) == 9 and ours[0] == "jfk sequential + words"


def test_mock_gate_passes_on_the_host(monkeypatch, data_dir):
    weights = jax_random_params(jax_config(), seed=0, dtype="float32")

    def build_test_model():
        return WhisperModel.from_parts(
            params_from_jax(jax.tree.map(np.asarray, weights), device="cpu"),
            tiny_test_config(),
            port_testing.build_synthetic_tokenizer(),
            compute_type="float32",
            device="cpu",
        )

    monkeypatch.setattr(port_testing, "build_test_model", build_test_model)
    rc, out, err = _run(port_validate.main, ["--mock", "--data-dir", data_dir, "--checks", CHECKS])
    assert rc == 0, err
    assert json.loads(out.splitlines()[-1]) == {
        "mode": "mock", "model": "tiny", "pass": 2, "fail": 0, "skip": 2,
    }
    table = {line.split("  ")[0].strip(): line for line in err.strip().splitlines()}
    assert list(table) == CHECKS.split(",")
    assert "SKIP  hotwords.mp3 not available" in table["hotwords"]
    assert "PASS" in table["jfk batched"] and "segments" in table["jfk batched"]


def test_gate_without_jfk_exits_2(monkeypatch, tmp_path):
    monkeypatch.setattr(port_testing, "build_test_model", lambda: None)
    rc, out, err = _run(port_validate.main, ["--mock", "--data-dir", str(tmp_path)])
    assert rc == 2 and out == "" and "jfk.flac not found" in err


def _report_keys(module):
    """The keys of the dict literal that ``main`` prints as ``report``."""
    tree = ast.parse(open(module.__file__).read())
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Assign)
            and getattr(node.targets[0], "id", None) == "report"
            and isinstance(node.value, ast.Dict)
        ):
            return [k.value for k in node.value.keys]
    raise AssertionError(f"no report dict in {module.__file__}")


def test_warm_cli_on_the_host(monkeypatch):
    monkeypatch.setattr(
        port_precompile, "build_model", functools.partial(port_precompile.build_model, device="cpu")
    )
    argv = ["--random-weights", "--model", "test-micro", "--batch-size", "2",
            "--max-new-tokens", "8", "--language", "en"]
    rc, out, err = _run(port_precompile.main, argv)
    assert rc == 0
    report = json.loads(out.splitlines()[-1])
    assert list(report) == _report_keys(jax_precompile) == _report_keys(port_precompile)
    assert report["model"] == "test-micro" and report["compute_type"] == "int8"
    assert report["batch_size"] == 2 and report["max_new_tokens"] == 8
    assert list(report["phases"]) == ["load", "batched pipeline (beam)"]
    assert report["new_programs_cached"] == report["cache_entries_after"] - report["cache_entries_before"]
    assert report["persistent_cache_dir"].endswith(os.path.join("build", "torch_kernels"))
    assert "# batched pipeline (beam): " in err
