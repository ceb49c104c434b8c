"""``precompile.warm_parallel`` of the port on the float32 micro model on
the CPU: it builds the host libraries, runs every piece of the serving
path once on zero-filled inputs (one encode and beam decode per batch
bucket and decode budget, the VAD, the chunked log-mel, the alignment
pass), returns no failures, stamps each piece through ``log``, and leaves
the decode's outputs unchanged.  A piece that fails is returned with its
exception and does not stop the others, as in the JAX package."""

import numpy as np
import pytest

import torch

from faster_whisper_tpu_torch import BatchedInferencePipeline, WhisperModel
from faster_whisper_tpu_torch.models.config import tiny_test_config
from faster_whisper_tpu_torch.models.load import random_params
from faster_whisper_tpu_torch.precompile import warm_parallel
from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer

WARM = dict(durations_s=(30.0, 65.0), batch_size=4, beam_size=2, max_new_tokens=(16, None),
            language="en", word_timestamps=True)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's many small CPU ops (see
    test_torch_batched.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config()
    params = random_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    return WhisperModel.from_parts(
        params, cfg, build_synthetic_tokenizer(), compute_type="float32", device="cpu"
    )


def transcribe(model):
    segments, _ = BatchedInferencePipeline(model).transcribe(
        np.sin(np.arange(16000 * 12) * 0.05).astype(np.float32),
        language="en", beam_size=2, batch_size=4, max_new_tokens=16, vad_filter=False,
        word_timestamps=True,
    )
    return [(s.text, s.tokens, s.start, s.end, s.avg_logprob, s.words) for s in segments]


def test_warm_parallel_returns_no_failures_and_leaves_outputs_unchanged(model, monkeypatch):
    before = transcribe(model)
    generated = []
    generate = model.model.generate

    def spy(xa, prompts, **kwargs):
        generated.append((tuple(xa.shape), len(prompts), kwargs["max_length"], kwargs["beam_size"]))
        return generate(xa, prompts, **kwargs)

    monkeypatch.setattr(model.model, "generate", spy)
    log = []
    failures = warm_parallel(model, log=log.append, **WARM)
    assert failures == []
    # every batch bucket (1, 2, 4) at both budgets: the prompt's 4 tokens
    # (sot, language, task, no timestamps) plus 16, and the model's full 448
    assert sorted((s[0], n, m, b) for s, n, m, b in generated) == sorted(
        (b, b, m, 2) for b in (1, 2, 4) for m in (20, 448)
    )
    names = " ".join(log)
    for piece in ("build native libraries", "establish", "vad", "mel",
                  "encode+beam B=1", "encode+beam B=2", "encode+beam B=4", "warm_parallel total"):
        assert piece in names, (piece, log)
    monkeypatch.undo()
    assert transcribe(model) == before


def test_a_failing_piece_is_returned_and_the_others_run(model, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("no alignment")

    monkeypatch.setattr(model.model, "align", broken)
    log = []
    failures = warm_parallel(model, log=log.append, **WARM)
    assert sorted(name for name, _ in failures) == ["encode+beam B=1", "encode+beam B=2", "encode+beam B=4"]
    assert all("no alignment" in why for _, why in failures)
    assert any("vad:" in m for m in log) and any("FAILED" in m for m in log)
