"""The port's spans (``faster_whisper_tpu_torch/tracing.py``) on the host.

Off, a span reads no clock and counts nothing.  On, over a batched
transcribe of the micro model (``docker/jfk.flac`` tiled, three chunks in
batches of two) at bf16 and at int8, in beam search and in sampling: the
decoder steps that ``fwt.decode.step`` counts are the
``_gen_decoder_step.calls`` delta, the stop read and the logits head count
one per step (the sampling loop reads its stop once more before it ends),
every W8A8 product is one ``fwt.int8_dense`` (8 a decoder layer and step
plus the head, 10 a decoder layer and the head in a prefill, 6 an encoder
layer in an encode), and the segments are bit-equal to those of a run with the
spans off.  Under ``torch.profiler`` on the CPU the spans that are on open
ranges of their names, nested as they run; off, none.  Threads add their
totals without loss, a span given a phase prints the ``FWT_PHASE_LOG``
line whether or not spans are on, and a reduction over a model-axis group
is one ``fwt.all_reduce``."""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from faster_whisper_tpu_torch import tracing
from faster_whisper_tpu_torch.audio import decode_audio
from faster_whisper_tpu_torch.generation import generate as G
from faster_whisper_tpu_torch.models.config import tiny_test_config
from faster_whisper_tpu_torch.models.load import random_params
from faster_whisper_tpu_torch.ops.quant import int8_dense_rows, quantize_weight
from faster_whisper_tpu_torch.parallel.collectives import ShardGroup
from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer
from faster_whisper_tpu_torch.transcribe import BatchedInferencePipeline, WhisperModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = tiny_test_config()
METHODS = {
    "beam": dict(beam_size=5, temperature=[0.0]),
    "sample": dict(beam_size=1, temperature=[0.7]),
}
KWARGS = dict(batch_size=2, language="en", max_new_tokens=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's many small CPU ops (as in the
    other port tests under the suite's parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _spans_off():
    tracing.enable(False)
    tracing.reset()
    yield
    tracing.enable(False)
    tracing.reset()


@pytest.fixture(scope="module")
def speech():
    jfk = decode_audio(os.path.join(ROOT, "docker", "jfk.flac"))
    gap = np.zeros(16000, np.float32)
    return np.concatenate([jfk, gap] * 6)


@pytest.fixture(scope="module")
def models():
    out = {}
    for compute_type, dtype in (("bfloat16", torch.bfloat16), ("int8", torch.float32)):
        params = random_params(CONFIG, seed=0, dtype=dtype, device="cpu")
        model = WhisperModel.from_parts(params, CONFIG, build_synthetic_tokenizer(),
                                        compute_type=compute_type, device="cpu")
        model.model.rng_seed = 1234
        out[compute_type] = model
    return out


def _transcribe(model, speech, method):
    segments, _ = BatchedInferencePipeline(model).transcribe(speech, **KWARGS, **METHODS[method])
    return [(s.id, s.seek, s.start, s.end, s.text, tuple(s.tokens), s.avg_logprob, s.no_speech_prob)
            for s in segments]


class _NoClock:
    @staticmethod
    def perf_counter():
        raise AssertionError("a span read the clock while off")


def test_off_reads_no_clock_and_counts_nothing(models, speech, monkeypatch):
    monkeypatch.delenv("FWT_PHASE_LOG", raising=False)
    monkeypatch.setattr(tracing, "time", _NoClock)
    assert tracing.span("fwt.a") is tracing.span("fwt.b") is tracing.phase_timer("a")
    assert _transcribe(models["int8"], speech, "beam")
    assert tracing.totals() == {}


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("compute_type", ["bfloat16", "int8"])
def test_counts_on_a_batched_transcribe(models, speech, compute_type, method):
    model = models[compute_type]
    off = _transcribe(model, speech, method)
    tracing.enable(True)
    calls = G._gen_decoder_step.calls
    on = _transcribe(model, speech, method)
    steps = G._gen_decoder_step.calls - calls
    tracing.enable(False)
    totals = tracing.totals()
    count = {name: c for name, (c, _) in totals.items()}

    assert on == off
    assert all(name.startswith("fwt.") and c > 0 and s >= 0 for name, (c, s) in totals.items())
    batches = count["fwt.decode.prefill"]
    assert batches == count["fwt.collect"] == 2  # three chunks in batches of two
    assert steps > batches and count["fwt.decode.step"] == steps
    assert count["fwt.decode.select"] == count["fwt.decode.logits"] == steps
    assert count["fwt.decode.stop"] == steps + (batches if method == "sample" else 0)
    assert count["fwt.vad"] == count["fwt.mel"] == 1 and count["fwt.encode"] == batches
    assert count["fwt.pipeline.chunks"] == 2 and count["fwt.pipeline.segments"] == 2 * batches
    assert "fwt.all_reduce" not in count
    if compute_type == "int8":
        per_step = 8 * CONFIG.n_text_layer + 1
        per_prefill = 10 * CONFIG.n_text_layer + 1
        per_encode = 6 * CONFIG.n_audio_layer
        assert count["fwt.int8_dense"] == steps * per_step + batches * (per_prefill + per_encode)
    else:
        assert "fwt.int8_dense" not in count


def _ranges(prof):
    return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in prof.profiler.kineto_results.events() if e.name().startswith("fwt.")]


def _inside(rng, ranges, names):
    s, e, _ = rng
    return any(n in names and a <= s and e <= b for a, b, n in ranges)


@pytest.mark.parametrize("on", [True, False])
def test_profiler_ranges_under_their_names(models, speech, on):
    from torch.profiler import ProfilerActivity, profile

    tracing.enable(on)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _transcribe(models["int8"], speech, "beam")
    tracing.enable(False)
    ranges = _ranges(prof)
    if not on:
        assert ranges == [] and tracing.totals() == {}
        return
    names = {}
    for _, _, n in ranges:
        names[n] = names.get(n, 0) + 1
    assert names == {name: c for name, (c, _) in tracing.totals().items()}
    for r in ranges:
        if r[2] == "fwt.decode.logits":
            assert _inside(r, ranges, {"fwt.decode.step"})
        elif r[2] == "fwt.int8_dense":
            assert _inside(r, ranges, {"fwt.decode.step", "fwt.decode.prefill", "fwt.encode"})
        elif r[2].startswith("fwt.decode."):
            assert not _inside(r, ranges, {"fwt.decode.step", "fwt.decode.select", "fwt.decode.stop"} - {r[2]})
    head = [r for r in ranges if r[2] == "fwt.int8_dense" and _inside(r, ranges, {"fwt.decode.logits"})]
    assert len(head) == names["fwt.decode.step"]


def test_threads_add_without_loss():
    n_threads, n_spans = 8, 2000
    tracing.enable(True)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(n_spans):
                with tracing.span("fwt.shared"):
                    pass
                with tracing.span(f"fwt.own.{i}"):
                    pass

        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    counts = {name: c for name, (c, _) in tracing.totals().items()}
    assert counts == {"fwt.shared": n_threads * n_spans, **{f"fwt.own.{i}": n_spans for i in range(n_threads)}}


@pytest.mark.parametrize("on", [True, False])
def test_a_phase_prints_its_line_whether_or_not_spans_are_on(monkeypatch, capsys, on):
    monkeypatch.setenv("FWT_PHASE_LOG", "1")
    tracing.enable(on)
    with tracing.span("fwt.a", phase="assemble speech concat"):
        with tracing.span("fwt.b"):
            pass
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 1 and err[0].startswith("# phase assemble speech concat: ")
    assert set(tracing.totals()) == ({"fwt.a", "fwt.b"} if on else set())


def test_a_reduction_is_one_all_reduce_span():
    cpu = torch.device("cpu")
    group = ShardGroup([cpu, cpu])
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 64), generator=g)
    w = torch.randn((64, 16), generator=g)
    halves = [quantize_weight(w[:32]), quantize_weight(w[32:])]
    tracing.enable(True)
    assert all(torch.equal(y, x + x) for y in group.all_reduce_sum([x, x]))
    int8_dense_rows([x[:, :32], x[:, 32:]], halves, [None, None], group)
    counts = {name: c for name, (c, _) in tracing.totals().items()}
    assert counts == {"fwt.all_reduce": 3, "fwt.int8_dense": 1}
