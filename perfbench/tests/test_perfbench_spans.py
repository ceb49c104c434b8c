"""The program's spans in the traced run (``spans.py``): on a hand-made
profile, a device operation belongs to every program span around the host
time of its launch, at any depth, an idle gap to the innermost range,
program or harness, around its middle, and the harness's own numbers, as
``Trace`` reads them, do not move when the program's ranges are added; on
the host, a traced run of the tiny cell with the spans on reports all five
span metrics (the int8 products' at int8 only), consistent with the
harness's own, and a traced run of ``run.py`` reports none of them."""

import pytest

import run as bench_run
import spans
import tiny

from perfbench.trace import OUTSIDE, Event, Trace
from test_perfbench_trace import EVENTS, _device, _host

NAMES = [m["name"] for m in spans.SPAN_METRICS]
SPANS = [
    # the decode's first step: the select, then the step with its head
    _host("fwt.decode.select", 3_100, 3_400),
    _host("fwt.decode.step", 3_400, 4_150),
    _host("fwt.decode.logits", 3_950, 4_150),
    _host("fwt.int8_dense", 3_960, 4_140),
    _host("fwt.decode.stop", 4_150, 4_250),
    # a range of the device's timeline is no operation
    Event("fwt.decode.step", True, 3_800, 4_300, 0, 0, True),
]


def test_operations_belong_to_every_span_around_their_launch():
    tr = spans.SpanTrace(EVENTS + SPANS)
    assert tr.span_count("fwt.decode.step") == 1 and tr.span_count("fwt.int8_dense") == 1
    # launched at 3500 (the step, outside its head) and 4000 (the head's
    # int8 product, by its operator): both in the step at any depth
    assert tr.span_device_seconds(["fwt.decode.step"]) == 300 / 1e9
    assert tr.span_device_seconds(["fwt.decode.select", "fwt.decode.step"]) == 300 / 1e9
    assert tr.span_device_seconds(["fwt.decode.logits"]) == 100 / 1e9
    assert tr.span_device_seconds(["fwt.int8_dense"], within=["fwt.decode.step"]) == 100 / 1e9
    assert tr.span_device_seconds(["fwt.int8_dense"], within=["fwt.decode.select"]) == 0.0
    assert tr.span_device_seconds(["fwt.encode"]) == 0.0


def test_idle_gaps_belong_to_the_innermost_range():
    breakdown = spans.SpanTrace(EVENTS + SPANS).breakdown()
    idle = dict(breakdown["idle_spans"])
    # mids 1600 (the harness's encode), 3750 (the step), 4100 (the head's
    # int8 product), 7150 (the decode call, in no span of the program)
    assert idle == pytest.approx({"bench.encode": 3_200 / 1e9, "fwt.decode.step": 100 / 1e9,
                                  "fwt.int8_dense": 200 / 1e9, "bench.decode": 5_700 / 1e9}, abs=1e-15)
    assert sum(idle.values()) == pytest.approx(sum(s for _, s in breakdown["idle_gaps"]), abs=1e-15)
    tr = spans.SpanTrace(EVENTS[:1] + [_device("k", 100, 200)])
    assert dict(tr.breakdown()["idle_spans"]) == {OUTSIDE: 9_900 / 1e9}


@pytest.mark.parametrize("kind", [Trace, spans.SpanTrace])
def test_the_harness_numbers_do_not_move(kind):
    old, new = Trace(EVENTS), kind(EVENTS + SPANS)
    assert new.kernels == old.kernels and new.busy == old.busy and new.launches == old.launches
    assert (new.by_link, new.by_span, new.n_device_events) == (old.by_link, old.by_span, old.n_device_events)
    for label in ("bench.encode", "bench.decode", None):
        assert new.device_seconds(label) == old.device_seconds(label)
    assert new.launches_in("bench.decode") == old.launches_in("bench.decode")
    ours, theirs = new.breakdown(), old.breakdown()
    assert ours["idle_gaps"] == theirs["idle_gaps"] and ours["device_ops"] == theirs["device_ops"]


def test_innermost_of_ranges_that_start_together():
    ranges = [(0, 100, "outer"), (0, 50, "inner"), (60, 70, "late")]
    assert spans._innermost(ranges, [10, 55, 65, 80, 150]) == ["inner", "outer", "late", "outer", OUTSIDE]


@pytest.mark.parametrize("compute_type", ["float32", "int8"])
def test_a_traced_run_with_the_spans_reports_them(monkeypatch, tmp_path, compute_type):
    bench, name = tiny.make(str(tmp_path), "batched", compute_type)
    monkeypatch.setattr(bench_run, "HERE", str(tmp_path))
    res = spans.run(name, 11, pairs=1, bench=bench, device="cpu", check_chips=False, log=lambda m: None)
    if compute_type == "float32":  # the tiny cell's limits are float32's
        assert res["correct"]
    want = set(NAMES) - (set() if compute_type == "int8" else {"int8_dense_ms_per_step.batched"})
    assert want <= set(res["metrics"]) and not (set(NAMES) - want) & set(res["metrics"])
    assert all(res["metrics"][n]["value"] >= 0 for n in want)
    assert res["metrics"]["step_host_ms.batched"]["value"] > 0
    assert res["metrics"]["pipeline_host_ms_per_audio_min.batched"]["value"] > 0
    assert all(res["spans"]["checks"].values())
    assert len(res["spans"]["checks"]) == 4 + (compute_type == "int8")
    assert res["spans"]["profiled"]["fwt.decode.step"] == res["spans"]["totals"]["fwt.decode.step"][0]
    assert len(res["spans"]["clock_step_ms"]["off"]) == len(res["spans"]["clock_step_ms"]["on"]) == 1
    assert "idle_spans" in res["breakdown"]


def test_run_py_reports_none_of_them(monkeypatch, tmp_path):
    res = tiny.run(monkeypatch, tmp_path, "batched", seed=12, trace=True, compute_type="int8")
    assert "step_ms.batched" in res["metrics"] and not set(NAMES) & set(res["metrics"])
    assert "idle_spans" not in res["breakdown"]
