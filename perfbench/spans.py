"""The traced run of a cell with the program's own spans on
(``faster_whisper_tpu_torch/tracing.py``), and the five per-layer metrics
that read them.

    python3 perfbench/spans.py --workload <name> --seed <n> [--pairs 3]

It is ``run.py --trace 1`` with these differences, each what ``run.py``'s
``traced`` and ``trace.py``'s ``Trace`` would gain to report the five
metrics in the benchmark itself:

* the program's spans are reset and turned on (their clock only) around
  the untraced slice, whose ``totals()`` the readers get as ``ctx.spans``,
  and stay on around the profiled slice, so that it holds their ranges;
* ``SpanTrace`` also reads the host ranges whose names start with
  ``fwt.``: it places each device operation in the program's spans by the
  host time of its launch, the rule the ``bench.*`` ranges use
  (``span_device_seconds``, at any depth), counts them (``span_count``),
  and its ``breakdown`` adds ``idle_spans``: each idle gap of the device
  under the innermost range, the program's or the harness's, around its
  middle;
* ``SPAN_METRICS`` are appended to the cell's per-layer metrics
  (``perfbench/metrics/<name>.py``, each returning None where its spans
  are absent);
* ``--pairs n`` first runs the slice untraced 2n times, the spans' clock
  off and on in turns (off, on, on, off, ...), and reports each pass's
  ``step_ms`` (the Recorder's decode wall over the steps): the cost of the
  clock;
* the result holds ``spans``: the untraced slice's totals, the profile's
  span counts, the clock's passes and four consistency checks.

The untraced slice's ``step_ms.batched`` here is read with the spans'
clock on; ``run.py`` reads it with the spans off. Prints the result as the
last line of standard output, as ``run.py`` does.
"""

import argparse
import copy
import json
import os
import sys

from bisect import bisect_right
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import run as bench_run  # noqa: E402

from perfbench import trace as harness  # noqa: E402

PREFIX = "fwt."
BOTH = ["v3-int8.batched", "turbo-bf16.batched"]


def _metric(name, unit, source, layer, workloads):
    return {"name": name, "unit": unit, "better": "lower", "source": source, "layer": layer,
            "moves": "audio_s_per_s", "workloads": workloads}


SPAN_METRICS = [
    _metric("step_host_ms.batched", "ms", "program_span", "decode loop", BOTH),
    _metric("step_device_ms.batched", "ms", "device_trace", "decode loop", BOTH),
    _metric("logits_ms_per_step.batched", "ms", "device_trace", "model", BOTH),
    _metric("int8_dense_ms_per_step.batched", "ms", "device_trace", "kernels", ["v3-int8.batched"]),
    _metric("pipeline_host_ms_per_audio_min.batched", "ms", "program_span", "pipeline (host)", BOTH),
]


class SpanTrace(harness.Trace):
    """``trace.Trace`` and the program's spans in the same profile."""

    def __init__(self, events):
        # a span's range on the device's timeline is no operation
        events = [e for e in events if not (e.device and e.name.startswith(PREFIX))]
        super().__init__(events)
        self.spans = [(e.start, e.end, e.name) for e in events if not e.device and e.name.startswith(PREFIX)]
        # each operation's launch, found as Trace finds it
        runtime_start, op_start = {}, {}
        for e in events:
            if not e.device:
                (runtime_start if e.name.startswith("cu") else op_start)[e.corr] = e.start
        runtime_start.pop(0, None)
        op_start.pop(0, None)
        self.launched = []  # (host time of the launch, device seconds inside the slice)
        for e in events:
            if not e.device or e.annotation or e.name.startswith("bench."):
                continue
            t = runtime_start.get(e.corr, op_start.get(e.linked))
            s, t_end = max(e.start, self.t0), min(e.end, self.t1)
            if t is not None and t_end > s:
                self.launched.append((t, (t_end - s) / 1e9))

    def span_count(self, name: str) -> int:
        return sum(n == name for _, _, n in self.spans)

    def span_device_seconds(self, names, within=None) -> float:
        """Device seconds of the operations launched inside any span named
        in ``names`` (at any depth), and, with ``within``, also inside one
        of those."""
        inside = [_Cover(self.spans, names)] + ([_Cover(self.spans, within)] if within else [])
        return sum(sec for t, sec in self.launched if all(c.holds(t) for c in inside))

    def breakdown(self) -> dict:
        out = super().breakdown()
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        gaps = [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]
        ranges = self.spans + [r for r in self.ranges if r[2] != "bench.slice"]
        idle = defaultdict(float)
        for (s, e), name in zip(gaps, _innermost(ranges, [(s + e) // 2 for s, e in gaps])):
            idle[name] += (e - s) / 1e9
        out["idle_spans"] = [[n, sec] for n, sec in sorted(idle.items(), key=lambda kv: -kv[1])]
        return out


class _Cover:
    """The union of the spans named in ``names``."""

    def __init__(self, spans, names):
        self.ivs = harness._union([(s, e) for s, e, n in spans if n in names])
        self.starts = [s for s, _ in self.ivs]

    def holds(self, t: int) -> bool:
        i = bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ivs[i][1]


def _innermost(ranges, times):
    """The innermost of ``ranges`` (start, end, name) around each of the
    ascending ``times``: the latest started that has not ended, the
    shorter first where two start together; ``OUTSIDE`` in none."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, open_, i = [], [], 0
    for t in times:
        while i < len(ranges) and ranges[i][0] <= t:
            open_.append(ranges[i])
            i += 1
        while open_ and open_[-1][1] < t:
            open_.pop()
        out.append(open_[-1][2] if open_ else harness.OUTSIDE)
    return out


def _untraced(driver, model, dm, clock: bool):
    """One untraced slice, the spans' clock ``clock``: (Recorder, Run, the
    spans' totals)."""
    from faster_whisper_tpu_torch import tracing

    rec = harness.Recorder(model, dm.dec_layers, profile=False)
    tracing.reset()
    tracing.enable(clock)
    rec.install()
    try:
        run = driver.slice()
    finally:
        rec.remove()
        tracing.enable(False)
    return rec, run, tracing.totals()


def _step_ms(rec) -> float:
    steps = sum(d["steps"] for d in rec.decodes)
    return 1e3 * rec.wall["bench.decode"] / steps if steps else float("nan")


def traced(driver, model, dm, config, traffic, spec, result, dev, log, pairs: int = 0):
    """``run.py``'s ``traced``, with the program's spans on (module
    docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from faster_whisper_tpu_torch import tracing

    clock = {"off": [], "on": []}
    for i in range(2 * pairs):
        on = i % 4 in (1, 2)
        rec, _, _ = _untraced(driver, model, dm, on)
        clock["on" if on else "off"].append(_step_ms(rec))
    plain, untraced, totals = _untraced(driver, model, dm, True)

    rec = harness.Recorder(model, dm.dec_layers)
    rec.install()
    tracing.reset()
    tracing.enable(True)
    try:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            with record_function("bench.slice"):
                window = driver.slice()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
    finally:
        rec.remove()
        tracing.enable(False)
    tr = SpanTrace(harness.events_of(prof))
    del prof
    ctx = harness.Context(
        dims=dm, config=config, traffic=traffic, driver=traffic["driver"], trace=tr,
        decodes=plain.decodes, encodes=plain.encodes, range_wall=plain.wall, wall_s=untraced.wall,
        windows=sum(len({s[0] for s in r.segments}) for r in window.requests if r.ok),
        audio_s=sum(r.seconds for r in window.requests if r.ok),
        kv_int8=bench_run.reference_rule(config["compute_type"]) is not None,
        spans=totals,
    )
    for m in spec["per_layer"]:
        value = bench_run.reader(m["name"])(ctx)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    result["device"]["busy_s"] = tr.busy_s
    result["device"]["window_s"] = tr.window_s
    result["breakdown"] = tr.breakdown()
    result["spans"] = {
        "totals": {n: list(v) for n, v in sorted(totals.items())},
        "profiled": {n: tr.span_count(n) for n in sorted({n for _, _, n in tr.spans})},
        "clock_step_ms": clock,
        "checks": checks(tr, rec, result),
    }
    log(f"# traced slice: {len(window.requests)} requests, {window.wall:.3f} s traced, {untraced.wall:.3f} s "
        f"untraced; {tr.n_device_events} device operations, {len(tr.spans)} program spans; idle_spans "
        + ", ".join(f"{n} {s:.4f}" for n, s in result["breakdown"]["idle_spans"]))
    return window


def checks(tr, rec, result) -> dict:
    """The consistency of the span metrics with the harness's own: the
    profile's ``fwt.decode.step`` ranges against the steps the K1/K2
    counters give, the host ms of a step within the Recorder's, the idle
    gaps' total under either naming, and the device ms of the logits head
    and of the int8 products within a step's."""
    m = {k: v["value"] for k, v in result["metrics"].items()}
    idle_all = sum(s for _, s in result["breakdown"]["idle_gaps"])  # under 10 names: all of them
    idle_spans = sum(s for _, s in result["breakdown"]["idle_spans"])
    step_dev = m.get("step_device_ms.batched")
    out = {
        "steps_equal": tr.span_count("fwt.decode.step") == sum(d["steps"] for d in rec.decodes),
        "host_within_step_ms": m.get("step_host_ms.batched", 0.0) <= m.get("step_ms.batched", float("inf")),
        "idle_equal": abs(idle_all - idle_spans) <= 1e-9 * max(1.0, idle_all),
    }
    for name in ("logits_ms_per_step.batched", "int8_dense_ms_per_step.batched"):
        if name in m and step_dev is not None:
            out[name.split("_ms")[0] + "_within_step"] = m[name] <= step_dev
    return out


def with_span_metrics(bench: dict) -> dict:
    """``bench`` with ``SPAN_METRICS`` appended to its per-layer metrics;
    a cell not named in a metric's list (the tests' tiny ones) is added to
    it."""
    bench = copy.deepcopy(bench)
    names = [w["name"] for w in bench["workloads"]]
    ours = {m["name"] for m in SPAN_METRICS}
    bench["per_layer"] = [m for m in bench["per_layer"] if m["name"] not in ours]
    for m in SPAN_METRICS:
        m = dict(m)
        m["workloads"] = [w for w in names if w in m["workloads"] or w not in BOTH]
        bench["per_layer"].append(m)
    return bench


def run(workload: str, seed: int, pairs: int = 0, bench: dict = None, **kw) -> dict:
    """``run.run`` of one traced run with the spans (``kw`` as there)."""
    if bench is None:
        with open(os.path.join(bench_run.ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
    real = bench_run.traced
    bench_run.traced = lambda *a: traced(*a, pairs=pairs)
    try:
        return bench_run.run(workload, seed, 0.0, True, bench=with_span_metrics(bench), **kw)
    finally:
        bench_run.traced = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=0)
    args = ap.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.pairs)
        bench_run.guard("the reference")
    except bench_run.Refused as e:
        print(f"perfbench: {e}", file=sys.stderr, flush=True)
        return e.code
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
