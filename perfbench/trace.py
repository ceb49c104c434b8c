"""The traced run: ranges from the benchmark's own code around the calls
into the program's layers, the program's counters, and a ``torch.profiler``
trace of a bounded slice, reduced to what the per-layer metrics read.

Ranges (``Recorder``): ``bench.slice`` around the slice, ``bench.vad``
around the pipeline's ``get_speech_timestamps``, ``bench.mel`` around its
``chunk_features``, ``bench.encode`` around the engine's ``encode`` and
``bench.decode`` around its ``generate_dispatch`` and ``generate_collect``.
The Recorder also clocks the host time inside each range itself, and does
only that when it runs untraced (``profile=False``).

A device operation (kernel, copy or fill) belongs to the range in which
the host launched it: the profiler links each operation to its runtime
call (the CUDA correlation id) and to the operator or range that was
running when it was called (the linked correlation id); the innermost
``bench.*`` range around that host time is the operation's. The device is
busy while any operation runs; the slice's window is the ``bench.slice``
range. An idle gap on the device belongs to the range the host was in at
its middle.
"""

import functools
import time

from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaGraphLaunch")
OUTSIDE = "between calls"


def counters() -> Dict[str, int]:
    """The program's own counters: K1/K2 launches (every form) and decoder
    steps."""
    from faster_whisper_tpu_torch.generation import generate as G
    from faster_whisper_tpu_torch.ops.beam_attention import beam_attend_append as k12

    names = ("launches", "launches_f32", "launches_int8", "launches_int8_f32")
    return {"k12_launches": sum(getattr(k12, n) for n in names), "decoder_steps": G._gen_decoder_step.calls}


class Recorder:
    """Wraps the engine's entry points and the pipeline's VAD and feature
    calls, clocks the host time inside each (and, with ``profile``, opens a
    profiler range there), and records each decode's shape and steps (K1/K2
    launches over the decoder's layers)."""

    def __init__(self, model, dec_layers: int, profile: bool = True):
        self.model, self.dec_layers, self.profile = model, dec_layers, profile
        self.decodes: List[dict] = []
        self.encodes: List[int] = []
        self.wall = defaultdict(float)
        self._undo = []

    def _wrap(self, owner, attr, name, after=None):
        from contextlib import nullcontext

        from torch.profiler import record_function

        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with record_function(name) if self.profile else nullcontext():
                before = counters()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self.wall[name] += time.perf_counter() - t0
            if after is not None:
                after(before, args, kwargs)
            return out

        had = attr in vars(owner)
        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, fn, had))

    def install(self):
        from faster_whisper_tpu_torch import transcribe as T

        engine = self.model.model

        def on_decode(before, args, kwargs):
            # K1/K2 launch once per layer and step on the card; the host's
            # plain versions count nothing, so there the step counter reads
            now = counters()
            steps = (now["k12_launches"] - before["k12_launches"]) // self.dec_layers
            if not steps:
                steps = now["decoder_steps"] - before["decoder_steps"]
            prompts = args[1] if len(args) > 1 else kwargs["prompts"]
            self.decodes.append(dict(rows=int(args[0].shape[0]), beams=int(kwargs.get("beam_size", 1)),
                                     prompt=max(len(p) for p in prompts), steps=int(steps)))

        self._wrap(engine, "encode", "bench.encode", lambda b, a, k: self.encodes.append(int(a[0].shape[0])))
        self._wrap(engine, "generate_dispatch", "bench.decode", on_decode)
        self._wrap(engine, "generate_collect", "bench.decode")
        self._wrap(T, "get_speech_timestamps", "bench.vad")
        self._wrap(self.model.feature_extractor, "chunk_features", "bench.mel")

    def remove(self):
        for owner, attr, fn, had in reversed(self._undo):
            if had:
                setattr(owner, attr, fn)
            else:
                delattr(owner, attr)
        self._undo = []


class Event(NamedTuple):
    """One profiler event, in ns on the common clock."""

    name: str
    device: bool
    start: int
    end: int
    corr: int
    linked: int
    annotation: bool


def events_of(prof) -> List[Event]:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        out.append(Event(e.name(), e.device_type() == cuda, s, s + e.duration_ns(), e.correlation_id(),
                         e.linked_correlation_id(), e.is_user_annotation()))
    return out


class Trace:
    """Device operations, launches and ranges of one profile."""

    def __init__(self, events: List[Event]):
        ranges, device, spans = [], [], defaultdict(list)
        op_start, runtime_start = {}, {}
        self.launches = []  # host times of the runtime's launch calls
        for e in events:
            if e.device:
                if e.name.startswith("bench."):
                    spans[e.name].append((e.start, e.end))
                elif not e.annotation:
                    device.append(e)
                continue
            if e.name.startswith("bench."):
                ranges.append((e.start, e.end, e.name))
            if e.name.startswith("cu"):
                runtime_start[e.corr] = e.start
                if e.name in LAUNCHES:
                    self.launches.append(e.start)
            else:
                op_start[e.corr] = e.start
        runtime_start.pop(0, None)  # 0: no id
        op_start.pop(0, None)
        slices = [r for r in ranges if r[2] == "bench.slice"]
        if not slices:
            raise RuntimeError("the profile holds no bench.slice range")
        self.t0, self.t1 = min(r[0] for r in slices), max(r[1] for r in slices)
        self.window_s = (self.t1 - self.t0) / 1e9
        # innermost first: a range nested in another starts later
        self.ranges = sorted(ranges, key=lambda r: (-r[0], r[1]))
        self.launches.sort()
        self.kernels = []  # (name, seconds, start, end, range), clipped to the slice
        self.by_link = self.by_span = 0
        for e in device:
            t = runtime_start.get(e.corr, op_start.get(e.linked))
            if t is not None:
                where = self.range_at(t)
                self.by_link += 1
            else:
                where = _span_range(spans, e)
                self.by_span += 1
            s, t_end = max(e.start, self.t0), min(e.end, self.t1)
            if t_end > s:
                self.kernels.append((e.name, (t_end - s) / 1e9, s, t_end, where))
        self.busy = _union([(k[2], k[3]) for k in self.kernels])
        self.busy_s = sum(e - s for s, e in self.busy) / 1e9
        self.n_device_events = len(device)

    def range_at(self, t: int) -> str:
        """The innermost range of the harness around host time ``t``, or
        ``OUTSIDE`` within the slice but in none of the calls."""
        for s, e, name in self.ranges:
            if s <= t <= e and name != "bench.slice":
                return name
        return OUTSIDE

    def launches_in(self, name: str) -> int:
        ivs = [(s, e) for s, e, n in self.ranges if n == name]
        return sum(any(s <= t <= e for s, e in ivs) for t in self.launches)

    def device_seconds(self, label: Optional[str] = None, names: Optional[List[str]] = None) -> float:
        """Device seconds of the operations named (by a part of their name)
        that were launched inside range ``label``."""
        return sum(k[1] for k in self.kernels
                   if (label is None or k[4] == label) and (names is None or any(n in k[0] for n in names)))

    def breakdown(self) -> dict:
        by_name = defaultdict(float)
        for name, sec, *_ in self.kernels:
            by_name[name[:160]] += sec
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        idle = defaultdict(float)
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        for s, e in zip(edges[::2], edges[1::2]):
            if e > s:
                idle[self.range_at((s + e) // 2)] += (e - s) / 1e9
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def _span_range(spans, e: Event) -> str:
    """The range whose span on the device's timeline holds operation ``e``:
    the profiler's own placement, for an operation with no host link."""
    for name, ivs in spans.items():
        if name != "bench.slice" and any(s <= e.start and e.end <= t for s, t in ivs):
            return name
    return OUTSIDE


def _union(ivs):
    out = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Context:
    """What a per-layer metric's reader gets."""

    def __init__(self, **kw):
        self.__dict__.update(kw)
