"""Spans: named intervals of host time at the sites where the port's work
happens, the one tracing system of the package.

    from faster_whisper_tpu_torch import tracing

    tracing.reset()
    tracing.enable(True)
    ...                      # transcribe
    tracing.enable(False)
    tracing.totals()         # {"fwt.decode.step": (count, host seconds), ...}

Off (the default), ``span`` tests one module-level bool and returns a
shared object that does nothing: no clock read, no allocation, no profiler
call.  On, a span adds its ``time.perf_counter`` duration and a count to
``totals()``, under a lock (the batcher, the servers and the mesh's
replicas run spans on several threads).  While a ``torch.profiler``
profile is active, a span that is on also opens a ``record_function``
range of its name, which the profiler puts on the device trace's clock: a
device operation then belongs to the span whose host time launched it.

The seconds are host time.  The card runs asynchronously: a span around
launches times the launches, and a span around a read back
(``fwt.decode.stop``, ``fwt.collect``) also waits for the work queued
before it.  A span synchronizes nothing.

The spans, each where its work happens: ``fwt.vad``, ``fwt.mel``,
``fwt.encode``, ``fwt.decode.prefill``, ``fwt.decode.select``,
``fwt.decode.step``, ``fwt.decode.logits`` (inside the step),
``fwt.int8_dense`` (every W8A8 product; on the card every launch of
one, which takes up to three weights of one x), ``fwt.decode.capture``,
``fwt.decode.stop``, ``fwt.collect``, ``fwt.pipeline.chunks``,
``fwt.pipeline.segments`` and ``fwt.all_reduce``.  Every name starts with
``fwt.``, and no span stays open across a ``yield``.  A beam-search step
replayed from its CUDA graph on the card is one ``fwt.decode.step``
around the replay: the spans inside the step (``fwt.decode.select``,
``fwt.decode.logits``, ``fwt.int8_dense``) open once, when the step is
captured (``fwt.decode.capture``), and a device operation of a replay
belongs to ``fwt.decode.step``.

``phase`` keeps the cold-start stamps of ``FWT_PHASE_LOG=1`` under the
JAX package's phase names: a span given a phase prints that phase's line
to stderr when it closes, whether or not spans are on.  ``phase_timer``
is a stamp alone, for a site whose work a span inside it already counts.
"""

import os
import sys
import threading
import time

from typing import Dict, Optional, Tuple

import torch

_on = False
_lock = threading.Lock()
_totals: Dict[str, list] = {}  # name -> [count, host seconds]
_phase_t0 = None


def enable(on: bool) -> None:
    """Turn the spans on (True) or off (False) for the whole process."""
    global _on
    _on = bool(on)


def reset() -> None:
    """Forget every span's count and seconds."""
    with _lock:
        _totals.clear()


def totals() -> Dict[str, Tuple[int, float]]:
    """{name: (count, host seconds)} of the spans closed while on."""
    with _lock:
        return {name: (c, s) for name, (c, s) in _totals.items()}


def _phase_log() -> bool:
    return os.environ.get("FWT_PHASE_LOG", "0") != "0"


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """A span that is on (``name``), a phase stamp (``phase``), or both."""

    __slots__ = ("name", "phase", "t0", "rf")

    def __init__(self, name: Optional[str], phase: Optional[str]):
        self.name, self.phase, self.rf = name, phase, None

    def __enter__(self):
        global _phase_t0
        if self.name is not None and torch.autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        if self.phase is not None and _phase_t0 is None:
            _phase_t0 = self.t0
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.name is not None:
            with _lock:
                entry = _totals.get(self.name)
                if entry is None:
                    _totals[self.name] = [1, t1 - self.t0]
                else:
                    entry[0] += 1
                    entry[1] += t1 - self.t0
        if self.phase is not None and _phase_log():
            print(
                f"# phase {self.phase}: {t1 - self.t0:.2f}s (at +{t1 - _phase_t0:.1f}s)",
                file=sys.stderr,
                flush=True,
            )
        return False


def span(name: str, phase: Optional[str] = None):
    """``with span("fwt.<site>"):`` around the work of a site; ``phase``
    also prints the ``FWT_PHASE_LOG`` line of that name."""
    if _on:
        return _Span(name, phase)
    if phase is not None and _phase_log():
        return _Span(None, phase)
    return _OFF


def phase_timer(phase: str):
    """The ``FWT_PHASE_LOG=1`` stamp of ``phase`` alone: one line to stderr
    when the block closes, its seconds and the offset since the first
    phase of the process."""
    return _Span(None, phase) if _phase_log() else _OFF
