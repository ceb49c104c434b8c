"""The general load generator: one driver per way the program is called,
each read from a traffic file's parameters.

* ``batched``: whole files back to back through
  ``BatchedInferencePipeline.transcribe`` (one client, closed loop).

The audio of the window is made in set-up (``prepare``): a pool of
``pool_files`` files drawn from the seed, cycled, so that nothing but the
program runs inside the measured window. Every seed gets the same gaps and
the same amount of speech, in its own order. A driver records, per
request, when it started and ended, how long its audio is, what the
program returned (its segments) and the engine's hypotheses of each of its
windows (``Capture``).
"""

import time

from typing import Dict, List, Optional

import numpy as np

from perfbench import inputs


def _segments(segs) -> List[tuple]:
    return [(s.seek, s.start, s.end, list(s.tokens), float(s.avg_logprob), float(s.no_speech_prob))
            for s in segs]


class Request:
    __slots__ = ("index", "audio", "start", "end", "segments", "hypotheses", "error")

    def __init__(self, index: int, audio: np.ndarray):
        self.index, self.audio = index, audio
        self.start = self.end = None
        self.segments: Optional[List[tuple]] = None
        self.hypotheses: Optional[List[tuple]] = None
        self.error: Optional[str] = None

    @property
    def seconds(self) -> float:
        return len(self.audio) / inputs.SR

    @property
    def ok(self) -> bool:
        return self.segments is not None and self.error is None


class Run:
    """What one window or traced slice did."""

    def __init__(self, requests: List[Request], begin: float, end: float):
        self.requests, self.begin, self.end = requests, begin, end

    @property
    def wall(self) -> float:
        return self.end - self.begin


def _rng(seed: int, *stream) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, *stream])


class Capture:
    """The engine's hypotheses, as ``generate_collect`` hands them to the
    pipeline: per batch, per row (all its tokens, its score, its no-speech
    probability). A list append per batch; the judge reads them."""

    def __init__(self, model):
        self.engine = model.model
        self.real = self.engine.generate_collect
        self.rows: List[tuple] = []

        def collect(pending):
            results = self.real(pending)
            self.rows.append([(list(r.sequences_ids[0]), float(r.scores[0]), float(r.no_speech_prob))
                              for r in results])
            return results

        self.engine.generate_collect = collect

    def take(self) -> List[tuple]:
        rows, self.rows = self.rows, []
        return rows


class Driver:
    def __init__(self, model, traffic: dict, seed: int):
        self.model, self.traffic, self.seed = model, traffic, seed
        self.options = dict(traffic["options"])
        self.capture = Capture(model)

    def clip(self, seconds: float, *stream) -> np.ndarray:
        t = self.traffic
        return inputs.compose(seconds, _rng(self.seed, *stream), t["gap_s"], t["noise"])

    def closed_loop(self, audio, done) -> Run:
        """One client: request i (of ``audio(i)``) starts when request i - 1
        ends, until ``done(requests so far, seconds so far)``. A failed
        request counts as failed and the loop goes on."""
        reqs = []
        begin = time.perf_counter()
        while True:
            req = Request(len(reqs), audio(len(reqs)))
            req.start = time.perf_counter() - begin
            try:
                self.call(req)
            except Exception as e:
                req.error = repr(e)
            req.end = time.perf_counter() - begin
            req.hypotheses = self.capture.take()
            reqs.append(req)
            if done(len(reqs), req.end):
                return Run(reqs, 0.0, req.end)

    def close(self):
        self.capture.engine.generate_collect = self.capture.real


class Batched(Driver):
    """Files of ``file_s`` seconds, one after another; the window ends at the
    first file boundary after its length."""

    def __init__(self, model, traffic, seed):
        super().__init__(model, traffic, seed)
        from faster_whisper_tpu_torch import BatchedInferencePipeline

        self.pipe = BatchedInferencePipeline(model)
        self.pool: List[np.ndarray] = []

    def prepare(self):
        self.pool = [self.clip(self.traffic["file_s"], 1, i) for i in range(self.traffic["pool_files"])]
        self.floats = [inputs.as_float(a) for a in self.pool]

    def file(self, i: int) -> np.ndarray:
        return self.pool[i % len(self.pool)]

    def call(self, req: Request) -> None:
        audio = self.floats[req.index % len(self.floats)] if req.index >= 0 else inputs.as_float(req.audio)
        segs, _ = self.pipe.transcribe(audio, batch_size=self.traffic["batch_size"], **self.options)
        req.segments = _segments(segs)

    def warm(self):
        self.call(Request(-1, self.clip(self.traffic["file_s"], 0)))
        self.capture.take()

    def window(self, seconds: float) -> Run:
        return self.closed_loop(self.file, lambda i, t: t >= seconds)

    def slice(self) -> Run:
        return self.closed_loop(self.file, lambda i, t: i >= self.traffic["trace_files"])

    def end_to_end(self, run: Run) -> Dict[str, float]:
        done = sum(r.seconds for r in run.requests if r.ok)
        return {"audio_s_per_s": done / run.wall}

    def sample(self, run: Run, rng: np.random.Generator) -> List[Request]:
        ok = [r for r in run.requests if r.ok]
        return [ok[int(rng.integers(len(ok)))]] if ok else []


DRIVERS = {"batched": Batched}
