"""Cross-request continuous batching: one device, many HTTP requests.

Counterpart of ``faster_whisper_tpu/scheduler.py``.  VAD chunks from
CONCURRENT requests merge into shared encode+decode batches on one device
stream; host phases (audio decode, VAD hysteresis, tokenization) run on the
request threads off any lock.

Usage (wired up by faster_whisper_tpu_torch.server):

    batcher = ContinuousBatcher(model, max_batch=8)
    pipeline = BatchedInferencePipeline(model, scheduler=batcher)
    # concurrent pipeline.transcribe() calls now share device batches

Batching rules:
  * Chunks are grouped by their generation "key": every option that
    changes the decode or its semantics (beam size, penalties, decode
    budget, suppress set, timestamp mode).  Requests with identical options
    (the common serving case) always share.
  * A batch is padded to a power-of-two bucket (1/2/4/... max_batch) by
    repeating the last row, so a lone chunk does not pay a full batch of
    encoder compute.  Padded rows are dropped at unpack.
  * The loop keeps one batch in flight while it forms the next, and waits
    ``max_wait_ms`` for stragglers only when the queue cannot already fill
    a batch.  ``generate_dispatch`` runs the decode loop to its end on the
    host (one stop read per step), so a batch is decoded when ``_dispatch``
    returns, and its requests get their results only after the next
    queued batch has been decoded too.
  * Every batch is launched from the loop's thread on the default stream,
    which the sequential path's threads share: the kernels' persistent
    buffers (``ops/cross_attention.py::_buffers``) rely on one stream.
"""

import threading
import time

from collections import deque
from typing import List, NamedTuple, Optional, Sequence

import torch

__all__ = ["ContinuousBatcher", "GenKey"]


class GenKey(NamedTuple):
    """Everything that must match for two chunks to share a decode batch.

    The sampling TEMPERATURE is deliberately NOT part of the key: it is a
    per-row argument of the sampling decode (``generation/generate.py``),
    so requests with different temperatures share one device batch; only
    the sampling/beam split partitions the queue.  Each entry carries its
    own temperature (``_Entry.temperature``)."""

    beam_size: int
    patience: float
    length_penalty: float
    repetition_penalty: float
    no_repeat_ngram_size: int
    max_length: int
    suppress_blank: bool
    suppress_tokens: tuple
    sampling: bool  # beam_size == 1 and temperature > 0 (distinct decode)
    with_timestamps: bool  # engine derives it from prompts[0]; keep batches pure


class _Entry:
    __slots__ = ("features", "row", "prompt", "key", "temperature",
                 "result", "enc", "enc_row", "error", "event")

    def __init__(self, features, row, prompt, key, temperature=0.0):
        self.features = features  # the submitting request's (N, mel, 3000)
        self.row = row
        self.prompt = prompt
        self.key = key
        self.temperature = float(temperature)  # per-row when key.sampling
        self.result = None  # WhisperGenerationResult
        self.enc = None  # encoder output batch this chunk ran in
        self.enc_row = None  # its row index there
        self.error = None
        self.event = threading.Event()


class ContinuousBatcher:
    """Owns the device's encode+generate stream for a serving process."""

    def __init__(self, model, max_batch: int = 8, max_wait_ms: float = 4.0):
        self.model = model  # transcribe.WhisperModel
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self._cv = threading.Condition()
        self._queues = {}  # GenKey -> deque[_Entry]
        self._arrival = {}  # GenKey -> monotonic time of oldest entry
        self._stopping = False
        # stats (read by tests/metrics): device batches vs chunks served
        self.batches_dispatched = 0
        self.chunks_processed = 0
        self._thread = threading.Thread(
            target=self._loop, name="fwt-batcher", daemon=True
        )
        self._thread.start()

    # -- request side -----------------------------------------------------

    def submit(
        self,
        features,
        prompts: Sequence[Sequence[int]],
        key: GenKey,
        temperature: float = 0.0,
    ) -> List[_Entry]:
        """Enqueue one request's chunks; returns entries whose ``event``
        fires (in any order) as shared batches complete.  ``temperature``
        rides per-entry (used only when ``key.sampling``), so requests
        with different temperatures still share batches."""
        entries = [
            _Entry(features, i, list(p), key, temperature)
            for i, p in enumerate(prompts)
        ]
        with self._cv:
            if self._stopping:
                raise RuntimeError("batcher is shut down")
            q = self._queues.setdefault(key, deque())
            if not q:
                self._arrival[key] = time.monotonic()
            q.extend(entries)
            self._cv.notify()
        return entries

    def close(self):
        with self._cv:
            self._stopping = True
            self._cv.notify()
        self._thread.join(timeout=10)

    # -- scheduler side ---------------------------------------------------

    def _take_batch(self, timeout: Optional[float]):
        """Pop up to max_batch same-key entries; block up to ``timeout``
        (None = forever) for the first arrival, then linger max_wait_ms
        for stragglers while the batch is short."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                live = [k for k, q in self._queues.items() if q]
                if live:
                    break
                if self._stopping:
                    return None
                if deadline is not None:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return []
                    self._cv.wait(left)
                else:
                    self._cv.wait()
            # oldest queue first: no key can starve
            key = min(live, key=lambda k: self._arrival.get(k, 0.0))
            q = self._queues[key]
            linger = time.monotonic() + self.max_wait_s
            while len(q) < self.max_batch:
                left = linger - time.monotonic()
                if left <= 0 or self._stopping:
                    break
                self._cv.wait(left)
                if any(
                    qq and kk != key for kk, qq in self._queues.items()
                ) and len(q) > 0:
                    break  # other keys waiting: don't linger on this one
            batch = [q.popleft() for _ in range(min(len(q), self.max_batch))]
            if q:
                self._arrival[key] = time.monotonic()
            return batch

    def _dispatch(self, batch: List[_Entry]):
        key = batch[0].key
        rows = [e.features[e.row : e.row + 1] for e in batch]
        # power-of-two bucket: bounded pad waste
        bucket = 1
        while bucket < len(batch):
            bucket *= 2
        bucket = min(bucket, self.max_batch)
        n_pad = bucket - len(batch)
        rows.extend([rows[-1]] * n_pad)
        # on the lead shard's card, where the engine encodes and decodes
        dev = self.model.model.device
        feats = rows[0].to(dev) if len(rows) == 1 else torch.cat([r.to(dev) for r in rows], dim=0)

        enc = self.model.model.encode(feats)
        prompts = [e.prompt for e in batch] + [batch[-1].prompt] * n_pad
        if key.sampling:
            # per-row temperatures: mixed-temperature requests run in ONE
            # batch
            temps = [e.temperature for e in batch]
            temps += [temps[-1]] * n_pad
        else:
            temps = 0.0  # beam decode; temperature unused
        pending = self.model.model.generate_dispatch(
            enc,
            prompts,
            beam_size=key.beam_size,
            patience=key.patience,
            length_penalty=key.length_penalty,
            repetition_penalty=key.repetition_penalty,
            no_repeat_ngram_size=key.no_repeat_ngram_size,
            max_length=key.max_length,
            suppress_blank=key.suppress_blank,
            suppress_tokens=key.suppress_tokens,
            sampling_temperature=temps,
        )
        self.batches_dispatched += 1
        self.chunks_processed += len(batch)
        return batch, enc, pending

    def _collect(self, in_flight):
        batch, enc, pending = in_flight
        results = self.model.model.generate_collect(pending)
        for i, e in enumerate(batch):
            e.result = results[i]
            e.enc = enc
            e.enc_row = i
            e.event.set()

    def _fail(self, batch, exc):
        for e in batch:
            e.error = exc
            e.event.set()

    def _loop(self):
        in_flight = None
        while True:
            if in_flight is None:
                batch = self._take_batch(timeout=None)
                if batch is None:
                    return  # stopped
                if not batch:
                    continue
                try:
                    in_flight = self._dispatch(batch)
                except Exception as exc:  # noqa: BLE001 — route to waiters
                    self._fail(batch, exc)
                continue
            # one batch is dispatched: form the next before collecting it
            nxt = self._take_batch(timeout=0.0)
            nxt_flight = None
            if nxt:
                try:
                    nxt_flight = self._dispatch(nxt)
                except Exception as exc:  # noqa: BLE001
                    self._fail(nxt, exc)
            try:
                self._collect(in_flight)
            except Exception as exc:  # noqa: BLE001
                self._fail(in_flight[0], exc)
            in_flight = nxt_flight
