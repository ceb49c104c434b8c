"""Voice activity detection: Silero VAD (PyTorch) + speech-chunk bookkeeping.

Counterpart of ``faster_whisper_tpu/vad.py``: ``VadOptions``,
``get_speech_timestamps`` (the hysteresis state machine over per-window
speech probabilities), ``collect_chunks`` (packs speech into <=max_duration
buffers with offset/duration metadata) and ``SpeechTimestampsMap``
(VAD-compressed clock -> original clock).  The probabilities come from
``models/silero.py`` on the device in one forward over the whole buffer;
the state machine runs on the host in native code
(``hysteresis_native``, ``csrc/vad_sm.cpp``, the counterpart of the JAX
package's ``vad_native.py``), whose plain version is the Python loop
``_hysteresis_py``.

``upload_with_vad`` is the opt-in pipelined form (``FWT_PIPELINED_VAD=1``):
the int16 PCM crosses to the card in slices on a copy stream, and the VAD
forward runs on each slice as it lands, with the LSTM state carried.
"""

import bisect
import ctypes
import functools
import os

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from faster_whisper_tpu_torch.utils import exact_float32, phase_timer, resolve_device, side_stream, span


@dataclass
class VadOptions:
    """VAD options (semantics per reference: faster_whisper/vad.py:14-42).

    Attributes:
      threshold: Speech threshold; probabilities ABOVE it count as speech.
      neg_threshold: Silence re-entry threshold (defaults to threshold-0.15,
        floored at 0.01).
      min_speech_duration_ms: Chunks shorter than this are dropped.
      max_speech_duration_s: Longer chunks are split at the last >=98 ms
        silence, or aggressively just before the limit.
      min_silence_duration_ms: Silence to wait before closing a chunk.
      speech_pad_ms: Padding added on both sides of final chunks.
    """

    threshold: float = 0.5
    neg_threshold: float = None
    min_speech_duration_ms: int = 0
    max_speech_duration_s: float = float("inf")
    min_silence_duration_ms: int = 2000
    speech_pad_ms: int = 400


def upload_with_vad(audio: np.ndarray, return_audio: bool = True, device="cuda"):
    """Pipelined PCM upload and Silero forward.

    The PCM goes to ``device`` on the int16 grid (in float32 under
    ``FWT_I16_TRANSFER=0``) in slices of
    ``models/silero.py::VAD_SLICE_SAMPLES`` (2048 windows), and the VAD
    forward runs on each slice as it lands (the conv tower on its windows,
    the LSTM with its state and the 64-sample context carried from the
    slice before), so the forward of one slice overlaps the copy of the
    next.  On the card the int16 samples sit in one pinned host buffer,
    each slice is copied ``non_blocking`` on a copy stream of its own and
    recorded with an event, which the forward on the caller's stream
    waits for; each dequantized slice is written into one preallocated
    device buffer.  On the CPU the same steps run in line.

    Opt-in (``FWT_PIPELINED_VAD=1`` in ``BatchedInferencePipeline`` and
    ``get_speech_timestamps``), default off, as in the JAX package.

    Returns ``(audio_dev, probs)``: ``audio_dev`` equal to
    ``ops/mel.py::upload_audio(audio, device)`` (None when
    ``return_audio`` is false), and ``probs`` a host float32 array of at
    least ``len(audio) // 512 + 1`` window probabilities, those of the
    whole-buffer forward.  Runs inside ``utils.exact_float32``.
    """
    from faster_whisper_tpu_torch.models.silero import (
        _CONTEXT,
        _WINDOW,
        VAD_SLICE_SAMPLES,
        _vad_slice_step,
        _write_slice,
    )

    dev = resolve_device(device)
    model = get_vad_model(dev)
    n = len(audio)
    n_slices = max(1, -(-n // VAD_SLICE_SAMPLES))
    total = n_slices * VAD_SLICE_SAMPLES
    expected_windows = n // _WINDOW + 1
    cuda = dev.type == "cuda"

    if os.environ.get("FWT_I16_TRANSFER", "1") != "0":
        q = torch.zeros(total, dtype=torch.int16, pin_memory=cuda)
        q[:n] = torch.from_numpy(
            np.clip(np.round(np.asarray(audio) * 32768.0), -32768, 32767).astype(np.int16)
        )
    else:
        q = torch.zeros(total, dtype=torch.float32, pin_memory=cuda)
        q[:n] = torch.from_numpy(np.asarray(audio, np.float32))
    audio_dev = torch.empty(n, dtype=torch.float32, device=dev) if return_audio else None
    tail = torch.zeros(_CONTEXT, dtype=torch.float32, device=dev)
    state = None
    probs = []
    if cuda:
        compute = torch.cuda.current_stream(dev)
        copier = side_stream(dev, "pcm upload")
    with torch.no_grad(), exact_float32():
        for off in range(0, total, VAD_SLICE_SAMPLES):
            if cuda:
                with torch.cuda.stream(copier):
                    q_slice = q[off : off + VAD_SLICE_SAMPLES].to(dev, non_blocking=True)
                    landed = torch.cuda.Event()
                    landed.record(copier)
                compute.wait_event(landed)
                q_slice.record_stream(compute)
            else:
                q_slice = q[off : off + VAD_SLICE_SAMPLES]
            p, tail, state, samples = _vad_slice_step(model, q_slice, tail, state)
            probs.append(p)
            if return_audio:
                _write_slice(audio_dev, samples, off)
        if total < expected_windows * _WINDOW:
            # n is a whole number of slices: the reference pads one more
            # window past the end; one zero slice, made on the device,
            # gives its probability
            zero = torch.zeros(VAD_SLICE_SAMPLES, dtype=q.dtype, device=dev)
            probs.append(_vad_slice_step(model, zero, tail, state)[0])
    return audio_dev, torch.cat(probs).cpu().numpy()


def get_speech_timestamps(
    audio,
    vad_options: Optional[VadOptions] = None,
    sampling_rate: int = 16000,
    device="cuda",
    **kwargs,
) -> List[dict]:
    """Split long audio into speech chunks using Silero VAD.

    Returns a list of {"start": sample, "end": sample} dicts (behavior
    contract: reference vad.py:45-183).  ``audio`` is a float32 numpy
    array, whose VAD runs on ``device``, or a 1-D tensor already on a
    device (the batched pipeline's shared upload), whose VAD runs there.
    Both go through the same int16 grid (models/silero.py), so both give
    the same decisions (``FWT_I16_TRANSFER=0``: neither, float32 end to
    end).  Under ``FWT_PIPELINED_VAD=1`` a numpy array takes
    the pipelined sliced upload (``upload_with_vad``), whose decisions
    are the same.  The whole call is the span ``fwt.vad``.
    """
    with span("fwt.vad"):
        if vad_options is None:
            vad_options = VadOptions(**kwargs)

        window = 512
        n_samples = len(audio)
        # the reference pads to a whole window past the end, a full one when
        # the length is already a multiple
        expected_windows = n_samples // window + 1
        if (
            not torch.is_tensor(audio)
            and n_samples
            and os.environ.get("FWT_PIPELINED_VAD", "0") == "1"
        ):
            _, probs = upload_with_vad(audio, return_audio=False, device=device)
            with phase_timer("vad probs pull"):
                probs = probs[:expected_windows]
        else:
            if not torch.is_tensor(audio):
                audio = torch.as_tensor(np.asarray(audio, np.float32), device=resolve_device(device))
            padded = F.pad(audio.to(torch.float32), (0, expected_windows * window - n_samples))
            with phase_timer("vad forward (compile+exec+probs pull)"):
                probs = get_vad_model(audio.device)(padded).cpu().numpy()
        return speech_timestamps_from_probs(probs, n_samples, vad_options, sampling_rate)


def speech_timestamps_from_probs(
    probs: np.ndarray,
    n_samples: int,
    vad_options: VadOptions,
    sampling_rate: int = 16000,
) -> List[dict]:
    """``get_speech_timestamps`` from the window probabilities of
    ``n_samples`` samples: the hysteresis state machine and the padding of
    the chunks.  Probabilities past the reference's padded window are
    ignored."""
    window = 512
    probs = probs[: n_samples // window + 1]
    threshold = vad_options.threshold
    neg_threshold = vad_options.neg_threshold
    if neg_threshold is None:
        neg_threshold = max(threshold - 0.15, 0.01)

    min_speech_samples = sampling_rate * vad_options.min_speech_duration_ms / 1000
    pad_samples = sampling_rate * vad_options.speech_pad_ms / 1000
    max_speech_samples = (
        sampling_rate * vad_options.max_speech_duration_s - window - 2 * pad_samples
    )
    min_silence_samples = sampling_rate * vad_options.min_silence_duration_ms / 1000
    min_silence_at_max_speech = sampling_rate * 98 / 1000

    speeches = hysteresis_native(
        probs, window, threshold, neg_threshold, min_speech_samples,
        max_speech_samples, min_silence_samples, min_silence_at_max_speech, n_samples,
    )

    # --- pad chunks and share short inter-chunk silences ---
    for i, speech in enumerate(speeches):
        if i == 0:
            speech["start"] = int(max(0, speech["start"] - pad_samples))
        if i != len(speeches) - 1:
            gap = speeches[i + 1]["start"] - speech["end"]
            if gap < 2 * pad_samples:
                speech["end"] += int(gap // 2)
                speeches[i + 1]["start"] = int(max(0, speeches[i + 1]["start"] - gap // 2))
            else:
                speech["end"] = int(min(n_samples, speech["end"] + pad_samples))
                speeches[i + 1]["start"] = int(max(0, speeches[i + 1]["start"] - pad_samples))
        else:
            speech["end"] = int(min(n_samples, speech["end"] + pad_samples))

    return speeches


def hysteresis_native(
    probs,
    window: int,
    threshold: float,
    neg_threshold: float,
    min_speech_samples: float,
    max_speech_samples: float,
    min_silence_samples: float,
    min_silence_at_max_speech: float,
    n_samples: int,
) -> List[dict]:
    """The hysteresis loop of ``_hysteresis_py`` in native code
    (``csrc/vad_sm.cpp``, built with ``g++`` at first use; a failed build
    raises).  Returns the same {"start", "end"} dicts."""
    from faster_whisper_tpu_torch.ops import _build

    if ctypes.sizeof(ctypes.c_long) != 8:
        raise RuntimeError("vad_sm.cpp writes C longs; this platform's are not 64-bit")
    lib = _build.load("vad_sm.cpp")
    probs = np.ascontiguousarray(probs, dtype=np.float32)
    n = len(probs)
    max_out = n + 1
    out = np.empty(2 * max_out, dtype=np.int64)
    count = lib.fwt_vad_hysteresis(
        probs.ctypes.data, n, float(threshold), float(neg_threshold), int(window),
        float(min_speech_samples), float(max_speech_samples), float(min_silence_samples),
        float(min_silence_at_max_speech), int(n_samples), out.ctypes.data, max_out,
    )
    return [{"start": int(out[2 * i]), "end": int(out[2 * i + 1])} for i in range(count)]


def _hysteresis_py(
    probs,
    window: int,
    threshold: float,
    neg_threshold: float,
    min_speech_samples: float,
    max_speech_samples: float,
    min_silence_samples: float,
    min_silence_at_max_speech: float,
    n_samples: int,
) -> List[dict]:
    """The hysteresis loop over window probabilities (behavior contract:
    reference vad.py:96-152)."""
    speeches: List[dict] = []
    current: dict = {}
    triggered = False
    temp_end = 0  # candidate end while tolerating short silence
    prev_end = 0  # last >=98ms silence position (for max-duration splits)
    next_start = 0

    for i, p in enumerate(probs):
        pos = window * i

        if p >= threshold and temp_end:
            temp_end = 0
            if next_start < prev_end:
                next_start = pos

        if p >= threshold and not triggered:
            triggered = True
            current["start"] = pos
            continue

        if triggered and pos - current["start"] > max_speech_samples:
            if prev_end:
                current["end"] = prev_end
                speeches.append(current)
                current = {}
                if next_start < prev_end:
                    # silence reached and still silent: close out entirely
                    triggered = False
                else:
                    current["start"] = next_start
                prev_end = next_start = temp_end = 0
            else:
                current["end"] = pos
                speeches.append(current)
                current = {}
                prev_end = next_start = temp_end = 0
                triggered = False
                continue

        if p < neg_threshold and triggered:
            if not temp_end:
                temp_end = pos
            if pos - temp_end > min_silence_at_max_speech:
                prev_end = temp_end
            if pos - temp_end < min_silence_samples:
                continue
            current["end"] = temp_end
            if current["end"] - current["start"] > min_speech_samples:
                speeches.append(current)
            current = {}
            prev_end = next_start = temp_end = 0
            triggered = False
            continue

    if current and (n_samples - current["start"]) > min_speech_samples:
        current["end"] = n_samples
        speeches.append(current)
    return speeches


def collect_chunks(
    audio: np.ndarray,
    chunks: List[dict],
    sampling_rate: int = 16000,
    max_duration: float = float("inf"),
) -> Tuple[List[np.ndarray], List[Dict[str, float]]]:
    """Concatenate speech chunks into buffers of at most ``max_duration``
    seconds, with {offset, duration, segments} metadata per buffer
    (reference: vad.py:186-243)."""
    if not chunks:
        return [np.array([], dtype=np.float32)], [{"offset": 0, "duration": 0, "segments": []}]

    audio_chunks: List[np.ndarray] = []
    metadata: List[dict] = []
    pieces: List[np.ndarray] = []
    segments: List[dict] = []
    duration = 0  # samples in the current buffer
    total = 0  # samples emitted so far (offset basis)

    def flush():
        nonlocal pieces, segments, duration, total
        audio_chunks.append(np.concatenate(pieces) if pieces else np.array([], dtype=np.float32))
        metadata.append(
            {
                "offset": total / sampling_rate,
                "duration": duration / sampling_rate,
                "segments": segments,
            }
        )
        total += duration
        pieces, segments, duration = [], [], 0

    for chunk in chunks:
        size = chunk["end"] - chunk["start"]
        if duration + size > max_duration * sampling_rate:
            flush()
            # The chunk that triggers the flush starts the next buffer and
            # is NOT recorded in its segment metadata, as in the reference
            # (vad.py:209-233).
            pieces = [audio[chunk["start"] : chunk["end"]]]
            duration = size
        else:
            segments.append(chunk)
            pieces.append(audio[chunk["start"] : chunk["end"]])
            duration += size

    flush()
    return audio_chunks, metadata


class SpeechTimestampsMap:
    """Maps VAD-compressed timestamps back to the original clock
    (reference: vad.py:246-285)."""

    def __init__(self, chunks: List[dict], sampling_rate: int, time_precision: int = 2):
        self.sampling_rate = sampling_rate
        self.time_precision = time_precision
        self.chunk_end_sample = []
        self.total_silence_before = []

        previous_end = 0
        silent_samples = 0
        for chunk in chunks:
            silent_samples += chunk["start"] - previous_end
            previous_end = chunk["end"]
            self.chunk_end_sample.append(chunk["end"] - silent_samples)
            self.total_silence_before.append(silent_samples / sampling_rate)

    def get_original_time(
        self,
        time: float,
        chunk_index: Optional[int] = None,
        is_end: bool = False,
    ) -> float:
        if chunk_index is None:
            chunk_index = self.get_chunk_index(time, is_end)
        return round(self.total_silence_before[chunk_index] + time, self.time_precision)

    def get_chunk_index(self, time: float, is_end: bool = False) -> int:
        sample = int(time * self.sampling_rate)
        if is_end and sample in self.chunk_end_sample:
            return self.chunk_end_sample.index(sample)
        return min(
            bisect.bisect(self.chunk_end_sample, sample),
            len(self.chunk_end_sample) - 1,
        )


def get_vad_model(device="cuda"):
    """The Silero VAD model on ``device``, built once per device."""
    return _vad_model(str(resolve_device(device)))


@functools.lru_cache
def _vad_model(device: str):
    from faster_whisper_tpu_torch.models.silero import SileroVAD

    return SileroVAD(device)
