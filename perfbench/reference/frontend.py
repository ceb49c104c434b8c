"""The front end in plain NumPy (float64): Silero VAD v6, the speech
timestamps and chunks of faster-whisper's batched pipeline, and Whisper's
log-mel.

* Silero v6 (snakers4/silero-vad, the ONNX graph): per 512-sample window
  with the previous window's last 64 samples before it, a reflect pad of
  128, four 256-sample frames at stride 128 (the first of five dropped)
  through the STFT basis, magnitudes of 129 bins, four convolutions with
  ReLU (k3, strides 1 2 2 1, padding 1), an LSTM of 128 carried across the
  windows (gates in the ONNX order i, o, f, c), ReLU, a linear layer and a
  sigmoid. The weights are the ``.npz`` file both sides load.
* The timestamps, chunks and time map: faster-whisper ``vad.py``
  (``get_speech_timestamps``, ``collect_chunks``, ``SpeechTimestampsMap``).
* The log-mel: Whisper's, as faster-whisper's ``FeatureExtractor``
  computes it for one chunk: 160 zeros appended, a centred STFT (periodic
  Hann of 400, hop 160, reflect pad), the power of the last frame dropped,
  Slaney mel filters, log10 of at least 1e-10, a floor at the max less 8,
  (x + 4) / 4; the batched pipeline drops one more frame and pads to 3000.
"""

import bisect

from typing import List, Tuple

import numpy as np

SR = 16000
WINDOW = 512
CONTEXT = 64


# ---------------------------------------------------------------------------
# Silero VAD v6
# ---------------------------------------------------------------------------


def _conv1d(x, w, b, stride):
    """x (N, Cin, L), w (3, Cin, Cout): padding 1, as one matrix product."""
    n, cin, length = x.shape
    xp = np.pad(x, ((0, 0), (0, 0), (1, 1)))
    n_out = (length + 2 - 3) // stride + 1
    cols = np.stack([xp[:, :, t * stride : t * stride + 3] for t in range(n_out)], axis=1)  # (N, Lout, Cin, 3)
    w2 = w.transpose(1, 0, 2).reshape(cin * 3, -1)  # (Cin * 3, Cout), rows (c, k)
    y = cols.reshape(n * n_out, cin * 3) @ w2 + b
    return y.reshape(n, n_out, -1).transpose(0, 2, 1)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def vad_probs(audio: np.ndarray, weights: dict) -> np.ndarray:
    """Speech probability of each 512-sample window of ``audio`` (padded
    with zeros to a whole window past its end, a full one when it is
    already a multiple)."""
    w = {k: np.asarray(v, np.float64) for k, v in weights.items()}
    n = len(audio) // WINDOW + 1
    x = np.zeros(n * WINDOW)
    x[: len(audio)] = audio
    win = x.reshape(n, WINDOW)
    ctx = np.concatenate([np.zeros((1, CONTEXT)), win[:-1, -CONTEXT:]])
    full = np.pad(np.concatenate([ctx, win], axis=1), ((0, 0), (128, 128)), mode="reflect")  # (n, 832)
    frames = np.stack([full[:, 128 * (j + 1) : 128 * (j + 1) + 256] for j in range(4)], axis=1)
    spec = frames @ w["stft_basis"].T  # (n, 4, 258)
    h = np.sqrt(spec[..., :129] ** 2 + spec[..., 129:] ** 2).transpose(0, 2, 1)  # (n, 129, 4)
    for i, stride in enumerate((1, 2, 2, 1)):
        h = np.maximum(_conv1d(h, w[f"conv{i}_w"], w[f"conv{i}_b"], stride), 0.0)
    feats = h[:, :, 0]  # (n, 128)
    gx = feats @ w["lstm_w"].T + w["lstm_b"][:512] + w["lstm_b"][512:]  # (n, 512), gates i o f c
    r = w["lstm_r"]
    hs = np.empty((n, 128))
    ht, ct = np.zeros(128), np.zeros(128)
    for t in range(n):
        g = gx[t] + r @ ht
        i, o, f, c = g[:128], g[128:256], g[256:384], g[384:]
        ct = _sigmoid(f) * ct + _sigmoid(i) * np.tanh(c)
        ht = _sigmoid(o) * np.tanh(ct)
        hs[t] = ht
    logits = np.maximum(hs, 0.0) @ w["out_w"][0] + w["out_b"][0]
    return _sigmoid(logits)


def speech_timestamps(
    probs: np.ndarray,
    n_samples: int,
    threshold: float = 0.5,
    min_silence_ms: int = 160,
    max_speech_s: float = 30.0,
    speech_pad_ms: int = 400,
    min_speech_ms: int = 0,
) -> List[dict]:
    """{"start", "end"} sample spans of speech: the hysteresis over the
    window probabilities, then the padding (faster-whisper's defaults and
    the batched pipeline's 160 ms of silence and 30 s of speech)."""
    neg_threshold = max(threshold - 0.15, 0.01)
    min_speech = SR * min_speech_ms / 1000
    pad = SR * speech_pad_ms / 1000
    max_speech = SR * max_speech_s - WINDOW - 2 * pad
    min_silence = SR * min_silence_ms / 1000
    min_silence_at_max = SR * 98 / 1000

    speeches, current = [], {}
    triggered = False
    temp_end = prev_end = next_start = 0
    for i, p in enumerate(probs[: n_samples // WINDOW + 1]):
        pos = WINDOW * i
        if p >= threshold and temp_end:
            temp_end = 0
            if next_start < prev_end:
                next_start = pos
        if p >= threshold and not triggered:
            triggered = True
            current["start"] = pos
            continue
        if triggered and pos - current["start"] > max_speech:
            if prev_end:
                current["end"] = prev_end
                speeches.append(current)
                current = {}
                if next_start < prev_end:
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
            if pos - temp_end > min_silence_at_max:
                prev_end = temp_end
            if pos - temp_end < min_silence:
                continue
            current["end"] = temp_end
            if current["end"] - current["start"] > min_speech:
                speeches.append(current)
            current = {}
            prev_end = next_start = temp_end = 0
            triggered = False
            continue
    if current and (n_samples - current["start"]) > min_speech:
        current["end"] = n_samples
        speeches.append(current)

    for i, s in enumerate(speeches):
        if i == 0:
            s["start"] = int(max(0, s["start"] - pad))
        if i != len(speeches) - 1:
            gap = speeches[i + 1]["start"] - s["end"]
            if gap < 2 * pad:
                s["end"] += int(gap // 2)
                speeches[i + 1]["start"] = int(max(0, speeches[i + 1]["start"] - gap // 2))
            else:
                s["end"] = int(min(n_samples, s["end"] + pad))
                speeches[i + 1]["start"] = int(max(0, speeches[i + 1]["start"] - pad))
        else:
            s["end"] = int(min(n_samples, s["end"] + pad))
    return speeches


def chunks(spans: List[dict], max_s: float = 30.0) -> List[List[dict]]:
    """The spans of each chunk of at most ``max_s`` seconds of speech, in
    order. As in faster-whisper, the span that closes a chunk starts the
    next one's audio but is left out of its span list."""
    out, audio_spans, cur, dur = [], [], [], 0
    for s in spans:
        size = s["end"] - s["start"]
        if dur + size > max_s * SR:
            out.append((cur, audio_spans))
            cur, audio_spans, dur = [], [s], size
        else:
            cur.append(s)
            audio_spans.append(s)
            dur += size
    out.append((cur, audio_spans))
    return [a for _, a in out]


def chunk_offsets(chunk_spans: List[List[dict]]) -> List[Tuple[float, float]]:
    """(offset, duration) in seconds of each chunk in the speech-only
    timeline (the chunks laid end to end)."""
    out, total = [], 0
    for c in chunk_spans:
        size = sum(s["end"] - s["start"] for s in c)
        out.append((total / SR, size / SR))
        total += size
    return out


class TimeMap:
    """A time of the speech-only timeline mapped back to the original audio
    through the silence before its span, as faster-whisper's
    ``SpeechTimestampsMap`` does to a segment's rounded (0.001 s) start and
    end; the result is rounded to 0.01 s."""

    def __init__(self, spans: List[dict]):
        self.ends, self.silence_before = [], []
        prev_end = silent = 0
        for s in spans:
            silent += s["start"] - prev_end
            prev_end = s["end"]
            self.ends.append(s["end"] - silent)
            self.silence_before.append(silent / SR)

    def original(self, t: float, is_end: bool = False) -> float:
        t = round(t, 3)
        sample = int(t * SR)
        if is_end and sample in self.ends:
            i = self.ends.index(sample)
        else:
            i = min(bisect.bisect(self.ends, sample), len(self.ends) - 1)
        return round(self.silence_before[i] + t, 2)


# ---------------------------------------------------------------------------
# Log-mel
# ---------------------------------------------------------------------------


def mel_filters(n_mels: int, sr: int = SR, n_fft: int = 400) -> np.ndarray:
    """Slaney mel filters (librosa ``filters.mel(htk=False)``, the Slaney
    area normalisation), with Whisper's fmax of 8 kHz."""
    fft_freqs = np.fft.rfftfreq(n=n_fft, d=1.0 / sr)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    max_mel = min_log_mel + np.log(8000.0 / min_log_hz) / logstep
    mels = np.linspace(0.0, max_mel, n_mels + 2)
    freqs = f_sp * mels
    log_region = mels >= min_log_mel
    freqs[log_region] = min_log_hz * np.exp(logstep * (mels[log_region] - min_log_mel))
    fdiff = np.diff(freqs)
    ramps = freqs[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    return weights * (2.0 / (freqs[2 : n_mels + 2] - freqs[:n_mels]))[:, None]


def _log_power(x: np.ndarray, filters: np.ndarray, n_fft=400, hop=160) -> np.ndarray:
    """log10 mel power of a centred STFT of ``x``; the last frame dropped."""
    half = n_fft // 2
    xp = np.pad(x, (half, half), mode="reflect")
    n_frames = 1 + (len(xp) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    window = np.hanning(n_fft + 1)[:-1]
    spec = np.fft.rfft(xp[idx] * window, axis=1)[:-1]  # (frames - 1, 201)
    mel = (np.abs(spec) ** 2) @ filters.T
    return np.log10(np.maximum(mel, 1e-10)).T  # (n_mels, frames - 1)


def _scale(log_spec: np.ndarray) -> np.ndarray:
    return (np.maximum(log_spec, log_spec.max() - 8.0) + 4.0) / 4.0


def chunk_log_mel(chunk: np.ndarray, n_mels: int, n_frames: int = 3000) -> np.ndarray:
    """(n_mels, 3000) features of one batched-pipeline chunk."""
    x = np.concatenate([np.asarray(chunk, np.float64)[: n_frames * 160], np.zeros(160)])
    feats = _scale(_log_power(x, mel_filters(n_mels)))[:, :-1][:, :n_frames]
    return np.pad(feats, ((0, 0), (0, n_frames - feats.shape[1])))
