"""Whisper log-mel feature extraction, on the host in numpy or on the
device.

The port's own copy of ``faster_whisper_tpu/feature_extractor.py`` and the
log-mel part of ``faster_whisper_tpu/ops/mel.py``, with the same numerics
contract: a periodic Hann window, reflect padding of n_fft//2 on both
sides, hop 160, a real 400-point DFT (201 bins) written as two float32
matrix products with the window folded into the basis, Slaney mel
filters, ``log10(clip(mel, 1e-10))`` clamped at the global max minus 8 over
the valid frames, then ``(x + 4) / 4``.  The waveform is zero-padded to the
same 1500-frame buckets as the JAX package, so the frames at the ragged
end read the same samples.  ``__call__(..., return_device=True)`` computes
the same on the extractor's ``device`` (``ops/mel.py::
log_mel_spectrogram``), and ``chunk_features``, the batched pipeline's
per-chunk features, on its audio's device (``ops/mel.py::
chunked_log_mel``).
"""

import numpy as np
import torch

from faster_whisper_tpu_torch.utils import resolve_device, span

_BUCKET_FRAMES = 1500


def hann_window(n_fft: int) -> np.ndarray:
    """The periodic Hann window used by Whisper: np.hanning(n_fft+1)[:-1]."""
    return np.hanning(n_fft + 1)[:-1].astype(np.float32)


def dft_basis(n_fft: int, window: np.ndarray):
    """Real-DFT basis (n_fft, n_fft//2 + 1) with the window folded in:
    ``frames @ cos_b + 1j * frames @ sin_b == rfft(window * frames)``."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    angle = -2.0 * np.pi * n * k / n_fft
    cos_b = (np.cos(angle) * window[:, None]).astype(np.float32)
    sin_b = (np.sin(angle) * window[:, None]).astype(np.float32)
    return cos_b, sin_b


class FeatureExtractor:
    def __init__(
        self,
        feature_size=80,
        sampling_rate=16000,
        hop_length=160,
        chunk_length=30,
        n_fft=400,
    ):
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.chunk_length = chunk_length
        self.n_samples = chunk_length * sampling_rate
        self.nb_max_frames = self.n_samples // hop_length
        self.time_per_frame = hop_length / sampling_rate
        self.sampling_rate = sampling_rate
        self.feature_size = feature_size
        self.mel_filters = self.get_mel_filters(
            sampling_rate, n_fft, n_mels=feature_size
        ).astype(np.float32)
        self._cos_b, self._sin_b = dft_basis(n_fft, hann_window(n_fft))
        self._device_constants = {}
        # where ``return_device=True`` computes: "auto" is the card (and
        # raises without one); ``WhisperModel`` sets its own device here
        self.device = "auto"

    @staticmethod
    def get_mel_filters(sr, n_fft, n_mels=128):
        """Slaney-scale mel filterbank (librosa ``filters.mel(...,
        htk=False)``, with the reference's hardcoded max_mel)."""
        n_mels = int(n_mels)
        fft_freqs = np.fft.rfftfreq(n=n_fft, d=1.0 / sr)

        max_mel = 45.245640471924965
        mels = np.linspace(0.0, max_mel, n_mels + 2)

        # Slaney: linear below 1 kHz, logarithmic above.
        f_sp = 200.0 / 3
        freqs = f_sp * mels
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        log_region = mels >= min_log_mel
        freqs[log_region] = min_log_hz * np.exp(
            logstep * (mels[log_region] - min_log_mel)
        )

        fdiff = np.diff(freqs)
        ramps = freqs[:, None] - fft_freqs[None, :]
        lower = -ramps[:-2] / fdiff[:-1, None]
        upper = ramps[2:] / fdiff[1:, None]
        weights = np.maximum(0.0, np.minimum(lower, upper))

        # Constant-energy (Slaney) normalization per channel.
        enorm = 2.0 / (freqs[2 : n_mels + 2] - freqs[:n_mels])
        weights *= enorm[:, None]

        return weights

    def _constants(self, device):
        """The filterbank and DFT bases on ``device``, staged once per
        device."""
        key = str(device)
        if key not in self._device_constants:
            self._device_constants[key] = tuple(
                torch.as_tensor(a, device=device)
                for a in (self.mel_filters, self._cos_b, self._sin_b)
            )
        return self._device_constants[key]

    def __call__(self, waveform, padding=160, chunk_length=None, return_device=False):
        """Normalized log-mel spectrogram of a 1-D waveform: float32
        (n_mels, n_frames), n_frames = (len(waveform) + padding) // hop.
        A numpy array computed on the host, or with ``return_device`` a
        tensor on the extractor's ``device`` (the sequential path keeps
        the whole file's features there).  ``chunk_length`` overrides the
        window length for this and later calls, as the reference's
        extractor does."""
        if chunk_length is not None:
            self.n_samples = chunk_length * self.sampling_rate
            self.nb_max_frames = self.n_samples // self.hop_length

        if return_device:
            from faster_whisper_tpu_torch.ops.mel import log_mel_spectrogram

            mel_filters, cos_b, sin_b = self._constants(resolve_device(self.device))
            return log_mel_spectrogram(
                waveform, mel_filters, cos_b, sin_b,
                n_fft=self.n_fft, hop_length=self.hop_length, padding=padding,
                bucket_frames=_BUCKET_FRAMES,
            )

        waveform = np.asarray(waveform, dtype=np.float32)
        hop, n_fft = self.hop_length, self.n_fft
        n_valid = (len(waveform) + padding) // hop
        # Buckets of k*1500 + 1 frames: a 30 s window is exactly 3001.
        n_bucketed = (
            max(1, -(-max(n_valid - 1, 1) // _BUCKET_FRAMES)) * _BUCKET_FRAMES + 1
        )
        buf = np.zeros(n_bucketed * hop, dtype=np.float32)
        buf[: len(waveform)] = waveform

        half = n_fft // 2
        x = np.pad(buf, (half, half + hop), mode="reflect")
        # contiguous: numpy's matmul leaves BLAS for the strided view
        frames = np.ascontiguousarray(
            np.lib.stride_tricks.sliding_window_view(x, n_fft)[::hop][:n_valid]
        )

        re = frames @ self._cos_b
        im = frames @ self._sin_b
        power = re * re + im * im  # (T, n_bins)
        mel = power @ self.mel_filters.T

        log_spec = np.log10(np.maximum(mel, np.float32(1e-10)))
        log_spec = np.maximum(log_spec, log_spec.max() - np.float32(8.0))
        log_spec = (log_spec + np.float32(4.0)) / np.float32(4.0)
        return np.ascontiguousarray(log_spec.T, dtype=np.float32)

    def chunk_features(self, audio: torch.Tensor, starts, lengths) -> torch.Tensor:
        """Per-chunk features for the batched pipeline, on ``audio``'s
        device.

        Equivalent to ``[self(audio[s:s+l])[..., :-1]`` zero-padded to the
        30 s window ``for s, l in zip(starts, lengths)]`` (reference:
        transcribe.py:463-467 + :514-516).  Returns a (N, n_mels,
        nb_max_frames) float32 tensor; the call is the span ``fwt.mel``."""
        from faster_whisper_tpu_torch.ops.mel import chunked_log_mel

        with span("fwt.mel"):
            mel_filters, cos_b, sin_b = self._constants(audio.device)
            return chunked_log_mel(
                audio, starts, lengths, mel_filters, cos_b, sin_b,
                n_fft=self.n_fft, hop_length=self.hop_length, n_frames_win=self.nb_max_frames,
            )
