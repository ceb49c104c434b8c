"""Log-mel features and PCM on the device.

Counterpart of ``faster_whisper_tpu/ops/mel.py``:

- ``upload_audio``: the one host->device PCM transfer of the batched
  pipeline, on the int16 grid;
- ``assemble_segments``: the speech concat, cut from that device copy;
- ``chunked_log_mel``: the batched pipeline's per-chunk log-mel, one
  windowed DFT (two matmuls, summed in float64) over every chunk;
- ``log_mel_spectrogram``: the sequential path's whole-file log-mel;
- ``extract_window``: one seek window of the sequential loop's features.

The JAX package's length and chunk-count buckets bound its XLA programs;
they do not change a real chunk's output and are not ported.  The
whole-file log-mel keeps its 1500-frame bucket: the zeros it adds are
what the last valid frames' reflect padding reads.
"""

import os

import numpy as np
import torch
import torch.nn.functional as F

from faster_whisper_tpu_torch.utils import exact_float32

_MEL_SLAB = 8  # chunks per DFT: bounds the frame buffers to ~0.2 GB in float64
_FRAME_SLAB = 32768  # frames per DFT of the whole-file log-mel: ~0.2 GB in float64


def upload_audio(buf: np.ndarray, device) -> torch.Tensor:
    """Host->device PCM on the int16 grid: ``round(x * 32768)`` clipped to
    int16 crosses as int16 (half the bytes) and becomes ``q / 32768`` in
    float32 on ``device``.  Exact for s16-derived sources, within half a
    step of 1/32768 elsewhere; the JAX package's default transfer.  Under
    ``FWT_I16_TRANSFER=0`` the samples cross as float32, unchanged."""
    if os.environ.get("FWT_I16_TRANSFER", "1") == "0":
        return torch.from_numpy(np.asarray(buf, np.float32)).to(device)
    q = np.clip(np.round(np.asarray(buf) * 32768.0), -32768, 32767).astype(np.int16)
    return torch.from_numpy(q).to(device).to(torch.float32) * (1.0 / 32768.0)


def assemble_segments(audio_dev: torch.Tensor, spans) -> torch.Tensor:
    """Device-side ``np.concatenate([audio[s:e] for s, e in spans])``: the
    batched pipeline's speech concat, cut from the uploaded audio instead
    of shipping a second copy."""
    pieces = [audio_dev[int(s) : int(e)] for s, e in spans if int(e) > int(s)]
    if not pieces:
        return audio_dev.new_zeros(0)
    return torch.cat(pieces)


def _log_spectrum(frames, mel_filters, cos_basis, sin_basis):
    """``log10(clip(mel power, 1e-10))`` of (..., n_fft) float32 frames:
    the windowed DFT as two matmuls, the mel product; (..., n_mels) in
    float32.  The core of both device log-mels; the caller holds
    ``utils.exact_float32``.

    The DFT's products sum in float64 over the float32 frames and bases,
    the rest runs in float32.  A bin that a louder neighbour leaks into is
    a sum of 400 terms that nearly cancel: on an H100, cuBLAS's float32
    sums left the whole-file log-mel 1.120e-04 from the float64 sum of the
    same frames, past the 1e-4 that the port holds it to, where the host's
    were 3.4e-05 (``chip_smoke.py`` phase 15)."""
    re = frames.double() @ cos_basis.double()
    im = frames.double() @ sin_basis.double()
    mel = (re * re + im * im).float() @ mel_filters.T
    return torch.log10(torch.clamp(mel, min=1e-10))


def _normalize(log_spec, gmax):
    """Whisper's scale of a log spectrum whose max is ``gmax``: clamped at
    gmax - 8, then (x + 4) / 4."""
    return (torch.maximum(log_spec, gmax - 8.0) + 4.0) / 4.0


def chunked_log_mel(
    audio: torch.Tensor,
    starts,
    lengths,
    mel_filters: torch.Tensor,
    cos_basis: torch.Tensor,
    sin_basis: torch.Tensor,
    n_fft: int = 400,
    hop_length: int = 160,
    n_frames_win: int = 3000,
    padding: int = 160,
) -> torch.Tensor:
    """(N, n_mels, n_frames_win) per-chunk features on ``audio``'s device.

    For every chunk ``audio[s:s+l]`` the reference's
    ``FeatureExtractor(chunk)[..., :-1]`` zero-padded to the window
    (reference: transcribe.py:463-467): a zero tail of ``padding``
    samples, the chunk end mirrored in place (a reflect pad), the windowed
    DFT as two matmuls (``_log_spectrum``), mel filters, ``log10(clip(., 1e-10))``,
    the chunk's own global max over its (l + padding) // hop frames, a
    clamp at max - 8, (x + 4) / 4, and zeros past the chunk's frames.
    Chunks longer than the window are cut to it.
    """
    dev = audio.device
    half = n_fft // 2
    n_fft_win = n_frames_win * hop_length
    W = n_fft_win + padding  # samples per chunk window
    starts = [int(s) for s in starts]
    lengths = [min(int(n), n_fft_win) for n in lengths]
    # every chunk reads W samples; reads past the end see zeros
    audio = F.pad(audio.to(torch.float32), (0, W))
    pos = torch.arange(W, device=dev)
    k = torch.arange(half, device=dev)
    frame_ids = torch.arange(n_frames_win + 1, device=dev)

    out = []
    with torch.no_grad(), exact_float32():
        for i in range(0, len(starts), _MEL_SLAB):
            length = torch.tensor(lengths[i : i + _MEL_SLAB], device=dev)
            plen = length + padding  # the chunk and its zero tail
            core = torch.stack([audio[s : s + W] for s in starts[i : i + _MEL_SLAB]])
            core = torch.where(pos[None] < length[:, None], core, 0.0)

            # reflect pad: the left mirror is fixed, the right one sits at
            # each chunk's own end (its source start clamped at 0, as the
            # JAX package's dynamic slice is)
            src0 = torch.clamp(plen - half - 1, min=0)
            right = core.gather(1, src0[:, None] + half - 1 - k[None])
            full = torch.cat([core[:, 1 : half + 1].flip(1), core, core.new_zeros(len(core), half)], 1)
            full.scatter_(1, half + plen[:, None] + k[None], right)

            frames = full.unfold(1, n_fft, hop_length)[:, : n_frames_win + 1]  # (n, T+1, n_fft)
            log_spec = _log_spectrum(frames, mel_filters, cos_basis, sin_basis)  # (n, T+1, n_mels)

            n_frames_chunk = plen // hop_length  # the dropped last frame included
            in_chunk = frame_ids[None, :, None] < n_frames_chunk[:, None, None]
            gmax = torch.where(in_chunk, log_spec, -torch.inf).amax(dim=(1, 2))
            log_spec = _normalize(log_spec, gmax[:, None, None])

            keep = frame_ids[None, :, None] < torch.clamp(n_frames_chunk - 1, min=0)[:, None, None]
            log_spec = torch.where(keep, log_spec, 0.0)
            out.append(log_spec[:, :n_frames_win].transpose(1, 2))
    if not out:
        return torch.zeros((0, mel_filters.shape[0], n_frames_win), device=dev)
    return torch.cat(out).contiguous()


def log_mel_spectrogram(
    waveform,
    mel_filters: torch.Tensor,
    cos_basis: torch.Tensor,
    sin_basis: torch.Tensor,
    n_fft: int = 400,
    hop_length: int = 160,
    padding: int = 160,
    bucket_frames: int = 1500,
) -> torch.Tensor:
    """(n_mels, n_valid) float32 log-mel of a 1-D waveform (numpy or a
    tensor) on the constants' device, n_valid = (len + padding) // hop.

    As the JAX package's (its ``_log_mel_impl``): the waveform zero-padded
    to ``n_bucketed * hop`` samples, n_bucketed = k * bucket_frames + 1
    frames, reflect-padded by (n_fft // 2, n_fft // 2 + hop), frames at
    stride hop, then ``chunked_log_mel``'s core (``_log_spectrum``)
    and the global max over the valid frames (``_normalize``).  The
    bucket's zeros are what the last valid frames' reflect padding reads,
    so it is kept.  The spectrum is computed over slabs of frames (each
    frame alone, so no value changes), which bounds the frame buffers on
    long files."""
    dev = mel_filters.device
    x = torch.as_tensor(waveform, dtype=torch.float32, device=dev)
    n_valid = (x.shape[0] + padding) // hop_length
    n_bucketed = max(1, -(-max(n_valid - 1, 1) // bucket_frames)) * bucket_frames + 1
    half = n_fft // 2
    buf = F.pad(x, (0, n_bucketed * hop_length - x.shape[0]))
    full = F.pad(buf[None], (half, half + hop_length), mode="reflect")[0]
    frames = full.unfold(0, n_fft, hop_length)  # (n_bucketed + 2, n_fft), a view
    out = torch.empty((mel_filters.shape[0], n_valid), dtype=torch.float32, device=dev)
    with torch.no_grad(), exact_float32():
        for s in range(0, n_valid, _FRAME_SLAB):
            slab = frames[s : min(s + _FRAME_SLAB, n_valid)]
            out[:, s : s + slab.shape[0]] = _log_spectrum(slab, mel_filters, cos_basis, sin_basis).T
        return _normalize(out, out.max()) if n_valid else out


def extract_window(
    features_padded: torch.Tensor,  # (n_mels, F + n_frames), zero-padded
    seek: int,  # start frame
    segment_size: int,  # valid frames in the window
    n_frames: int,  # window length (3000)
) -> torch.Tensor:
    """One seek window of the features, zero past ``segment_size`` (the
    sequential loop's ``pad_or_trim(features[:, seek:seek+segment_size])``),
    sliced on the device that holds the features."""
    w = features_padded[:, seek : seek + n_frames]
    keep = torch.arange(n_frames, device=w.device) < segment_size
    return torch.where(keep[None, :], w, torch.zeros((), dtype=w.dtype, device=w.device))
