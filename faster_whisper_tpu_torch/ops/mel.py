"""Per-window slicing of device-resident features.

Counterpart of ``faster_whisper_tpu/ops/mel.py::extract_window``; the
log-mel itself runs on the host (``feature_extractor.py``).
"""

import torch


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
