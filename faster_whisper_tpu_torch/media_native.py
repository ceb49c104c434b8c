"""The native libav media decoder: every container and codec FFmpeg's C
libraries read (MP3, M4A/AAC, OGG, Opus, WebM, ...).

Counterpart of ``faster_whisper_tpu/media_native.py``.  The library
(``csrc/media_decoder.cpp``) links libavformat, libavcodec, libavutil and
libswresample; ``ops/_build.py`` builds it with ``g++`` at first use,
outside the default build set, since a machine may lack FFmpeg's headers.
Where the JAX package's ``decode_media_native`` returns None when the
library cannot be built or the buffer cannot be decoded, the port's
returns None and the reason, so that ``decode_audio`` can try its next
backend and name the cause when none is left.
"""

import ctypes
import threading

from typing import Optional, Tuple

import numpy as np

_SOURCE = "media_decoder.cpp"
_lock = threading.Lock()
_build_error: Optional[str] = None


def _load():
    """The loaded library, or None after a failed build (remembered: the
    build is tried once per process)."""
    global _build_error
    from faster_whisper_tpu_torch.ops import _build

    with _lock:
        if _build_error is not None:
            return None
        try:
            return _build.load(_SOURCE)
        except (RuntimeError, OSError) as e:
            _build_error = f"the libav shim ({_SOURCE}) failed to build or load: {e}"
            return None


def decode_media_native(
    data: bytes, sampling_rate: int, stereo: bool
) -> Tuple[Optional[np.ndarray], Optional[str]]:
    """Decode an FFmpeg-readable media buffer to float32 PCM in [-1, 1):
    shape (frames,) for mono, or (frames * 2,) with L and R interleaved for
    stereo.  Returns (PCM, None), or (None, the reason) when the library is
    unavailable or the buffer cannot be decoded."""
    lib = _load()
    if lib is None:
        return None, _build_error
    channels = 2 if stereo else 1
    samples = ctypes.POINTER(ctypes.c_int16)()
    n = ctypes.c_int64()
    rc = lib.fwt_media_decode(
        data, len(data), int(sampling_rate), channels, ctypes.byref(samples), ctypes.byref(n)
    )
    if rc != 0:
        return None, f"the libav shim could not decode the input (code {rc})"
    try:
        arr = np.ctypeslib.as_array(samples, shape=(n.value * channels,)).astype(np.float32)
    finally:
        lib.fwt_media_free(samples)
    return arr / 32768.0, None
