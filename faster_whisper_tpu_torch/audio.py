"""Audio-array helpers.

Audio reaches the port as a float32 mono array at 16 kHz: decoding files
(PyAV, ffmpeg, the native FLAC/WAV readers) is not ported.
"""

import numpy as np


def pad_or_trim(array: np.ndarray, length: int = 3000, *, axis: int = -1) -> np.ndarray:
    """Pad or trim mel features to ``length`` frames (3000 = 30 s), as the
    encoder expects."""
    if array.shape[axis] > length:
        sl = [slice(None)] * array.ndim
        sl[axis] = slice(0, length)
        array = array[tuple(sl)]

    if array.shape[axis] < length:
        pad_widths = [(0, 0)] * array.ndim
        pad_widths[axis] = (0, length - array.shape[axis])
        array = np.pad(array, pad_widths)

    return array
