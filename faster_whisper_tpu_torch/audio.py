"""Audio decoding and mel-frame padding.

The port's copy of ``faster_whisper_tpu/audio.py``: a media file, or a
file-like object holding one, becomes float32 PCM at the requested
sampling rate, mixed down to mono or split into its two channels.  The
backends, tried in the JAX package's order (PyAV, its first, is not
ported):

1. the built-in WAV and FLAC decoders (FLAC through the native decoder,
   ``flac.py::decode_flac_native``), resampled by
   ``scipy.signal.resample_poly``;
2. the native libav shim (``media_native.py``, ``csrc/media_decoder.cpp``
   linked against the system FFmpeg libraries) for every other container
   and codec;
3. the ``ffmpeg`` command line, when it is on PATH.

When none of them decodes the input, ``decode_audio`` raises the JAX
package's ``RuntimeError``, with the shim's build or decode error added.
"""

import io
import os
import shutil
import subprocess

from typing import BinaryIO, Union

import numpy as np


def decode_audio(
    input_file: Union[str, BinaryIO],
    sampling_rate: int = 16000,
    split_stereo: bool = False,
):
    """Decodes the audio.

    Args:
      input_file: Path to the input file or a file-like object.
      sampling_rate: Resample the audio to this sample rate.
      split_stereo: Return separate left and right channels.

    Returns:
      A float32 Numpy array.

      If `split_stereo` is enabled, the function returns a 2-tuple with the
      separated left and right channels.
    """
    if isinstance(input_file, (str, os.PathLike)):
        with open(input_file, "rb") as f:
            data = f.read()
    else:
        data = input_file.read()

    # WAV/FLAC take the built-in decoders; everything else goes through the
    # native libav shim, then the ffmpeg CLI as a last resort.
    if data[:4] in (b"RIFF", b"fLaC"):
        return _decode_audio_builtin(data, sampling_rate, split_stereo)

    from faster_whisper_tpu_torch.media_native import decode_media_native

    audio, why = decode_media_native(data, sampling_rate, split_stereo)
    if audio is not None:
        if split_stereo:
            return audio[0::2], audio[1::2]
        return audio

    if _have_ffmpeg():
        return _decode_audio_ffmpeg(io.BytesIO(data), sampling_rate, split_stereo)

    raise RuntimeError(
        "decode_audio: the input is not WAV/FLAC and no decode backend is "
        "available for compressed formats (native libav shim failed to "
        f"build/decode, no PyAV, no ffmpeg CLI). {why}"
    )


def pad_or_trim(array, length: int = 3000, *, axis: int = -1):
    """Pad or trim mel features to ``length`` frames (3000 = 30 s), as the
    encoder expects.  A numpy array is padded on the host, a tensor on its
    device."""
    if array.shape[axis] > length:
        sl = [slice(None)] * array.ndim
        sl[axis] = slice(0, length)
        array = array[tuple(sl)]

    if array.shape[axis] < length:
        if isinstance(array, np.ndarray):
            pad_widths = [(0, 0)] * array.ndim
            pad_widths[axis] = (0, length - array.shape[axis])
            array = np.pad(array, pad_widths)
        else:
            import torch.nn.functional as F

            # F.pad's widths run from the last axis back
            pad = [0, 0] * (array.ndim - axis % array.ndim)
            pad[-1] = length - array.shape[axis]
            array = F.pad(array, pad)

    return array


def _have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def _decode_audio_ffmpeg(input_file, sampling_rate, split_stereo):
    """Decode through the ``ffmpeg`` command line to s16le PCM at
    ``sampling_rate``, the JAX package's command."""
    channels = 2 if split_stereo else 1
    cmd = [
        "ffmpeg",
        "-nostdin",
        "-threads",
        "0",
        "-i",
        "pipe:0" if not isinstance(input_file, (str, os.PathLike)) else str(input_file),
        "-f",
        "s16le",
        "-ac",
        str(channels),
        "-acodec",
        "pcm_s16le",
        "-ar",
        str(sampling_rate),
        "pipe:1",
    ]
    if isinstance(input_file, (str, os.PathLike)):
        out = subprocess.run(cmd, capture_output=True, check=True).stdout
    else:
        data = input_file.read()
        out = subprocess.run(cmd, input=data, capture_output=True, check=True).stdout

    audio = np.frombuffer(out, dtype=np.int16).astype(np.float32) / 32768.0

    if split_stereo:
        return audio[0::2], audio[1::2]

    return audio


def _decode_audio_builtin(data, sampling_rate, split_stereo):
    if data[:4] == b"RIFF":
        samples, rate = _read_wav(data)
    else:
        from faster_whisper_tpu_torch.flac import decode_flac_native

        samples, rate = decode_flac_native(data)

    # samples: float32 (num_samples, channels) in [-1, 1)
    if samples.ndim == 1:
        samples = samples[:, None]

    # Mix down before resampling when mono output is requested: halves the
    # polyphase filtering work for stereo inputs.
    if not split_stereo:
        samples = samples.mean(axis=1, keepdims=True) if samples.shape[1] > 1 else samples

    if rate != sampling_rate:
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(rate, sampling_rate)
        samples = resample_poly(samples, sampling_rate // g, rate // g, axis=0).astype(np.float32)

    if split_stereo:
        left = samples[:, 0]
        right = samples[:, 1] if samples.shape[1] > 1 else samples[:, 0]
        return np.ascontiguousarray(left), np.ascontiguousarray(right)

    return np.ascontiguousarray(samples[:, 0].astype(np.float32))


def _read_wav(data: bytes):
    """Minimal RIFF/WAVE reader: PCM 8/16/24/32-bit and IEEE float."""
    if data[8:12] != b"WAVE":
        raise ValueError("not a WAVE file")
    pos = 12
    fmt = None
    pcm = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        size = int.from_bytes(data[pos + 4 : pos + 8], "little")
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = body
        elif chunk_id == b"data":
            pcm = body
        pos += 8 + size + (size & 1)
    if fmt is None or pcm is None:
        raise ValueError("malformed WAVE file")

    audio_format = int.from_bytes(fmt[0:2], "little")
    channels = int.from_bytes(fmt[2:4], "little")
    rate = int.from_bytes(fmt[4:8], "little")
    bits = int.from_bytes(fmt[14:16], "little")
    if audio_format == 0xFFFE and len(fmt) >= 26:
        # WAVE_FORMAT_EXTENSIBLE: subformat GUID starts with the format tag
        audio_format = int.from_bytes(fmt[24:26], "little")

    if audio_format == 3:  # IEEE float
        dtype = np.float32 if bits == 32 else np.float64
        samples = np.frombuffer(pcm, dtype=dtype).astype(np.float32)
    elif audio_format == 1:
        if bits == 8:
            samples = (np.frombuffer(pcm, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            samples = np.frombuffer(pcm, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(pcm, dtype=np.uint8).reshape(-1, 3)
            val = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            val = (val << 8) >> 8  # sign-extend
            samples = val.astype(np.float32) / 8388608.0
        elif bits == 32:
            samples = np.frombuffer(pcm, dtype="<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"unsupported WAV bit depth: {bits}")
    else:
        raise ValueError(f"unsupported WAV format tag: {audio_format}")

    n = (len(samples) // channels) * channels
    samples = samples[:n].reshape(-1, channels)
    return samples, rate
