"""The port's ``decode_audio`` against the JAX package's built-in WAV/FLAC
path: ``docker/jfk.flac`` (44.1 kHz, stereo, 24-bit: decoded, mixed down
or split, resampled to 16 kHz) and WAV files written by the test (PCM 8,
16, 24 and 32 bits, IEEE float; mono and stereo; with and without
resampling).  The samples must be equal: both run the same numpy decoders
and the same ``scipy.signal.resample_poly``."""

import io
import os

import numpy as np
import pytest

import jax  # noqa: F401  (test files import both frameworks)
import torch  # noqa: F401

from faster_whisper_tpu.audio import decode_audio as jax_decode_audio
from faster_whisper_tpu_torch import decode_audio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JFK = os.path.join(ROOT, "docker", "jfk.flac")


def wav_bytes(samples: np.ndarray, rate: int, bits: int, fmt: int = 1) -> bytes:
    """A RIFF/WAVE file of ``samples`` (frames, channels) in [-1, 1)."""
    channels = samples.shape[1]
    if fmt == 3:
        data = samples.astype(np.float32 if bits == 32 else np.float64).tobytes()
    elif bits == 8:
        data = np.clip(np.round(samples * 128 + 128), 0, 255).astype(np.uint8).tobytes()
    else:
        scale = 2 ** (bits - 1)
        ints = np.clip(np.round(samples * scale), -scale, scale - 1).astype("<i4")
        if bits == 16:
            ints = ints.astype("<i2")
        # 24-bit: the three low bytes of each little-endian int32
        data = (ints.view(np.uint8).reshape(-1, 4)[:, :3] if bits == 24 else ints).tobytes()
    block = channels * bits // 8
    fmt_chunk = (
        fmt.to_bytes(2, "little") + channels.to_bytes(2, "little") + rate.to_bytes(4, "little")
        + (rate * block).to_bytes(4, "little") + block.to_bytes(2, "little")
        + bits.to_bytes(2, "little")
    )
    body = b"WAVE" + b"fmt " + len(fmt_chunk).to_bytes(4, "little") + fmt_chunk
    body += b"data" + len(data).to_bytes(4, "little") + data
    return b"RIFF" + len(body).to_bytes(4, "little") + body


@pytest.fixture(scope="module")
def jfk_decoded():
    """(port mono, JAX mono, port split, JAX split) of jfk.flac."""
    return (
        decode_audio(JFK), jax_decode_audio(JFK),
        decode_audio(JFK, split_stereo=True), jax_decode_audio(JFK, split_stereo=True),
    )


def test_flac_mono_matches_jax(jfk_decoded):
    ours, ref = jfk_decoded[:2]
    assert ours.dtype == np.float32 and ours.shape == ref.shape == (176000,)
    np.testing.assert_array_equal(ours, ref)


def test_flac_split_stereo_matches_jax(jfk_decoded):
    ours, ref = jfk_decoded[2], jfk_decoded[3]
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert a.dtype == np.float32 and a.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(a, b)
    # the file really holds two different channels
    assert not np.array_equal(ours[0], ours[1])


def test_flac_from_a_file_object(jfk_decoded):
    with open(JFK, "rb") as f:
        data = f.read()
    np.testing.assert_array_equal(decode_audio(io.BytesIO(data)), jfk_decoded[0])


@pytest.mark.parametrize(
    "rate,bits,fmt,channels",
    [
        (16000, 16, 1, 1),
        (22050, 16, 1, 2),
        (44100, 24, 1, 2),
        (8000, 8, 1, 1),
        (48000, 32, 1, 1),
        (16000, 32, 3, 2),
        (24000, 64, 3, 1),
    ],
    ids=["s16-16k-mono", "s16-22k-stereo", "s24-44k-stereo", "u8-8k", "s32-48k", "f32-16k-stereo",
         "f64-24k"],
)
@pytest.mark.parametrize("split_stereo", [False, True], ids=["mono", "split"])
def test_wav_matches_jax(tmp_path, rate, bits, fmt, channels, split_stereo):
    rng = np.random.default_rng(rate + bits)
    t = np.arange(int(0.6 * rate)) / rate
    samples = np.stack(
        [0.4 * np.sin(2 * np.pi * (300 + 150 * c) * t) + 0.05 * rng.standard_normal(t.size)
         for c in range(channels)], axis=1,
    )
    path = tmp_path / "clip.wav"
    path.write_bytes(wav_bytes(samples, rate, bits, fmt))
    ours = decode_audio(str(path), split_stereo=split_stereo)
    ref = jax_decode_audio(str(path), split_stereo=split_stereo)
    if split_stereo:
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
        ours = ours[0]
    else:
        np.testing.assert_array_equal(ours, ref)
    assert ours.dtype == np.float32 and abs(len(ours) - 0.6 * 16000) <= 1


def test_other_containers_are_refused():
    """MP3, M4A, OGG and the rest need FFmpeg's libraries: refused, naming
    the ROADMAP.md item, with no silent fallback."""
    with open(os.path.join(ROOT, "tests", "data", "jfk.ogg"), "rb") as f:
        data = f.read()
    with pytest.raises(NotImplementedError, match=r"\(ROADMAP\.md, Queue 1 item 10\)"):
        decode_audio(io.BytesIO(data))
