"""The port's ``decode_audio`` against the JAX package's built-in WAV/FLAC
path: ``docker/jfk.flac`` (44.1 kHz, stereo, 24-bit: decoded, mixed down
or split, resampled to 16 kHz) and WAV files written by the test (PCM 8,
16, 24 and 32 bits, IEEE float; mono and stereo; with and without
resampling).  The samples must be equal: both run the same numpy decoders
and the same ``scipy.signal.resample_poly``."""

import io
import os
import re
import subprocess

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


def test_other_containers_are_refused(monkeypatch):
    """With no backend for a compressed container (the libav shim fails to
    build, no ffmpeg CLI), ``decode_audio`` raises the JAX package's
    ``RuntimeError``, and names the shim's build error."""
    from faster_whisper_tpu_torch import media_native
    from faster_whisper_tpu_torch.ops import _build

    with open(os.path.join(ROOT, "tests", "data", "jfk.ogg"), "rb") as f:
        data = f.read()

    def no_libav(source):
        raise RuntimeError(f"native build failed:\n{source}: libavformat/avformat.h: No such file")

    monkeypatch.setattr(_build, "load", no_libav)
    monkeypatch.setattr(media_native, "_build_error", None)
    monkeypatch.setattr("faster_whisper_tpu_torch.audio._have_ffmpeg", lambda: False)
    with pytest.raises(RuntimeError, match=re.escape(JAX_NO_BACKEND)) as e:
        decode_audio(io.BytesIO(data))
    assert "media_decoder.cpp" in str(e.value) and "avformat.h" in str(e.value)


JAX_NO_BACKEND = (
    "decode_audio: the input is not WAV/FLAC and no decode backend is available for "
    "compressed formats (native libav shim failed to build/decode, no PyAV, no ffmpeg CLI)."
)
CONTAINERS = ("jfk.m4a", "jfk.ogg", "jfk.opus")


@pytest.fixture(scope="module")
def libav():
    """Skips where FFmpeg's headers or libraries are missing (the shim does
    not build)."""
    from faster_whisper_tpu_torch import media_native

    if media_native._load() is None:
        pytest.skip(f"no libav on this machine: {media_native._build_error}")


@pytest.mark.parametrize("name", CONTAINERS)
@pytest.mark.parametrize("source", ["path", "file-object"])
def test_containers_decode_bit_equal_to_the_jax_libav_shim(libav, name, source):
    """M4A (AAC), OGG (Vorbis) and Opus through the port's libav shim: the
    float32 PCM of the JAX package's ``decode_media_native``, bit for bit,
    mono and split into the two channels."""
    from faster_whisper_tpu.media_native import decode_media_native as jax_decode_media_native

    path = os.path.join(ROOT, "tests", "data", name)
    with open(path, "rb") as f:
        data = f.read()
    for split in (False, True):
        ours = decode_audio(path if source == "path" else io.BytesIO(data), split_stereo=split)
        ref = jax_decode_media_native(data, 16000, split)
        assert ref is not None and ref.dtype == np.float32
        if split:
            assert all(c.dtype == np.float32 for c in ours)
            np.testing.assert_array_equal(ours[0], ref[0::2])
            np.testing.assert_array_equal(ours[1], ref[1::2])
            assert len(ours[0]) == len(ref) // 2 > 16000
        else:
            assert ours.dtype == np.float32 and len(ours) > 16000
            np.testing.assert_array_equal(ours, ref)
            np.testing.assert_array_equal(ours, jax_decode_audio(path, sampling_rate=16000))


@pytest.mark.parametrize("split_stereo", [False, True], ids=["mono", "stereo"])
@pytest.mark.parametrize("source", ["path", "file-object"])
def test_ffmpeg_command_line_is_the_jax_packages(monkeypatch, split_stereo, source):
    """The ``ffmpeg`` fallback: the same argv and the same standard input
    in both packages (``subprocess.run`` replaced by a recorder that returns
    fixed s16le PCM), and the same samples."""
    import faster_whisper_tpu.audio as jax_audio
    import faster_whisper_tpu_torch.audio as port_audio

    pcm = (np.arange(-1600, 1600, dtype=np.int16) * 7).tobytes()
    calls = []

    def run(cmd, input=None, capture_output=False, check=False):
        calls.append((list(cmd), input, capture_output, check))
        return subprocess.CompletedProcess(cmd, 0, stdout=pcm, stderr=b"")

    path = os.path.join(ROOT, "tests", "data", "jfk.ogg")
    outs = []
    for module in (jax_audio, port_audio):
        monkeypatch.setattr(module.subprocess, "run", run)
        if source == "path":
            outs.append(module._decode_audio_ffmpeg(path, 22050, split_stereo))
        else:
            # the whole chain: the shim declines, the CLI is on PATH
            monkeypatch.setattr(module, "_have_ffmpeg", lambda: True)
            if module is jax_audio:
                monkeypatch.setattr("faster_whisper_tpu.media_native.decode_media_native", lambda *a: None)
            else:
                monkeypatch.setattr("faster_whisper_tpu_torch.media_native.decode_media_native",
                                    lambda *a: (None, "declined"))
            with open(path, "rb") as f:
                outs.append(module.decode_audio(f, sampling_rate=22050, split_stereo=split_stereo))
    assert len(calls) == 2 and calls[0] == calls[1]
    cmd = calls[0][0]
    assert cmd[0] == "ffmpeg" and cmd[cmd.index("-ac") + 1] == ("2" if split_stereo else "1")
    assert cmd[cmd.index("-i") + 1] == (path if source == "path" else "pipe:0")
    ref, ours = outs
    for a, b in zip(ref if split_stereo else [ref], ours if split_stereo else [ours]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_the_default_build_leaves_out_the_libav_shim(tmp_path, monkeypatch):
    """``_build.build()`` with no argument builds every source but the
    libav shim (the card's machine lacks FFmpeg's headers), the VAD's state
    machine included; the shim, built on its own, links FFmpeg's libraries
    after its source."""
    from faster_whisper_tpu_torch.ops import _build

    commands = []

    class FakeCompiler:
        def __init__(self, cmd, **kwargs):
            commands.append(cmd)
            open(cmd[cmd.index("-o") + 1], "wb").close()
            self.returncode = 0

        def communicate(self):
            return "", None

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.subprocess, "Popen", FakeCompiler)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_gxx", lambda: "g++")
    logs = _build.build()
    built = {os.path.basename(c[c.index("-o") + 2]) for c in commands}
    assert built == set(logs) == set(_build.SIGNATURES) - {"media_decoder.cpp"}
    assert "vad_sm.cpp" in built
    commands.clear()
    _build.build(["media_decoder.cpp"])
    (cmd,) = commands
    assert cmd[0] == "g++" and cmd[-4:] == ["-lavformat", "-lavcodec", "-lavutil", "-lswresample"]
    assert cmd[-5].endswith("csrc/media_decoder.cpp")
