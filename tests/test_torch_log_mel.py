"""The sequential path's whole-file log-mel on the device
(``ops/mel.py::log_mel_spectrogram``, ``FeatureExtractor(...,
return_device=True)``) against the JAX package's, here on CPU tensors.

The same waveforms, made with numpy from a seed, go through the JAX
``log_mel_spectrogram`` and the port's, at 80 and 128 mels, at lengths on
both sides of the 1500-frame buckets (479990, 480000 and 480150 samples:
the bucket decides what the last frames' reflect padding reads), at 45 s,
150 s and one length whose frames cross the port's slab of 32768 frames.
Each must be within ``MEL_TOL`` of the JAX package's and of the port's
host path.  Those sum the DFT's 400 terms in float32, the device path
(as the port's chunked log-mel) in float64, and a bin that a louder one
leaks into is a sum that nearly cancels, so the device and the host path
are also held to a float64 DFT (the host's float32 sums were 6.95e-05
from it here).  ``WhisperModel.transcribe`` and ``detect_language`` on the micro
model (the JAX seed-0 weights) then give the JAX package's segments and
language probabilities with the features kept on the model's device."""

import numpy as np
import pytest

import jax
import torch

from faster_whisper_tpu.feature_extractor import FeatureExtractor as JaxFeatureExtractor
from faster_whisper_tpu.models.config import tiny_test_config as jax_config
from faster_whisper_tpu.models.load import random_params as jax_random_params
from faster_whisper_tpu.ops import mel as jmel
from faster_whisper_tpu.testing import build_synthetic_tokenizer as jax_tokenizer
from faster_whisper_tpu.transcribe import WhisperModel as JaxWhisperModel
from faster_whisper_tpu_torch.audio import pad_or_trim
from faster_whisper_tpu_torch.feature_extractor import FeatureExtractor
from faster_whisper_tpu_torch.models.config import tiny_test_config
from faster_whisper_tpu_torch.models.load import params_from_jax
from faster_whisper_tpu_torch.ops import mel as pmel
from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer
from faster_whisper_tpu_torch.transcribe import WhisperModel

MEL_TOL = 1e-4
LOGPROB_TOL = 1e-4
LENGTHS = {
    "0.5s": 8000,
    "479990": 479990,
    "480000": 480000,
    "480150": 480150,
    "45s": 45 * 16000,
    "150s": 150 * 16000,
    # 32769 frames: the second slab holds one
    "slab-boundary": pmel._FRAME_SLAB * 160 + 77,
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's many small CPU ops: under the
    suite's parallel workers, more threads wait at every op's barrier for
    cores that the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_shipped_compile_cache(monkeypatch):
    monkeypatch.setenv("FWT_CACHE_ARTIFACTS", "/nonexistent")


def noise(n: int) -> np.ndarray:
    return (0.1 * np.random.default_rng(n).standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("n", list(LENGTHS.values()), ids=list(LENGTHS))
def test_log_mel_spectrogram_matches_jax_and_the_host_path(n, n_mels):
    audio = noise(n)
    jfe, fe = JaxFeatureExtractor(feature_size=n_mels), FeatureExtractor(feature_size=n_mels)
    ref = np.asarray(jmel.log_mel_spectrogram(audio, *jfe._constants()))
    ours = pmel.log_mel_spectrogram(torch.from_numpy(audio), *fe._constants("cpu"))
    assert ours.shape == ref.shape == (n_mels, (n + 160) // 160)
    assert ours.dtype == torch.float32 and ours.device.type == "cpu"
    np.testing.assert_allclose(ours.numpy(), ref, atol=MEL_TOL, rtol=0)
    np.testing.assert_allclose(ours.numpy(), fe(audio), atol=MEL_TOL, rtol=0)


def test_return_device_gives_a_tensor_on_the_extractors_device():
    audio = noise(16000 * 7 + 13)
    fe = FeatureExtractor(feature_size=128)
    assert fe.device == "auto"
    fe.device = "cpu"
    on_device = fe(audio, return_device=True)
    on_host = fe(audio)
    ref = JaxFeatureExtractor(feature_size=128)(audio)
    assert isinstance(on_device, torch.Tensor) and on_device.dtype == torch.float32
    assert on_device.device == torch.device("cpu")
    assert isinstance(on_host, np.ndarray) and on_host.dtype == np.float32
    assert on_host.flags.c_contiguous and on_host.shape == on_device.shape == ref.shape
    np.testing.assert_allclose(on_host, ref, atol=MEL_TOL, rtol=0)
    np.testing.assert_allclose(on_device.numpy(), ref, atol=MEL_TOL, rtol=0)
    # a tensor waveform, padding and chunk_length as the JAX signature has them
    got = fe(torch.from_numpy(audio), padding=0, chunk_length=20, return_device=True)
    want = JaxFeatureExtractor(feature_size=128)(audio, padding=0, chunk_length=20)
    assert fe.nb_max_frames == 2000
    np.testing.assert_allclose(got.numpy(), want, atol=MEL_TOL, rtol=0)


def test_return_device_without_a_card_raises():
    """The extractor's default device is the card: without one it raises
    and does not compute on the host."""
    if torch.cuda.is_available():
        pytest.skip("the host has a card")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        FeatureExtractor()(noise(16000), return_device=True)


@pytest.mark.parametrize("shape,axis", [((80, 2500), -1), ((80, 3100), -1), ((2, 7, 5), 1), ((4, 9), 0)])
def test_pad_or_trim_on_a_tensor_equals_numpy(shape, axis):
    a = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    for length in (3, 6, 3000):
        got = pad_or_trim(torch.from_numpy(a), length, axis=axis)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), pad_or_trim(a, length, axis=axis))


@pytest.fixture(scope="module")
def weights():
    return jax_random_params(jax_config(), seed=0, dtype="float32")


@pytest.fixture
def models(weights):
    jm = JaxWhisperModel.from_parts(weights, jax_config(), jax_tokenizer())
    pm = WhisperModel.from_parts(
        params_from_jax(jax.tree.map(np.asarray, weights), device="cpu"),
        tiny_test_config(), build_synthetic_tokenizer(), compute_type="float32", device="cpu",
    )
    return jm, pm


def test_transcribe_on_device_features_matches_jax(models, monkeypatch):
    jm, pm = models
    assert pm.feature_extractor.device == pm.device == torch.device("cpu")
    seen = []
    generate_segments = pm.generate_segments

    def spy(features, *args, **kwargs):
        seen.append(features)
        return generate_segments(features, *args, **kwargs)

    monkeypatch.setattr(pm, "generate_segments", spy)
    audio = noise(16000 * 41 + 5)
    kwargs = dict(beam_size=5, temperature=0.0, max_new_tokens=32, language=None)
    ref_segments, ref_info = jm.transcribe(audio, **kwargs)
    ref_segments = list(ref_segments)
    segments, info = pm.transcribe(audio, **kwargs)
    segments = list(segments)

    assert len(seen) == 1 and isinstance(seen[0], torch.Tensor)
    assert seen[0].device == pm.device and seen[0].shape == (80, (len(audio) + 160) // 160)
    assert info.language == ref_info.language
    assert info.language_probability == pytest.approx(ref_info.language_probability, abs=1e-5)
    assert len(segments) == len(ref_segments) > 0
    assert max(s.seek for s in segments) > 0
    for s, r in zip(segments, ref_segments):
        assert (s.id, s.seek, s.text, s.tokens) == (r.id, r.seek, r.text, r.tokens)
        assert (s.start, s.end) == (r.start, r.end)
        assert s.avg_logprob == pytest.approx(r.avg_logprob, abs=LOGPROB_TOL)


def test_detect_language_on_device_features_matches_jax(models):
    jm, pm = models
    audio = noise(16000 * 65)
    features = pm.feature_extractor(audio, return_device=True)
    ref_features = jm.feature_extractor(audio, return_device=True)
    for segments in (1, 3):
        ours = pm.detect_language(
            features=features[..., 17:], language_detection_segments=segments,
            language_detection_threshold=1.0,
        )
        ref = jm.detect_language(
            features=ref_features[..., 17:], language_detection_segments=segments,
            language_detection_threshold=1.0,
        )
        assert ours[0] == ref[0] and ours[1] == pytest.approx(ref[1], abs=1e-5)
        assert [code for code, _ in ours[2]] == [code for code, _ in ref[2]]
        np.testing.assert_allclose([p for _, p in ours[2]], [p for _, p in ref[2]], atol=1e-5)


@pytest.mark.parametrize("n", [479990, 150 * 16000])
def test_device_and_host_log_mel_are_near_a_float64_dft(n):
    """On ``chip_smoke.py``'s synthetic speech the device path and the
    host path are each within ``MEL_TOL`` of the float64 DFT of the same
    float32 frames and bases (``chip_smoke.py::log_mel_float64`` on the
    card, here on the CPU); the device path, whose DFT sums in float64,
    within 1e-6."""
    import torch.nn.functional as F

    from chip_smoke import synth_audio

    audio = synth_audio(150.0, seed=1) if n == 150 * 16000 else synth_audio(n / 16000 + 1, seed=5)[:n]
    fe = FeatureExtractor(feature_size=128)
    mel_filters, cos_b, sin_b = (torch.from_numpy(a).double() for a in (fe.mel_filters, fe._cos_b, fe._sin_b))
    n_valid = (n + 160) // 160
    n_bucketed = -(-(n_valid - 1) // 1500) * 1500 + 1
    x = F.pad(torch.from_numpy(audio).double(), (0, n_bucketed * 160 - n))
    frames = F.pad(x[None], (200, 360), mode="reflect")[0].unfold(0, 400, 160)[:n_valid]
    mel = ((frames @ cos_b) ** 2 + (frames @ sin_b) ** 2) @ mel_filters.T
    ref = torch.log10(torch.clamp(mel, min=1e-10))
    ref = ((torch.maximum(ref, ref.max() - 8.0) + 4.0) / 4.0).T.numpy()

    ours = pmel.log_mel_spectrogram(torch.from_numpy(audio), *fe._constants("cpu")).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(fe(audio), ref, atol=MEL_TOL, rtol=0)
