"""The port's model forward, weights and features against the JAX package
at the micro config (2 layers, d=64, 2 heads, n_audio_ctx 1500), on
weights drawn by the JAX ``random_params`` and carried across with
``params_from_jax``.

Tolerances: float32 1e-5 (same math, other summation order); bfloat16
relative 2e-2 of the output scale (bf16 rounding at the same points, in
another order, through every layer).  Log-mel 1e-4: both are float32
matrix products over 400 samples, log-compressed."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from faster_whisper_tpu.models import model as JM
from faster_whisper_tpu.models.config import tiny_test_config as jax_config
from faster_whisper_tpu.models.load import param_shapes as jax_param_shapes
from faster_whisper_tpu.models.load import random_params as jax_random_params
from faster_whisper_tpu_torch.models import model as PM
from faster_whisper_tpu_torch.models.config import CONFIGS, tiny_test_config
from faster_whisper_tpu_torch.models.load import param_shapes, params_from_jax, random_params

F32_TOL = 1e-5
BF16_REL = 2e-2
MEL_TOL = 1e-4


@pytest.fixture(autouse=True)
def _no_shipped_compile_cache(monkeypatch):
    """The JAX side runs without the shipped compile-cache entries."""
    monkeypatch.setenv("FWT_CACHE_ARTIFACTS", "/nonexistent")


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def weights(request):
    dtype = request.param
    jp = jax_random_params(jax_config(), seed=0, dtype=dtype)
    pp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return dtype, jp, pp


def _check(a, b, dtype):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = np.asarray(jnp.asarray(b, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(a, b, atol=F32_TOL, rtol=F32_TOL)
    else:
        np.testing.assert_allclose(a, b, atol=BF16_REL * np.abs(b).max(), rtol=0)


def test_config_copy_matches_jax():
    from faster_whisper_tpu.models.config import CONFIGS as JAX_CONFIGS

    assert set(CONFIGS) == set(JAX_CONFIGS)
    for name, cfg in CONFIGS.items():
        assert vars(cfg) == vars(JAX_CONFIGS[name]), name
    assert vars(tiny_test_config()) == vars(jax_config())
    assert param_shapes(CONFIGS["large-v3-turbo"]) == jax_param_shapes(JAX_CONFIGS["large-v3-turbo"])


def test_params_from_jax_carries_every_leaf_exactly(weights):
    dtype, jp, pp = weights
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat_j:
        t = pp
        for key in path:
            t = t[key.key]
        assert t.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(leaf, np.float32))


def test_random_params_layout_and_seed():
    cfg = tiny_test_config()
    a = random_params(cfg, seed=3, dtype=torch.float32, device="cpu")
    b = random_params(cfg, seed=3, dtype=torch.float32, device="cpu")
    c = random_params(cfg, seed=4, dtype=torch.float32, device="cpu")

    def walk(shapes, x, y, z):
        if isinstance(shapes, dict):
            assert set(shapes) == set(x)
            return any(walk(shapes[k], x[k], y[k], z[k]) for k in shapes)
        shape, kind = shapes
        assert tuple(x.shape) == shape
        assert torch.equal(x, y)
        return kind == "w" and not torch.equal(x, z)

    assert walk(param_shapes(cfg), a, b, c)  # same seed equal, other seed differs
    np.testing.assert_allclose(
        a["encoder"]["pos_embed"].numpy(), PM.sinusoids(1500, 64), atol=1e-6
    )


def test_encode_matches_jax(weights):
    dtype, jp, pp = weights
    mel = np.random.default_rng(0).standard_normal((2, 80, 3000)).astype(np.float32)
    calls = PM.encode.calls
    out = PM.encode(pp, tiny_test_config(), torch.from_numpy(mel))
    assert PM.encode.calls == calls + 1
    assert tuple(out.shape) == (2, 1500, 64)
    _check(out, JM.encode(jp, jax_config(), jnp.asarray(mel)), dtype)


def test_decoder_prefill_matches_jax(weights):
    dtype, jp, pp = weights
    rng = np.random.default_rng(1)
    xa = rng.standard_normal((2, 1500, 64)).astype(np.float32)
    tokens = np.array([[1500, 3, 5, 7, 9], [11, 13, 0, 0, 0]], np.int32)
    lengths = np.array([5, 2], np.int32)
    gather = np.array([[4, 0], [1, 0]], np.int32)
    lj, cj = JM.decoder_prefill(
        jp, jax_config(), jnp.asarray(tokens), jnp.asarray(lengths),
        jnp.asarray(xa, getattr(jnp, dtype)), jnp.asarray(gather), ctx=64,
    )
    lt, ct = PM.decoder_prefill(
        pp, tiny_test_config(), torch.from_numpy(tokens).long(),
        torch.from_numpy(lengths).long(), torch.from_numpy(xa).to(getattr(torch, dtype)),
        torch.from_numpy(gather).long(), ctx=64,
    )
    _check(lt, lj, dtype)
    _check(ct.cross_k, cj.cross_k, dtype)
    _check(ct.cross_v, cj.cross_v, dtype)
    # the prompt's slots of the self cache (later slots are never read)
    _check(ct.self_k[:, 0, :, :5], cj.self_k[:, 0, :, :5], dtype)
    _check(ct.self_v[:, 1, :, :2], cj.self_v[:, 1, :, :2], dtype)


@pytest.mark.parametrize("seconds,n_mels", [(45.0, 80), (30.0, 128), (0.77, 80)])
def test_log_mel_matches_jax(seconds, n_mels):
    from faster_whisper_tpu.feature_extractor import FeatureExtractor as JaxFE
    from faster_whisper_tpu_torch.feature_extractor import FeatureExtractor

    n = int(seconds * 16000)
    audio = (0.1 * np.random.default_rng(2).standard_normal(n)).astype(np.float32)
    ours = FeatureExtractor(feature_size=n_mels)(audio)
    ref = JaxFE(feature_size=n_mels)(audio)
    assert ours.shape == ref.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=MEL_TOL, rtol=0)


def test_extract_window_matches_jax():
    from faster_whisper_tpu.ops.mel import extract_window as jax_extract
    from faster_whisper_tpu_torch.ops.mel import extract_window

    feats = np.random.default_rng(3).standard_normal((80, 4501 + 3000)).astype(np.float32)
    for seek, size in [(0, 3000), (3000, 1500), (1234, 2000)]:
        ours = extract_window(torch.from_numpy(feats), seek, size, 3000).numpy()
        ref = np.asarray(jax_extract(jnp.asarray(feats), jnp.int32(seek), jnp.int32(size), 3000))
        np.testing.assert_array_equal(ours, ref)
