"""Attention of the port against the JAX package: K3's plain version (the
port's ``mha_full`` on a CPU tensor) against JAX's ``mha_full`` (its plain
path on the CPU) at the encoder's S=1500, and ``mha``/``mha_hmajor`` with
masks.

Tolerances: float32 1e-5 (same math, other summation order); bfloat16
relative 2e-2 of the output scale (bf16 rounding of the weights and of
the output, placed where the two frameworks round)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from faster_whisper_tpu.ops import attention as JA
from faster_whisper_tpu_torch.ops import attention as PA

F32_TOL = 1e-5
BF16_REL = 2e-2


@pytest.fixture(autouse=True)
def _no_shipped_compile_cache(monkeypatch):
    """The JAX side runs without the shipped compile-cache entries."""
    monkeypatch.setenv("FWT_CACHE_ARTIFACTS", "/nonexistent")


def _pair(shape, seed, dtype):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


def _check(out_t, out_j, dtype):
    a = out_t.float().numpy()
    b = np.asarray(jnp.asarray(out_j, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(a, b, atol=F32_TOL, rtol=F32_TOL)
    else:
        np.testing.assert_allclose(a, b, atol=BF16_REL * np.abs(b).max(), rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_full_plain_version_matches_jax_at_encoder_length(dtype):
    shape = (1, 1500, 2, 32)
    qj, qt = _pair(shape, 0, dtype)
    kj, kt = _pair(shape, 1, dtype)
    vj, vt = _pair(shape, 2, dtype)
    launches = PA.mha_flash.launches
    _check(PA.mha_full(qt, kt, vt), JA.mha_full(qj, kj, vj), dtype)
    assert PA.mha_flash.launches == launches  # the kernel never runs on the CPU


def test_mha_with_causal_mask_matches_jax():
    qj, qt = _pair((2, 6, 2, 16), 3, "float32")
    kj, kt = _pair((2, 6, 2, 16), 4, "float32")
    vj, vt = _pair((2, 6, 2, 16), 5, "float32")
    mask = np.tril(np.ones((6, 6), bool))[None, None]
    _check(
        PA.mha(qt, kt, vt, mask=torch.from_numpy(mask)),
        JA.mha(qj, kj, vj, mask=jnp.asarray(mask)),
        "float32",
    )


def test_mha_hmajor_matches_jax():
    qj, qt = _pair((2, 3, 2, 16), 6, "float32")
    kj, kt = _pair((2, 2, 40, 16), 7, "float32")
    vj, vt = _pair((2, 2, 40, 16), 8, "float32")
    mask = (np.arange(40)[None, :] < np.array([[25], [40]]))[:, None, None, :]
    _check(
        PA.mha_hmajor(qt, kt, vt, mask=torch.from_numpy(mask)),
        JA.mha_hmajor(qj, kj, vj, mask=jnp.asarray(mask)),
        "float32",
    )
