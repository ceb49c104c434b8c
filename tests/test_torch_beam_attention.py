"""K1's plain version (the port's ``beam_attend_append_ref``) against the
JAX package: ``beam_attend_append_xla`` and the Pallas kernel
``beam_attend_append`` in interpret mode.  Same inputs, made with numpy
from a seed, through both; outputs and caches compared.

Tolerances: float32 1e-5 (the same math in the same precision; sums taken
in another order).  bfloat16 relative 2e-2 of the output scale (one bf16
rounding of q, of the weights and of the output, each ~0.4%, placed where
the two frameworks round)."""

import numpy as np
import pytest

import jax  # noqa: F401  (test files import both frameworks)
import jax.numpy as jnp
import torch

from faster_whisper_tpu.ops.beam_attention import (
    beam_attend_append as jax_kernel,
    beam_attend_append_xla,
)
from faster_whisper_tpu_torch.ops.beam_attention import (
    beam_attend_append,
    beam_attend_append_ref,
)

F32_TOL = 1e-5
BF16_REL = 2e-2


@pytest.fixture(autouse=True)
def _no_shipped_compile_cache(monkeypatch):
    """The JAX side runs without the shipped compile-cache entries."""
    monkeypatch.setenv("FWT_CACHE_ARTIFACTS", "/nonexistent")


def _inputs(B=2, H=4, K=3, CTX=16, D=8, L=3, pos=7, seed=0):
    rng = np.random.default_rng(seed)
    arrs = dict(
        q=rng.standard_normal((B, H, K, D)),
        k_new=rng.standard_normal((B, H, K, D)),
        v_new=rng.standard_normal((B, H, K, D)),
        self_k=rng.standard_normal((L, B, H, K, CTX, D)),
        self_v=rng.standard_normal((L, B, H, K, CTX, D)),
    )
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    # a scrambled, valid ancestry; the current position lives in the own slot
    anc = rng.integers(0, K, (B, K, CTX)).astype(np.int32)
    anc[:, :, pos] = np.arange(K, dtype=np.int32)[None, :]
    arrs["anc"] = anc
    arrs["pos_row"] = np.full((B,), pos, np.int32)
    return arrs


def _jax(arrs, dtype):
    out = {}
    for k, v in arrs.items():
        out[k] = jnp.asarray(v, dtype if v.dtype == np.float32 else v.dtype)
    return out


def _torch(arrs, dtype):
    out = {}
    for k, v in arrs.items():
        t = torch.from_numpy(v.copy())
        out[k] = t.to(dtype) if v.dtype == np.float32 else t
    return out


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def _run_torch(t, layer, pos_bk=None):
    return beam_attend_append_ref(
        layer, t["pos_row"], t["q"], t["k_new"], t["v_new"],
        t["self_k"], t["self_v"], t["anc"], pos_bk=pos_bk,
    )


def _close(a, b, dtype):
    a, b = _f32(a), _f32(b)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, atol=F32_TOL, rtol=F32_TOL)
    else:
        np.testing.assert_allclose(a, b, atol=BF16_REL * np.abs(b).max(), rtol=0)


@pytest.mark.parametrize("pos", [0, 7, 15])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_xla_reference(dtype, pos):
    arrs = _inputs(pos=pos, seed=pos)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j, t = _jax(arrs, jd), _torch(arrs, td)
    layer = 1
    attn_j, sk_j, sv_j = beam_attend_append_xla(
        jnp.int32(layer), j["pos_row"], j["q"], j["k_new"], j["v_new"],
        j["self_k"], j["self_v"], j["anc"],
    )
    attn_t, sk_t, sv_t = _run_torch(t, layer)
    _close(attn_t, attn_j, dtype)
    # cache writes are exact copies of the inputs in both
    np.testing.assert_array_equal(_f32(sk_t), _f32(sk_j))
    np.testing.assert_array_equal(_f32(sv_t), _f32(sv_j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas_kernel_interpret(dtype):
    arrs = _inputs(seed=3)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j, t = _jax(arrs, jd), _torch(arrs, td)
    layer = 2
    attn_j, sk_j, sv_j = jax_kernel(
        jnp.int32(layer), j["pos_row"], j["q"], j["k_new"], j["v_new"],
        j["self_k"], j["self_v"], j["anc"], interpret=True,
    )
    attn_t, sk_t, sv_t = _run_torch(t, layer)
    _close(attn_t, attn_j, dtype)
    np.testing.assert_array_equal(_f32(sk_t), _f32(sk_j))
    np.testing.assert_array_equal(_f32(sv_t), _f32(sv_j))


def test_plain_version_honours_per_beam_positions():
    arrs = _inputs(seed=5)
    B, K = arrs["q"].shape[0], arrs["q"].shape[2]
    pos_bk = np.broadcast_to(arrs["pos_row"][:, None], (B, K)).copy()
    pos_bk[:, 0] = 3
    j, t = _jax(arrs, jnp.float32), _torch(arrs, torch.float32)
    attn_j, sk_j, sv_j = beam_attend_append_xla(
        jnp.int32(0), j["pos_row"], j["q"], j["k_new"], j["v_new"],
        j["self_k"], j["self_v"], j["anc"], pos_bk=jnp.asarray(pos_bk),
    )
    attn_t, sk_t, sv_t = _run_torch(t, 0, pos_bk=torch.from_numpy(pos_bk))
    _close(attn_t, attn_j, "float32")
    np.testing.assert_array_equal(_f32(sk_t), _f32(sk_j))
    # beam 0 wrote at column 3, the others at pos_row
    np.testing.assert_array_equal(sk_t[0, :, :, 0, 3].numpy(), arrs["k_new"][:, :, 0])


def test_update_is_in_place_and_touches_only_the_target_column():
    arrs = _inputs(seed=9)
    t = _torch(arrs, torch.float32)
    before = t["self_k"].clone()
    _, sk, sv = _run_torch(t, 2)
    assert sk is t["self_k"] and sv is t["self_v"]
    pos = int(arrs["pos_row"][0])
    untouched = torch.ones_like(before, dtype=torch.bool)
    untouched[2, :, :, :, pos] = False
    assert torch.equal(sk[untouched], before[untouched])
    assert torch.equal(sk[2, :, :, :, pos], t["k_new"])


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    arrs = _inputs(seed=11)
    t1, t2 = _torch(arrs, torch.float32), _torch(arrs, torch.float32)
    launches = beam_attend_append.launches
    a1, sk1, _ = beam_attend_append(
        1, t1["pos_row"], t1["q"], t1["k_new"], t1["v_new"],
        t1["self_k"], t1["self_v"], t1["anc"],
    )
    a2, sk2, _ = _run_torch(t2, 1)
    assert torch.equal(a1, a2) and torch.equal(sk1, sk2)
    assert beam_attend_append.launches == launches  # no kernel on the CPU
