"""The plain version of K1 and K2 (the port's ``beam_attend_append_ref``,
over a raw and an int8 cache) against the JAX package:
``beam_attend_append_xla`` and the Pallas kernels ``_kernel_bf16`` and
``_kernel_quant`` (through ``beam_attend_append``) in interpret mode.  Same
inputs, made with numpy from a seed, through both; outputs and caches
compared.  The int8 JAX calls run under ``jax.jit``, as the decode loop
runs them.

Tolerances: float32 1e-5 (the same math in the same precision; sums taken
in another order).  bfloat16 relative 2e-2 of the output scale (one bf16
rounding of q, of the weights and of the output, each ~0.4%, placed where
the two frameworks round).  int8 codes and scales: exactly equal."""

import inspect

import numpy as np
import pytest

import jax  # noqa: F401  (test files import both frameworks)
import jax.numpy as jnp
import torch

from faster_whisper_tpu.ops.beam_attention import (
    beam_attend_append as jax_kernel,
    beam_attend_append_xla,
)
from faster_whisper_tpu.ops.quant import QuantKV as JaxQuantKV
from faster_whisper_tpu.ops.quant import quantize_kv as jax_quantize_kv
from faster_whisper_tpu_torch.ops.beam_attention import (
    _split_plan,
    beam_attend_append,
    beam_attend_append_ref,
)
from faster_whisper_tpu_torch.ops.quant import QuantKV, quantize_kv

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


# ---------------------------------------------------------------------------
# int8 cache (K2's function)
# ---------------------------------------------------------------------------


def _quant_inputs(scale_dtype, **kw):
    """``_inputs`` with the caches quantized by the JAX package (codes int8,
    scales (L, B, H, K, ctx) in ``scale_dtype``), as numpy."""
    arrs = _inputs(**kw)
    quant = jax.jit(jax_quantize_kv)
    for name in ("self_k", "self_v"):
        c = quant(jnp.asarray(arrs[name]))
        arrs[name + "_q"] = np.asarray(c.q)
        arrs[name + "_s"] = np.asarray(c.s.astype(scale_dtype)).astype(np.float32)
    return arrs


def _quant_caches_jax(arrs, scale_dtype):
    return tuple(
        JaxQuantKV(jnp.asarray(arrs[n + "_q"]), jnp.asarray(arrs[n + "_s"], scale_dtype))
        for n in ("self_k", "self_v")
    )


def _quant_caches_torch(arrs, scale_dtype):
    return tuple(
        QuantKV(torch.from_numpy(arrs[n + "_q"].copy()), torch.from_numpy(arrs[n + "_s"]).to(scale_dtype))
        for n in ("self_k", "self_v")
    )


def _check_quant_caches(ours, ref, arrs, layer, pos):
    for o, r, name in zip(ours, ref, ("self_k", "self_v")):
        np.testing.assert_array_equal(o.q.numpy(), np.asarray(r.q))
        np.testing.assert_array_equal(o.s.float().numpy(), np.asarray(r.s, np.float32))
        # only the target column of layer `layer` moved
        keep = np.ones(arrs[name + "_q"].shape, bool)
        keep[layer, :, :, :, pos] = False
        np.testing.assert_array_equal(o.q.numpy()[keep], arrs[name + "_q"][keep])
        np.testing.assert_array_equal(o.s.float().numpy()[keep[..., 0]], arrs[name + "_s"][keep[..., 0]])


@pytest.mark.parametrize("pos", [0, 7, 15])
@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_int8_plain_version_matches_xla_reference(scale_dtype, pos):
    arrs = _quant_inputs(getattr(jnp, scale_dtype), pos=pos, seed=20 + pos)
    j, t = _jax(arrs, jnp.float32), _torch(arrs, torch.float32)
    layer = 1
    ref_attn, *ref_caches = jax.jit(beam_attend_append_xla)(
        jnp.int32(layer), j["pos_row"], j["q"], j["k_new"], j["v_new"],
        *_quant_caches_jax(arrs, getattr(jnp, scale_dtype)), j["anc"],
    )
    sk, sv = _quant_caches_torch(arrs, getattr(torch, scale_dtype))
    attn, *caches = beam_attend_append_ref(
        layer, t["pos_row"], t["q"], t["k_new"], t["v_new"], sk, sv, t["anc"],
    )
    _close(attn, ref_attn, "float32")
    assert caches[0] is sk and caches[1] is sv  # updated in place
    _check_quant_caches(caches, ref_caches, arrs, layer, pos)


def test_int8_plain_version_matches_pallas_kernel_interpret():
    """At float32, with float32 scales: the TPU kernel's "own" term at the
    unrounded scale then equals the stored one."""
    arrs = _quant_inputs(jnp.float32, seed=23)
    j, t = _jax(arrs, jnp.float32), _torch(arrs, torch.float32)
    layer, pos = 2, int(arrs["pos_row"][0])
    kernel = jax.jit(lambda *a: jax_kernel(*a, interpret=True))
    ref_attn, *ref_caches = kernel(
        jnp.int32(layer), j["pos_row"], j["q"], j["k_new"], j["v_new"],
        *_quant_caches_jax(arrs, jnp.float32), j["anc"],
    )
    attn, *caches = beam_attend_append_ref(
        layer, t["pos_row"], t["q"], t["k_new"], t["v_new"],
        *_quant_caches_torch(arrs, torch.float32), t["anc"],
    )
    _close(attn, ref_attn, "float32")
    _check_quant_caches(caches, ref_caches, arrs, layer, pos)


def test_int8_wrapper_takes_the_plain_version_for_cpu_tensors():
    arrs = _quant_inputs(jnp.bfloat16, seed=29)
    t = _torch(arrs, torch.float32)
    c1, c2 = _quant_caches_torch(arrs, torch.bfloat16), _quant_caches_torch(arrs, torch.bfloat16)
    launches = beam_attend_append.launches_int8
    a1, *r1 = beam_attend_append(1, t["pos_row"], t["q"], t["k_new"], t["v_new"], *c1, t["anc"])
    a2, *r2 = beam_attend_append_ref(1, t["pos_row"], t["q"], t["k_new"], t["v_new"], *c2, t["anc"])
    assert torch.equal(a1, a2)
    for x, y in zip(r1, r2):
        assert torch.equal(x.q, y.q) and torch.equal(x.s, y.s)
    assert beam_attend_append.launches_int8 == launches  # no kernel on the CPU


@pytest.mark.parametrize(
    "b,h,k,row_bytes",
    [(1, 20, 5, 128), (1, 20, 5, 64), (1, 20, 5, 256), (8, 20, 5, 128), (5, 20, 1, 128),
     (1, 20, 32, 256), (2, 4, 3, 64)],
)
def test_split_plan_tiles_the_columns_and_fits_shared_memory(b, h, k, row_bytes):
    """K1/K2's split over the columns: for every ctx from 1 to 448 the
    chunks tile [0, ctx); a chunk is a multiple of 8 columns, at most 64,
    and its K and V row slots (a row and 16 bytes of padding) fit the
    kernel's 64 KB (8 columns at the least).  The plan takes no write
    position, so a decode's grid never changes, and no ctx for its chunk,
    so every rung of the ctx ladder splits alike.  It takes no batch, no
    heads and no SM count either: the chunk of this case's (b, h) is that
    of every other batch and head count, on every card."""
    assert list(inspect.signature(_split_plan).parameters) == ["k", "ctx", "row_bytes"]
    full, _ = _split_plan(k, 448, row_bytes)
    for ctx in range(1, 449):
        chunk, n = _split_plan(k, ctx, row_bytes)
        assert 8 <= chunk <= 64 and chunk % 8 == 0, (ctx, chunk)
        assert (n - 1) * chunk < ctx <= n * chunk, (ctx, chunk, n)
        assert chunk == 8 or 2 * k * chunk * (row_bytes + 16) <= 64 * 1024, (ctx, chunk)
        assert chunk == full, (ctx, chunk)
    # At the main path's shape (K=5, bf16 or int8 rows): 14 chunks of 32,
    # whatever the batch (280 blocks at B=1, H=20; 2240 at B=8).
    if (b, h, k) == (1, 20, 5) and row_bytes <= 128:
        assert _split_plan(k, 448, row_bytes) == (32, 14)


def _split_and_merge(layer, pos, q, sk, sv, anc, chunk):
    """K1/K2's arithmetic in plain PyTorch over caches that already hold
    the new column: per chunk that holds a visible column, the max m, the
    sum l and the PV sums o of its columns (each query's row gathered by
    its ancestry; on the int8 cache the scores times the K scales and the V
    scales folded into the weights, which stay f32), then the merge
    sum_i e_i o_i / sum_i e_i l_i with e_i = exp(m_i - max_j m_j)."""
    quant = isinstance(sk, QuantKV)
    b, h, k, d = q.shape
    ck, cv = (sk.q[layer], sv.q[layer]) if quant else (sk[layer], sv[layer])
    n = pos + 1
    idx = anc[:, None, :, :n, None].long().expand(b, h, k, n, 1)  # (B, H, Kq, n, 1)

    def gather(x):  # (B, H, K, ctx, ...) -> (B, H, Kq, n, ...): the slot each query sees
        x = x[:, :, :, :n].float()
        if x.dim() == 4:
            return torch.gather(x, 2, idx[..., 0])
        return torch.gather(x, 2, idx.expand(b, h, k, n, d))

    qs = q.float() * d ** -0.5
    s = torch.einsum("bhkd,bhkcd->bhkc", qs, gather(ck))
    vg = gather(cv)
    if quant:
        s = s * gather(sk.s[layer])
        vscale = gather(sv.s[layer])
    ms, ls, os_ = [], [], []
    for c0 in range(0, n, chunk):
        cols = slice(c0, min(n, c0 + chunk))
        m = s[..., cols].amax(-1, keepdim=True)
        e = torch.exp(s[..., cols] - m)
        w = e * vscale[..., cols] if quant else e
        ms.append(m)
        ls.append(e.sum(-1, keepdim=True))
        os_.append(torch.einsum("bhkc,bhkcd->bhkd", w, vg[:, :, :, cols]))
    m_all = torch.stack(ms).amax(0)
    scale = [torch.exp(m - m_all) for m in ms]
    return sum(e * o for e, o in zip(scale, os_)) / sum(e * l for e, l in zip(scale, ls))


@pytest.mark.parametrize("pos", [0, 7, 8, 9, 15, 40])
@pytest.mark.parametrize("quant", [False, True])
def test_split_and_merge_arithmetic_matches_plain_version(quant, pos):
    """K1/K2's chunked softmax and merge, at the write position on and
    beside the chunk boundaries, equal ``beam_attend_append_ref`` at
    float32 (sums in another order: 1e-5)."""
    arrs = _inputs(B=2, H=3, K=4, CTX=41, D=16, pos=pos, seed=40 + pos)
    t = _torch(arrs, torch.float32)
    sk, sv = t["self_k"], t["self_v"]
    if quant:
        sk, sv = (QuantKV(c.q, c.s.to(torch.bfloat16)) for c in (quantize_kv(sk), quantize_kv(sv)))
    layer = 1
    ref, sk, sv = beam_attend_append_ref(
        layer, t["pos_row"], t["q"], t["k_new"], t["v_new"], sk, sv, t["anc"],
    )
    chunk, n = _split_plan(4, 41, 16 if quant else 64)
    assert (chunk, n) == (32, 2)
    # the plan's chunk, and chunks of 8 with the write position on and
    # beside their boundaries
    for width in (chunk, 8):
        ours = _split_and_merge(layer, pos, t["q"], sk, sv, t["anc"], width)
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["K1-bf16", "K2-int8"])
def test_a_rows_chunked_output_is_the_same_bits_alone_in_a_batch_and_as_a_head_slice(quant):
    """K1/K2's arithmetic (``_split_and_merge``, with the chunk of the
    kernel's plan for 64-wide bf16 or int8 rows) for one row of a batch of
    8 with 20 heads: the row alone, the same row inside the batch of 8 and
    its heads 10-19 as a shard of 10 heads give bit-equal outputs, since
    the plan's chunks do not move with the batch or the heads."""
    b, h, k, ctx, d, pos, row = 8, 20, 5, 200, 16, 199, 3
    arrs = _inputs(B=b, H=h, K=k, CTX=ctx, D=d, L=1, pos=pos, seed=61)
    t = _torch(arrs, torch.bfloat16)
    sk, sv = t["self_k"], t["self_v"]
    if quant:
        sk, sv = (QuantKV(c.q, c.s.to(torch.bfloat16)) for c in (quantize_kv(sk), quantize_kv(sv)))
    chunk, n = _split_plan(k, ctx, 64 if quant else 128)
    assert n > 1

    def part(cache, rows, heads):
        if quant:
            return QuantKV(cache.q[:, rows, heads].contiguous(), cache.s[:, rows, heads].contiguous())
        return cache[:, rows, heads].contiguous()

    def run(rows, heads):
        q = t["q"][rows, heads].contiguous()
        anc = t["anc"][rows].contiguous()
        return _split_and_merge(0, pos, q, part(sk, rows, heads), part(sv, rows, heads), anc, chunk)

    whole = run(slice(None), slice(None))
    alone = run(slice(row, row + 1), slice(None))
    shard = run(slice(row, row + 1), slice(10, 20))
    assert torch.equal(alone[0], whole[row])
    assert torch.equal(shard[0], whole[row, 10:])
