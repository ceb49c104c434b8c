"""The plain version of K4 (the port's ``cross_attend_ref``, over a raw and
an int8 cross cache) against the JAX package's ``cross_attend`` in
interpret mode: its three Pallas bodies ``_cross_kernel_raw`` (K4a),
``_cross_kernel_quant`` (K4b, ``t_block`` >= T) and
``_cross_kernel_quant_flash`` (K4c, ``t_block=128`` over T=300, so the
last block is ragged).  Same numpy inputs from a seed through both.  The
JAX decode step's unfused branch, which ``cross_attend_ref`` follows, is
held against the port's decoder step in ``test_torch_generate.py``.

Tolerances: float32 1e-5 (the same math; sums in another order; the JAX
kernels scale q before the dot, the plain version the scores after it).
bfloat16 relative 2e-2 of the output scale (one bf16 rounding of the
weights and of the output, placed where the two frameworks round)."""

import inspect

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from faster_whisper_tpu.ops.beam_attention import cross_attend as jax_cross_attend
from faster_whisper_tpu.ops.quant import QuantKV as JaxQuantKV
from faster_whisper_tpu.ops.quant import quantize_kv as jax_quantize_kv
from faster_whisper_tpu_torch.ops.cross_attention import _split_plan, cross_attend, cross_attend_ref
from faster_whisper_tpu_torch.ops.quant import QuantKV

F32_TOL = 1e-5
BF16_REL = 2e-2
L, B, H, K, T, D = 3, 2, 4, 3, 300, 16


@pytest.fixture(autouse=True)
def _no_shipped_compile_cache(monkeypatch):
    """The JAX side runs without the shipped compile-cache entries."""
    monkeypatch.setenv("FWT_CACHE_ARTIFACTS", "/nonexistent")


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, K, D)).astype(np.float32)
    ck = rng.standard_normal((L, B, H, T, D)).astype(np.float32)
    cv = rng.standard_normal((L, B, H, T, D)).astype(np.float32)
    return q, ck, cv


def _quant(c, scale_dtype):
    """Codes and scales (L, B, H, 1, T), as the int8 decode stores them."""
    qc = jax.jit(jax_quantize_kv)(jnp.asarray(c))
    return np.array(qc.q), np.array(qc.s.astype(scale_dtype), np.float32)[:, :, :, None]


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_raw_cache_matches_cross_kernel_raw(dtype):
    q, ck, cv = _inputs(1)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    layer = 1
    ref = jax_cross_attend(
        jnp.int32(layer), jnp.asarray(q, jd), jnp.asarray(ck, jd), jnp.asarray(cv, jd),
        interpret=True,
    )
    ours = cross_attend_ref(
        layer, torch.from_numpy(q).to(td), torch.from_numpy(ck).to(td), torch.from_numpy(cv).to(td),
    )
    assert ours.dtype == td and ours.shape == (B, H, K, D)
    a, b = _f32(ours), _f32(ref)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, atol=F32_TOL, rtol=F32_TOL)
    else:
        np.testing.assert_allclose(a, b, atol=BF16_REL * np.abs(b).max(), rtol=0)


@pytest.mark.parametrize(
    "t_block,scale_dtype",
    [(T, "float32"), (128, "float32"), (128, "bfloat16")],
    ids=["K4b-whole-T", "K4c-ragged-tail", "K4c-bf16-scales"],
)
def test_int8_cache_matches_cross_kernels_quant(t_block, scale_dtype):
    q, ck, cv = _inputs(2)
    sdt = getattr(jnp, scale_dtype)
    (kq, ks), (vq, vs) = _quant(ck, sdt), _quant(cv, sdt)
    layer = 2
    ref = jax_cross_attend(
        jnp.int32(layer), jnp.asarray(q),
        JaxQuantKV(jnp.asarray(kq), jnp.asarray(ks, sdt)),
        JaxQuantKV(jnp.asarray(vq), jnp.asarray(vs, sdt)),
        interpret=True, t_block=t_block,
    )
    tdt = getattr(torch, scale_dtype)
    ours = cross_attend_ref(
        layer, torch.from_numpy(q),
        QuantKV(torch.from_numpy(kq), torch.from_numpy(ks).to(tdt)),
        QuantKV(torch.from_numpy(vq), torch.from_numpy(vs).to(tdt)),
    )
    np.testing.assert_allclose(_f32(ours), _f32(ref), atol=F32_TOL, rtol=F32_TOL)


def test_int8_scales_fold_into_scores_and_weights():
    """The int8 plain version equals the raw one on the dequantized cache
    (codes x scales), up to float32 rounding."""
    q, ck, cv = _inputs(3)
    (kq, ks), (vq, vs) = _quant(ck, jnp.float32), _quant(cv, jnp.float32)
    deq_k = kq.astype(np.float32) * np.swapaxes(ks, -1, -2)
    deq_v = vq.astype(np.float32) * np.swapaxes(vs, -1, -2)
    tq = torch.from_numpy(q)
    quant = cross_attend_ref(
        0, tq,
        QuantKV(torch.from_numpy(kq), torch.from_numpy(ks)),
        QuantKV(torch.from_numpy(vq), torch.from_numpy(vs)),
    )
    raw = cross_attend_ref(0, tq, torch.from_numpy(deq_k), torch.from_numpy(deq_v))
    np.testing.assert_allclose(quant.numpy(), raw.numpy(), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("quant", [False, True])
def test_wrapper_takes_the_plain_version_for_cpu_tensors(quant):
    q, ck, cv = (torch.from_numpy(a) for a in _inputs(4))
    if quant:
        (kq, ks), (vq, vs) = _quant(ck.numpy(), jnp.bfloat16), _quant(cv.numpy(), jnp.bfloat16)
        ck = QuantKV(torch.from_numpy(kq), torch.from_numpy(ks).to(torch.bfloat16))
        cv = QuantKV(torch.from_numpy(vq), torch.from_numpy(vs).to(torch.bfloat16))
    names = ("launches", "launches_f32", "launches_int8", "launches_int8_f32")
    counts = [getattr(cross_attend, a) for a in names]
    assert torch.equal(cross_attend(1, q, ck, cv), cross_attend_ref(1, q, ck, cv))
    assert [getattr(cross_attend, a) for a in names] == counts  # no kernel on the CPU


@pytest.mark.parametrize("b,h", [(1, 20), (8, 20), (1, 1), (2, 4), (5, 6)])
def test_split_plan_covers_every_column_with_no_empty_chunk(b, h):
    """K4's split over T: for every T from 1 to 1501 the chunks tile [0, T)
    exactly, the last one non-empty; a chunk is a multiple of 16 columns,
    at most 128 (one per thread of the kernel's score pass).  The plan
    takes only T: the chunk of this case's (b, h) is that of every other
    batch and head count, on every card, and the same for every T."""
    assert list(inspect.signature(_split_plan).parameters) == ["t"]
    full, _ = _split_plan(1500)
    for t in range(1, 1502):
        chunk, n = _split_plan(t)
        assert 1 <= chunk <= 128 and chunk % 16 == 0, (t, chunk)
        assert (n - 1) * chunk < t <= n * chunk, (t, chunk, n)
        assert chunk == full, (t, chunk)
        if t <= chunk:
            assert n == 1
    # At the main path's T: 19 chunks of 80, 380 blocks at B=1, H=20 (more
    # than two per SM of an H100) and 3040 at B=8.
    assert _split_plan(1500) == (80, 19)


def _split_and_merge(layer, q, cross_k, cross_v):
    """K4's arithmetic in plain PyTorch: per chunk of ``_split_plan`` the
    max m, the sum l and the PV sums o of its columns (V scales folded into
    the weights), then the merge sum_i e_i o_i / sum_i e_i l_i with
    e_i = exp(m_i - max_j m_j)."""
    quant = isinstance(cross_k, QuantKV)
    b, h, _, d = q.shape
    codes_k, codes_v = (cross_k.q, cross_v.q) if quant else (cross_k, cross_v)
    t = codes_k.shape[3]
    chunk, n = _split_plan(t)
    ms, ls, os_ = [], [], []
    for c in range(n):
        cols = slice(c * chunk, min(t, (c + 1) * chunk))
        s = torch.einsum("bhkd,bhtd->bhkt", q.float(), codes_k[layer][:, :, cols].float()) * d ** -0.5
        if quant:
            s = s * cross_k.s[layer][..., cols].float()
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        w = e * cross_v.s[layer][..., cols].float() if quant else e
        ms.append(m)
        ls.append(e.sum(-1, keepdim=True))
        os_.append(torch.einsum("bhkt,bhtd->bhkd", w, codes_v[layer][:, :, cols].float()))
    m_all = torch.stack(ms).amax(0)
    scale = [torch.exp(m - m_all) for m in ms]
    num = sum(e * o for e, o in zip(scale, os_))
    den = sum(e * l for e, l in zip(scale, ls))
    return num / den


@pytest.mark.parametrize("t", [1, 300, 1501])
@pytest.mark.parametrize("quant", [False, True])
def test_split_and_merge_arithmetic_matches_plain_version(quant, t):
    """K4's chunked online softmax and merge equal ``cross_attend_ref`` at
    float32 (sums in another order: 1e-5)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, H, K, D)).astype(np.float32)
    ck, cv = (rng.standard_normal((L, B, H, t, D)).astype(np.float32) for _ in range(2))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, ck, cv))
    if quant:
        (kq, ks), (vq, vs) = _quant(ck, jnp.bfloat16), _quant(cv, jnp.bfloat16)
        tk = QuantKV(torch.from_numpy(kq), torch.from_numpy(ks).to(torch.bfloat16))
        tv = QuantKV(torch.from_numpy(vq), torch.from_numpy(vs).to(torch.bfloat16))
    ref = cross_attend_ref(1, tq, tk, tv)
    ours = _split_and_merge(1, tq, tk, tv)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["raw", "int8"])
def test_a_rows_chunked_output_is_the_same_bits_alone_in_a_batch_and_as_a_head_slice(quant):
    """K4's arithmetic (``_split_and_merge``, with the kernel's plan) for
    one row of a batch of 8 with 20 heads at T=1500: the row alone, the
    same row inside the batch of 8 and its heads 10-19 as a shard of 10
    heads give bit-equal outputs, since the plan's chunks do not move with
    the batch or the heads."""
    b, h, k, t, d, row = 8, 20, 5, 1500, 16, 5
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((b, h, k, d)).astype(np.float32)).to(torch.bfloat16)
    ck, cv = (rng.standard_normal((1, b, h, t, d)).astype(np.float32) for _ in range(2))
    if quant:
        (kq, ks), (vq, vs) = _quant(ck, jnp.bfloat16), _quant(cv, jnp.bfloat16)
        tk = QuantKV(torch.from_numpy(kq), torch.from_numpy(ks).to(torch.bfloat16))
        tv = QuantKV(torch.from_numpy(vq), torch.from_numpy(vs).to(torch.bfloat16))
    else:
        tk, tv = (torch.from_numpy(c).to(torch.bfloat16) for c in (ck, cv))

    def part(cache, rows, heads):
        if quant:
            return QuantKV(cache.q[:, rows, heads].contiguous(), cache.s[:, rows, heads].contiguous())
        return cache[:, rows, heads].contiguous()

    def run(rows, heads):
        return _split_and_merge(0, q[rows, heads].contiguous(), part(tk, rows, heads), part(tv, rows, heads))

    whole = run(slice(None), slice(None))
    alone = run(slice(row, row + 1), slice(None))
    shard = run(slice(row, row + 1), slice(10, 20))
    assert torch.equal(alone[0], whole[row])
    assert torch.equal(shard[0], whole[row, 10:])
