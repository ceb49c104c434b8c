"""The port's int8 quantization (``ops/quant.py``) against the JAX
package's, on the same numpy inputs from a seed; the card's W8A8 kernel
(``csrc/w8a8.cu``) against the composition it replaced.

The JAX functions run under ``jax.jit``, as the JAX package runs them
(``quantize_params`` is jitted, the others run inside jitted programs).

Tolerances: codes and scales must be exactly equal (the same float32
operations in the same order, rounding half to even on both sides); the
int8 dense in float32 within 1e-5 relative (its int32 products are exact;
the rescale is the same float32 chain).  On the host, ``int8_dense`` is
the composition ``_quantize_rows``, ``_int8_product``, ``_rescale`` bit
for bit; the wrapper of the card's kernel raises on what the kernel does
not take before it reaches the card; its plan follows the shape alone.

The card tests (marker ``cuda``) skip without a card; on the card run

    python -m pytest -m cuda tests/test_torch_quant.py

where the JAX package is missing, and its tests skip.
"""

import os
import shutil

import numpy as np
import pytest
import torch

try:  # the reference; a machine with only PyTorch runs the card tests alone
    import jax
    import jax.numpy as jnp

    from faster_whisper_tpu.models.config import tiny_test_config as jax_config
    from faster_whisper_tpu.models.load import random_params as jax_random_params
    from faster_whisper_tpu.ops import quant as JQ
except ImportError:
    jax = None
from faster_whisper_tpu_torch.models.load import params_from_jax
from faster_whisper_tpu_torch.ops import quant as PQ

F32_REL = 1e-5


@pytest.fixture(autouse=True)
def _no_shipped_compile_cache(request, monkeypatch):
    """The JAX side runs without the shipped compile-cache entries; a test
    of the JAX package skips where it is missing."""
    if jax is None and "card" not in request.fixturenames:
        pytest.skip("needs the JAX package (the reference)")
    monkeypatch.setenv("FWT_CACHE_ARTIFACTS", "/nonexistent")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    if shutil.which("nvcc") is None and not os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the kernels")
    import chip_smoke

    chip_smoke.build_kernels()
    return torch.cuda.get_device_name(0)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("shape", [(64, 96), (3, 64, 96)])
def test_quantize_weight_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    w = (0.02 * rng.standard_normal(shape)).astype(np.float32)
    w[..., 5] = 0.0  # an all-zero output channel takes the 1e-10 floor
    ref = jax.jit(JQ.quantize_weight)(jnp.asarray(w))
    ours = PQ.quantize_weight(torch.from_numpy(w))
    assert ours.q.dtype == torch.int8 and ours.s.dtype == torch.float32
    np.testing.assert_array_equal(_np(ours.q), _np(ref.q))
    np.testing.assert_array_equal(_np(ours.s), _np(ref.s))


@pytest.mark.parametrize(
    "x_shape,bias,out_dtype",
    [((5, 64), False, None), ((2, 7, 64), True, None), ((2, 7, 64), True, "float32")],
    ids=["rank2", "rank3-bias", "rank3-bias-f32-out"],
)
def test_int8_dense_matches_jax(x_shape, bias, out_dtype):
    rng = np.random.default_rng(sum(x_shape))
    x = rng.standard_normal(x_shape).astype(np.float32)
    x[0, ...] = 0.0  # an all-zero row takes the 1e-10 activation floor
    w = (0.05 * rng.standard_normal((64, 96))).astype(np.float32)
    b = rng.standard_normal((96,)).astype(np.float32) if bias else None
    jw, pw = jax.jit(JQ.quantize_weight)(jnp.asarray(w)), PQ.quantize_weight(torch.from_numpy(w))
    dense = jax.jit(JQ.int8_dense, static_argnames="out_dtype")
    ref = dense(
        jnp.asarray(x), jw, None if b is None else jnp.asarray(b),
        out_dtype=None if out_dtype is None else getattr(jnp, out_dtype),
    )
    ours = PQ.int8_dense(
        torch.from_numpy(x), pw, None if b is None else torch.from_numpy(b),
        out_dtype=None if out_dtype is None else getattr(torch, out_dtype),
    )
    assert ours.shape == ref.shape and ours.dtype == torch.float32
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=F32_REL, atol=F32_REL * np.abs(_np(ref)).max())


def test_quantize_params_matches_jax():
    jp = jax_random_params(jax_config(), seed=0, dtype="float32")
    ref = JQ.quantize_params(jp)
    ours = PQ.quantize_params(params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))

    flat_ref = jax.tree_util.tree_flatten_with_path(
        ref, is_leaf=lambda n: isinstance(n, JQ.QuantizedLinear)
    )[0]
    n_quant = 0
    for path, leaf in flat_ref:
        t = ours
        for key in path:
            t = t[key.key]
        if isinstance(leaf, JQ.QuantizedLinear):
            assert isinstance(t, PQ.QuantizedLinear), path
            n_quant += 1
            q, s = _np(t.q), _np(t.s)
            if path[-1].key == "logits_w":
                # the port pads the head's columns to a multiple of 8
                v = leaf.q.shape[-1]
                assert q.shape[-1] % 8 == 0 and q.shape[-1] - v < 8
                assert not q[:, v:].any()
                q, s = q[:, :v], s[:v]
            np.testing.assert_array_equal(q, _np(leaf.q))
            np.testing.assert_array_equal(s, _np(leaf.s))
        else:
            # embeddings, conv stem, layernorms and biases stay float
            assert t.dtype == torch.float32, path
            np.testing.assert_array_equal(_np(t), _np(leaf))
    # 4 attention + 2 mlp weights per encoder layer stack, 2 x 4 attention
    # + 2 mlp per decoder layer stack, and the logits head
    assert n_quant == 6 + 10 + 1
    assert "logits_w" in ours["decoder"] and ours["decoder"]["token_embed"].dtype == torch.float32


def test_quantize_kv_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    x[1, 2, 0] = 0.0
    ref = jax.jit(JQ.quantize_kv)(jnp.asarray(x))
    ours = PQ.quantize_kv(torch.from_numpy(x))
    assert ours.q.dtype == torch.int8 and ours.s.shape == (2, 3, 4)
    np.testing.assert_array_equal(_np(ours.q), _np(ref.q))
    np.testing.assert_array_equal(_np(ours.s), _np(ref.s))


def test_params_from_jax_carries_quantized_leaves():
    jp = JQ.quantize_params(jax_random_params(jax_config(), seed=1, dtype="bfloat16"))
    ours = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    wq = ours["decoder"]["layers"]["self_attn"]["wq"]
    assert isinstance(wq, PQ.QuantizedLinear)
    assert wq.q.dtype == torch.int8 and wq.s.dtype == torch.float32
    np.testing.assert_array_equal(_np(wq.q), np.asarray(jp["decoder"]["layers"]["self_attn"]["wq"].q))
    assert ours["decoder"]["token_embed"].dtype == torch.bfloat16
    kv = params_from_jax({"c": JQ.quantize_kv(jnp.ones((2, 8), jnp.bfloat16))}, device="cpu")["c"]
    assert isinstance(kv, PQ.QuantKV) and kv.q.dtype == torch.int8 and kv.s.dtype == torch.float32


# ---------------------------------------------------------------------------
# The card's W8A8 product (csrc/w8a8.cu) and its wrapper
# ---------------------------------------------------------------------------


def _composition(x, w, b, out_dtype):
    """int8_dense's composition, written out: the plain version."""
    xf = x.float()
    xq, sx = PQ._quantize_rows(xf, xf.abs().amax(dim=-1, keepdim=True))
    return PQ._rescale(PQ._int8_product(xq, w), sx, w, b, out_dtype)


@pytest.mark.parametrize(
    "x_dtype,out_dtype,bias,qmax,group",
    [
        (torch.float32, None, False, 127, None),
        (torch.bfloat16, None, True, 127, None),
        (torch.bfloat16, torch.float32, False, 127, None),
        (torch.float32, torch.float32, True, 7, None),
        (torch.bfloat16, None, True, 7, None),
        (torch.float32, None, True, 7, 16),
    ],
    ids=["f32", "bf16-bias", "bf16-f32-out", "f32-bias-qmax7", "bf16-bias-qmax7", "f32-groups"],
)
def test_host_int8_dense_is_the_composition(x_dtype, out_dtype, bias, qmax, group):
    """A CPU tensor takes the plain path: bit-equal to the composition,
    no kernel launch counted (a zero row takes the 1e-10 floor)."""
    g = torch.Generator().manual_seed(qmax + bias)
    x = torch.randn((2, 7, 64), generator=g).to(x_dtype)
    x[0, 3] = 0
    w = PQ.quantize_weight(0.05 * torch.randn((64, 96), generator=g), qmax=qmax, group_size=group)
    b = torch.randn((96,), generator=g).to(x_dtype) if bias else None
    before = PQ.int8_dense.launches
    got = PQ.int8_dense(x, w, b, out_dtype=out_dtype)
    assert PQ.int8_dense.launches == before
    want = _composition(x, w, b, out_dtype or x_dtype)
    assert got.dtype == (out_dtype or x_dtype) and torch.equal(got, want)


@pytest.mark.parametrize("group", [None, 16], ids=["per-channel", "groups"])
def test_int8_dense_many_is_each_product(group):
    """``int8_dense_many`` (one x, several weights and biases) gives each
    product's ``int8_dense`` bits, and counts no launch on the host."""
    g = torch.Generator().manual_seed(11)
    x = torch.randn((3, 5, 64), generator=g).bfloat16()
    ws = [PQ.quantize_weight(0.05 * torch.randn((64, 32), generator=g), qmax=7, group_size=group) for _ in range(3)]
    bs = (torch.randn(32, generator=g).bfloat16(), None, torch.randn(32, generator=g).bfloat16())
    before = PQ.int8_dense.launches
    got = PQ.int8_dense_many(x, ws, bs)
    assert PQ.int8_dense.launches == before
    assert all(torch.equal(y, PQ.int8_dense(x, w, b)) for y, w, b in zip(got, ws, bs))


@pytest.mark.parametrize("group", [None, 16], ids=["per-channel", "groups"])
def test_host_and_group_weights_take_the_composition(monkeypatch, group):
    """On the host every weight, and on the card a group-scale weight, goes
    through ``_int8_product``; the card's kernel wrapper is never called
    for them here."""
    calls = []
    real = PQ._int8_product
    monkeypatch.setattr(PQ, "_int8_product", lambda xq, w: calls.append(w) or real(xq, w))
    monkeypatch.setattr(PQ, "_w8a8", lambda *a: pytest.fail("the card's kernel wrapper was called"))
    w = PQ.quantize_weight(0.05 * torch.randn((64, 32)), qmax=7, group_size=group)
    PQ.int8_dense(torch.randn((5, 64)), w)
    assert len(calls) == 1 and (calls[0].s.dim() == 2) == (group is not None)


@pytest.mark.parametrize("group", [None, 16], ids=["per-channel", "groups"])
def test_card_layout_leaves_host_and_group_weights_alone(group):
    w = PQ.quantize_weight(0.05 * torch.randn((64, 32)), qmax=7, group_size=group)
    assert PQ.card_layout(w) is w and w.q.is_contiguous()


def _kernel_args():
    """Arguments the wrapper takes: bf16 x (8, 5, 64), K-major codes (64,
    32), float32 scales, a bf16 bias, a bf16 output (CPU tensors: the
    wrapper checks them all before it reaches the card)."""
    w = PQ.quantize_weight(0.05 * torch.randn((64, 32)))
    w = PQ.QuantizedLinear(w.q.mT.contiguous().mT, w.s)
    return dict(x=torch.randn((8, 5, 64)).bfloat16(), w=w, b=torch.randn(32).bfloat16(), out_dtype=torch.bfloat16)


_BAD = {
    "x-float16": (TypeError, lambda a: a.update(x=a["x"].half())),
    "out-float16": (TypeError, lambda a: a.update(out_dtype=torch.float16)),
    "codes-int32": (TypeError, lambda a: a.update(w=PQ.QuantizedLinear(a["w"].q.int(), a["w"].s))),
    "codes-3d": (TypeError, lambda a: a.update(w=PQ.QuantizedLinear(a["w"].q[None], a["w"].s))),
    "scales-shape": (ValueError, lambda a: a.update(w=PQ.QuantizedLinear(a["w"].q, a["w"].s[:16]))),
    "x-width": (ValueError, lambda a: a.update(x=a["x"][..., :48])),
    "k-24": (ValueError, lambda a: a.update(x=a["x"][..., :24], w=PQ.QuantizedLinear(
        a["w"].q[:24].mT.contiguous().mT, a["w"].s))),
    "n-12": (ValueError, lambda a: a.update(w=PQ.QuantizedLinear(
        a["w"].q[:, :12].mT.contiguous().mT, a["w"].s[:12]), b=a["b"][:12])),
    "codes-n-major": (ValueError, lambda a: a.update(w=PQ.QuantizedLinear(a["w"].q.contiguous(), a["w"].s))),
    "bias-shape": (ValueError, lambda a: a.update(b=a["b"][:16])),
    "bias-float16": (ValueError, lambda a: a.update(b=a["b"].half())),
    "x-last-axis-strided": (ValueError, lambda a: a.update(x=torch.randn((64, 40)).bfloat16().T)),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_kernel_wrapper_raises_on_what_the_kernel_does_not_take(case):
    err, spoil = _BAD[case]
    args = _kernel_args()
    spoil(args)
    before = PQ.int8_dense.launches
    with pytest.raises(err):
        PQ._w8a8(args["x"], [args["w"]], [args["b"]], args["out_dtype"])
    assert PQ.int8_dense.launches == before


# Clusters of 1 .. 8 decode CTAs an H100 80GB HBM3 runs at once
# (``ops.quant._slots`` on the card: one CTA an SM, 132 SMs).
_H100_SLOTS = (132, 66, 39, 30, 22, 17, 15, 15)
_TILED = (False, 128, 1, 0)


@pytest.mark.parametrize(
    "m,k,ns,want",
    [
        (1, 1280, (1280,), (True, 16, 5, 20)),
        (5, 1280, (1280,), (True, 16, 5, 20)),  # the sequential path's 5 beams
        (8, 1280, (1280,), (True, 16, 5, 20)),
        (16, 1280, (1280,), (True, 16, 5, 20)),
        (17, 1280, (1280,), (True, 32, 5, 20)),
        (32, 1280, (1280,), (True, 32, 5, 20)),
        (33, 1280, (1280,), (True, 64, 5, 20)),
        (40, 1280, (1280,), (True, 64, 5, 20)),  # a decode step at batch 8 x 5 beams: self o, cross q, o
        (40, 5120, (1280,), (True, 64, 5, 20)),  # mlp.w2
        (40, 1280, (5120,), (True, 64, 1, 80)),  # mlp.w1: whole tiles, a CTA each
        (40, 1280, (1280,) * 3, (True, 64, 2, 60)),  # self q, k, v in one launch
        (40, 1280, (51872,), (True, 64, 1, 132)),  # the logits head: a CTA an SM
        (5, 5120, (1280,), (True, 16, 5, 20)),
        (64, 1280, (1280,), (True, 64, 5, 20)),
        (16, 20480, (1280,), (True, 16, 5, 20)),
        (40, 64, (128,), (True, 64, 1, 2)),  # a row-parallel shard of a 128-wide model
        (40, 1040, (136,), (True, 64, 5, 3)),  # a ragged contraction tile
        (64, 20480, (1280,), _TILED),  # x's codes of a k-tile slice would not fit 8 CTAs
        (40, 5120, (5120,), _TILED),  # nor every tile at once, nor whole tiles
        (65, 1280, (1280,), _TILED),
        (1500, 1280, (1280,), _TILED),  # an encode window
        (12000, 1280, (1280,) * 3, _TILED),  # a batch of 8 windows
    ],
)
def test_plan_follows_the_row_count(m, k, ns, want):
    """The kernel's plan is a function of the shape and the card alone: up
    to 64 rows the decode plan (the weights' 64-row tiles as wgmma's A
    operand, x's rows in a B operand of 16, 32 or 64 columns that hold them
    all, every CTA resident at once); a cluster of at most 8 CTAs splits
    each tile's k-tiles where the card runs a cluster a tile at once, else
    each CTA takes whole tiles; above 64 rows, or where x's codes would not
    fit, 128-row tiles."""
    plan = PQ._plan(m, k, ns, _H100_SLOTS)
    assert tuple(plan) == want
    if plan.decode:
        k_tiles, tiles = -(-k // 128), sum(-(-n // 64) for n in ns)
        assert m <= plan.bn and 1 <= plan.cluster <= min(8, k_tiles)
        assert -(-k_tiles // plan.cluster) * plan.bn * 128 <= PQ._XS_BYTES  # x's codes a CTA keeps
        assert plan.clusters <= _H100_SLOTS[plan.cluster - 1]  # every CTA at once
        if plan.cluster > 1:
            assert plan.clusters == tiles  # a tile a cluster
            assert -(-k_tiles // -(-k_tiles // plan.cluster)) == plan.cluster  # no CTA without k-tiles
        else:
            assert plan.clusters == min(tiles, _H100_SLOTS[0])


@pytest.mark.parametrize("slots", [(16,) * 8, (78, 39, 26, 19, 15, 13, 11, 9), _H100_SLOTS,
                                   (144, 72, 48, 36, 28, 24, 16, 16)])
@pytest.mark.parametrize("k,ns", [(1280, (1280,)), (5120, (1280,)), (1280, (1280,) * 3), (1280, (51872,))])
def test_plan_fits_the_card_it_is_given(slots, k, ns):
    """On any card the decode plan launches no more CTAs than run at once
    (they quantize x together), and splits a tile's contraction only where
    every tile gets its cluster; a card too small for either takes the
    128-row tiles."""
    plan = PQ._plan(40, k, ns, slots)
    tiles = sum(-(-n // 64) for n in ns)
    if not plan.decode:
        assert tuple(plan) == _TILED and k > 18 * 128 and tiles > slots[-1]
        return
    assert 1 <= plan.clusters <= slots[plan.cluster - 1]
    assert plan.cluster == 1 or plan.clusters == tiles


def _codes_by_reciprocal(x, s):
    """``csrc/w8a8.cu::codes8_rcp`` in float32 numpy: q = RN(x RN(1 / s)),
    rounded half to even, unless q lies within 2^-13 of a half-integer,
    where the quotient is divided exactly."""
    y = np.float32(1) / s
    q = x * y
    n = np.rint(q)
    near = np.abs(np.abs(q - n) - np.float32(0.5)) <= np.float32(2.0**-13)
    return np.where(near, np.rint(x / s), n)


@pytest.mark.parametrize("seed", range(4))
def test_codes_by_reciprocal_round_as_the_division(seed):
    """The decode plan's codes take x times the scale's reciprocal, and the
    exact quotient only near a tie: every code equals rint(RN(x / s)), the
    composition's, on rows of random x and on x placed a few units in the
    last place from every half-integer quotient."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((64, 4096)) * 10.0 ** rng.uniform(-3, 3, (64, 1))).astype(np.float32)
    amax = np.abs(x).max(axis=1, keepdims=True)
    s = np.maximum(amax * np.float32(1.0 / 127), np.float32(1e-10)).astype(np.float32)
    ties = (np.arange(-127, 127, dtype=np.float32) + np.float32(0.5))[None, :] * s
    near = [np.nextafter(ties, np.float32(np.inf) * np.sign(d)) if d else ties for d in (-1, 0, 1)]
    for k in range(2, 5):
        near += [ties * np.float32(1 + d * k * 2.0**-23) for d in (-1, 1)]
    for xs in [x] + near:
        xs = np.clip(xs, -amax, amax).astype(np.float32)
        assert np.array_equal(_codes_by_reciprocal(xs, s), np.rint(xs / s))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 5, 17, 40, 1500, 12000])
def test_w8a8_kernel_equals_the_composition_on_the_card(card, m):
    """At m rows, K in {1280, 5120}, N in {1280, 5120, 51872} (and a
    row-parallel shard's 64 x 128, a ragged 1040 x 136): with and without
    a bias, bf16 and float32 outputs and inputs, a zero row, 4-bit-range
    codes: ``torch.equal`` to the composition on the card; and one
    quantization of x for three weights equal to three calls."""
    import chip_smoke

    assert chip_smoke.check_w8a8(rows=(m,)) == len(chip_smoke.W8A8_WIDTHS) * len(chip_smoke.W8A8_VARIANTS) + 3


@pytest.mark.cuda
def test_one_decode_step_launches_the_kernel_once_per_product(card, monkeypatch):
    """A small int8 model at a v3 step's rows (batch 8 x 5 beams): the
    encode, prefill and one decode step call ``torch._int_mm`` never, and
    the step launches the kernel once per ``int8_dense_many`` call, each a
    decode launch: 6 per decoder layer (self q, k and v together, out;
    cross q, out; mlp w1, w2) and the logits head."""
    import chip_smoke
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    cfg, cpu, tok = chip_smoke.small_model_parts()
    model = WhisperModel.from_parts(cpu, cfg, tok, compute_type="int8", device="cuda")
    calls, marks = [], []
    real = torch._int_mm
    monkeypatch.setattr(torch, "_int_mm", lambda *a, **k: calls.append(1) or real(*a, **k))
    g = torch.Generator(device="cuda")
    g.manual_seed(22)
    mel = torch.randn((8, cfg.n_mels, 3000), generator=g, device="cuda")
    tok0 = torch.randint(0, 256, (8,), generator=g, device="cuda")  # byte tokens of the small vocabulary
    chip_smoke._one_step_logits(model, model.model.encode(mel), tok0,
                                before_step=lambda: marks.append((PQ.int8_dense.launches,
                                                                  PQ.int8_dense.decode_launches)))
    torch.cuda.synchronize()
    launches = 6 * cfg.n_text_layer + 1
    assert PQ.int8_dense.launches - marks[0][0] == launches
    assert PQ.int8_dense.decode_launches - marks[0][1] == launches
    assert not calls


# The decode plan's card tests: every row count of a plan's bn, the decode's
# (K, N) (the logits head with float32 scores), and per shape the forms
# (x's dtype, the output's, the bias's or None, qmax, x's rows strided).
_DECODE_ROWS = (1, 5, 8, 16, 17, 32, 40, 64)
_DECODE_WIDTHS = ((1280, 1280), (5120, 1280), (1280, 5120), (1280, 51872))
_DECODE_FORMS = (
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, 127, False),
    (torch.float32, torch.float32, torch.float32, 127, True),
    (torch.bfloat16, torch.bfloat16, None, 7, True),
    (torch.float32, torch.bfloat16, torch.bfloat16, 7, False),
)


def _tiled_plan(m, k, ns, slots):
    """The plan above 64 rows, forced at any row count."""
    return PQ.W8A8Plan(False, 128, 1, 0)


def _card_inputs(m, k, n, x_dtype, bias_dtype, qmax, strided, seed):
    """x (m, k) on the card (its rows 64 elements wider apart when
    ``strided``, row m // 2 zero), a (k, n) weight quantized on the card,
    a bias or None."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = torch.randn((m, k + 64 * strided), generator=g, device="cuda").to(x_dtype)[:, :k]
    if m > 1:
        x[m // 2] = 0
    w = PQ.quantize_weight(0.02 * torch.randn((k, n), generator=g, device="cuda"), qmax=qmax)
    b = None if bias_dtype is None else torch.randn((n,), generator=g, device="cuda").to(bias_dtype)
    return x, w, b


def _on_host(x, w, b):
    return x.cpu(), PQ.QuantizedLinear(w.q.cpu().contiguous(), w.s.cpu()), None if b is None else b.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", _DECODE_WIDTHS, ids=[f"{k}x{n}" for k, n in _DECODE_WIDTHS])
@pytest.mark.parametrize("m", _DECODE_ROWS)
def test_decode_plan_equals_the_composition_and_the_tiled_plan(card, monkeypatch, m, k, n):
    """One decode launch per call, ``torch.equal`` to the composition
    (``_quantize_rows``, ``_int_mm``, ``_rescale``) on the host and to the
    plan above 64 rows forced on the same inputs, in every form."""
    for i, (x_dtype, out_dtype, bias_dtype, qmax, strided) in enumerate(_DECODE_FORMS):
        if n > 5120:  # the logits head: float32 scores
            out_dtype = torch.float32
        x, w, b = _card_inputs(m, k, n, x_dtype, bias_dtype, qmax, strided, seed=m + k + n + i)
        assert m == 1 or x.is_contiguous() != strided  # one row is contiguous however wide its parent
        before = (PQ.int8_dense.launches, PQ.int8_dense.decode_launches)
        got = PQ.int8_dense(x, w, b, out_dtype=out_dtype)
        assert (PQ.int8_dense.launches - before[0], PQ.int8_dense.decode_launches - before[1]) == (1, 1)
        with monkeypatch.context() as patch:
            patch.setattr(PQ, "_plan", _tiled_plan)
            tiled = PQ.int8_dense(x, w, b, out_dtype=out_dtype)
        assert PQ.int8_dense.decode_launches - before[1] == 1
        want = _composition(*_on_host(x, w, b), out_dtype)
        assert got.dtype == out_dtype and torch.equal(got.cpu(), want), (i, int((got.cpu() != want).sum()))
        assert torch.equal(got, tiled)


def _three(m, seed):
    """x (m, 1280) bf16 and the q, k, v weights (1280, 1280) with biases
    (bq, None, bv)."""
    x, wq, bq = _card_inputs(m, 1280, 1280, torch.bfloat16, torch.bfloat16, 127, False, seed)
    wk = _card_inputs(1, 1280, 1280, torch.bfloat16, None, 127, False, seed + 1)[1]
    wv, bv = _card_inputs(1, 1280, 1280, torch.bfloat16, torch.bfloat16, 127, False, seed + 2)[1:]
    return x, (wq, wk, wv), (bq, None, bv)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [5, 40, 64])
def test_decode_plan_takes_three_weights_in_one_launch(card, m):
    """``int8_dense_many`` over q, k and v with biases (bq, None, bv) is
    one decode launch, equal to three single calls."""
    x, ws, bs = _three(m, seed=m)
    before = (PQ.int8_dense.launches, PQ.int8_dense.decode_launches)
    many = PQ.int8_dense_many(x, ws, bs)
    assert (PQ.int8_dense.launches - before[0], PQ.int8_dense.decode_launches - before[1]) == (1, 1)
    singles = [PQ.int8_dense(x, w, b) for w, b in zip(ws, bs)]
    assert all(torch.equal(y, s) for y, s in zip(many, singles))
    assert torch.equal(many[1].cpu(), _composition(*_on_host(x, ws[1], None), torch.bfloat16))


@pytest.mark.cuda
def test_decode_plan_replays_in_a_cuda_graph(card):
    """The three-weight call captured in a CUDA graph and replayed twice on
    new inputs gives the eager call's bits on each."""
    x, ws, bs = _three(40, seed=3)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        PQ.int8_dense_many(x, ws, bs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = PQ.int8_dense_many(x, ws, bs)
    g = torch.Generator(device="cuda")
    for seed in (1, 2):
        g.manual_seed(seed)
        x.copy_(torch.randn(x.shape, generator=g, device="cuda"))
        graph.replay()
        torch.cuda.synchronize()
        eager = PQ.int8_dense_many(x, ws, bs)
        assert all(torch.equal(y, e) for y, e in zip(outs, eager))
        assert torch.equal(outs[0].cpu(), _composition(*_on_host(x, ws[0], bs[0]), torch.bfloat16))


@pytest.mark.cuda
def test_card_group_weights_and_strays_on_the_card(card):
    """On the card a group-scale weight keeps the composition (no kernel
    launch, its exact int32 partials); per-channel codes that are not in
    ``card_layout`` raise."""
    g = torch.Generator(device="cuda")
    g.manual_seed(9)
    x = torch.randn((40, 1280), generator=g, device="cuda").bfloat16()
    w = PQ.quantize_weight(0.02 * torch.randn((1280, 1280), generator=g, device="cuda"), qmax=7, group_size=128)
    before = PQ.int8_dense.launches
    assert torch.equal(PQ.int8_dense(x, w), _composition(x, w, None, torch.bfloat16))
    assert PQ.int8_dense.launches == before
    w = PQ.quantize_weight(0.02 * torch.randn((1280, 1280), generator=g, device="cuda"))
    assert w.q.stride() == (1, 1280)
    with pytest.raises(ValueError):
        PQ.int8_dense(x, PQ.QuantizedLinear(w.q.contiguous(), w.s))
