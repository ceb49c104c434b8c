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


@pytest.mark.parametrize(
    "m,want",
    [
        (1, (1, 16)),
        (5, (1, 16)),  # the sequential path's 5 beams
        (16, (1, 16)),
        (17, (1, 32)),
        (32, (1, 32)),
        (33, (1, 64)),
        (40, (1, 64)),  # a decode step at batch 8 x 5 beams
        (64, (1, 64)),
        (65, (0, 128)),
        (1500, (0, 128)),  # an encode window
        (12000, (0, 128)),  # a batch of 8 windows
    ],
)
def test_plan_follows_the_row_count(m, want):
    """The kernel's plan is a function of the row count alone: up to 64
    rows the weight streams as wgmma's A operand and x's rows ride in a B
    operand of 16, 32 or 64 columns, that hold them all; above, 128-row
    tiles."""
    swap, bn = PQ._plan(m)
    assert (swap, bn) == want
    assert not swap or m <= bn


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
    the step launches the kernel once per product: 8 per decoder layer
    (self q, k, v, out; cross q, out; mlp w1, w2) and the logits head."""
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
                                before_step=lambda: marks.append(PQ.int8_dense.launches))
    torch.cuda.synchronize()
    assert PQ.int8_dense.launches - marks[0] == 8 * cfg.n_text_layer + 1
    assert not calls


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
