"""The port's int8 quantization (``ops/quant.py``) against the JAX
package's, on the same numpy inputs from a seed.

The JAX functions run under ``jax.jit``, as the JAX package runs them
(``quantize_params`` is jitted, the others run inside jitted programs).

Tolerances: codes and scales must be exactly equal (the same float32
operations in the same order, rounding half to even on both sides); the
int8 dense in float32 within 1e-5 relative (its int32 products are exact;
the rescale is the same float32 chain)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from faster_whisper_tpu.models.config import tiny_test_config as jax_config
from faster_whisper_tpu.models.load import random_params as jax_random_params
from faster_whisper_tpu.ops import quant as JQ
from faster_whisper_tpu_torch.models.load import params_from_jax
from faster_whisper_tpu_torch.ops import quant as PQ

F32_REL = 1e-5


@pytest.fixture(autouse=True)
def _no_shipped_compile_cache(monkeypatch):
    """The JAX side runs without the shipped compile-cache entries."""
    monkeypatch.setenv("FWT_CACHE_ARTIFACTS", "/nonexistent")


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
