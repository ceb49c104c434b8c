"""Int8 quantization: W8A8 weights and the int8 KV cache.

Counterpart of ``faster_whisper_tpu/ops/quant.py`` for ``compute_type``
int8 (per-output-channel weight scales; the group-wise scales of int4 are
not ported):

  * weights: symmetric per-output-channel int8, scale = max|w|/127;
  * activations: dynamic symmetric per-row int8 at matmul time;
  * the product is int8 x int8 -> int32 (``torch._int_mm``; the JAX
    package leaves the same product to XLA, outside any Pallas kernel),
    rescaled in float32.

Rounding is half to even (``torch.round``, as ``jnp.round``) and every
float32 operation runs in the JAX package's order, so codes and scales
come out equal to its own.  A scale is max|x| times the float32
reciprocal of qmax: the JAX package writes ``max|x| / qmax``, and XLA
compiles that division by a constant into this product (on the CPU, where
the tests run it under ``jit``); a product by a scalar is also what
PyTorch's CUDA division by a scalar computes.  The two differ in the last
bit for a few percent of rows.
"""

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

# torch._int_mm on a CUDA tensor wants more than 16 rows and a contraction
# and output width that are multiples of 8.
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8


class QuantizedLinear(NamedTuple):
    """An int8 weight matrix: q (..., in, out) int8, s (..., out) float32
    per output channel."""

    q: torch.Tensor
    s: torch.Tensor


class QuantKV(NamedTuple):
    """An int8 K or V cache: q (..., D) int8 codes, s the scale of each
    row over D (one per position and head)."""

    q: torch.Tensor
    s: torch.Tensor


def quantize_weight(w: torch.Tensor, axis: int = -2, qmax: int = 127) -> QuantizedLinear:
    """Symmetric per-output-channel quantization of an (..., in, out)
    weight; ``axis`` is the contraction (input) dimension."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax * (1.0 / qmax), min=1e-10)
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax).to(torch.int8)
    return QuantizedLinear(q=q, s=scale.squeeze(axis))


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32.  On the card, rows are
    padded with zeros up to ``_INT_MM_MIN_ROWS`` and sliced off again."""
    if not a.is_cuda:
        return torch._int_mm(a, b)
    m, k = a.shape
    if k % _INT_MM_ALIGN or b.shape[1] % _INT_MM_ALIGN:
        raise ValueError(
            f"int8_dense: torch._int_mm on the card needs the widths {k} and "
            f"{b.shape[1]} to be multiples of {_INT_MM_ALIGN}"
        )
    if m < _INT_MM_MIN_ROWS:
        return torch._int_mm(F.pad(a, (0, 0, 0, _INT_MM_MIN_ROWS - m)), b)[:m]
    return torch._int_mm(a, b)


def int8_dense(
    x: torch.Tensor,  # (..., in) bf16/f32
    w: QuantizedLinear,  # q (in, out), s (out,)
    b: Optional[torch.Tensor] = None,
    out_dtype=None,
) -> torch.Tensor:
    """y = x @ dequant(w) + b with dynamic per-row activation quantization
    and an int8 x int8 -> int32 product.  ``out_dtype`` overrides the
    output cast (the logits head wants float32 scores)."""
    xf = x.float()
    sx = xf.abs().amax(dim=-1, keepdim=True) * (1.0 / 127)
    sx = torch.clamp(sx, min=1e-10)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    acc = _int_mm(xq.reshape(-1, xq.shape[-1]), w.q)
    y = acc.reshape(*x.shape[:-1], -1).float() * sx * w.s
    if b is not None:
        y = y + b.float()
    return y.to(out_dtype or x.dtype)


def _quant_attn(p):
    out = dict(p)
    for name in ("wq", "wk", "wv", "wo"):
        out[name] = quantize_weight(p[name])
    return out


def _quant_mlp(p):
    return dict(p, w1=quantize_weight(p["w1"]), w2=quantize_weight(p["w2"]))


def quantize_params(params: dict) -> dict:
    """int8 (W8A8) quantization of a Whisper parameter tree: every
    transformer-layer matmul weight becomes a QuantizedLinear; embeddings,
    the conv stem and the layernorms keep their dtype.  The tied output
    projection gets its own int8 transpose ``decoder.logits_w``, whose
    columns are padded with zeros to a multiple of 8 (the card's int8
    product needs it); ``models/model.py::_logits`` slices the logits back
    to the vocabulary."""
    enc_layers = dict(params["encoder"]["layers"])
    enc_layers["attn"] = _quant_attn(enc_layers["attn"])
    enc_layers["mlp"] = _quant_mlp(enc_layers["mlp"])

    dec_layers = dict(params["decoder"]["layers"])
    dec_layers["self_attn"] = _quant_attn(dec_layers["self_attn"])
    dec_layers["cross_attn"] = _quant_attn(dec_layers["cross_attn"])
    dec_layers["mlp"] = _quant_mlp(dec_layers["mlp"])

    embed_t = params["decoder"]["token_embed"].float().t()  # (d, V)
    pad = -embed_t.shape[1] % _INT_MM_ALIGN
    out = dict(params)
    out["encoder"] = dict(params["encoder"], layers=enc_layers)
    out["decoder"] = dict(
        params["decoder"],
        layers=dec_layers,
        logits_w=quantize_weight(F.pad(embed_t, (0, pad))),
    )
    return out


def quantize_kv(x: torch.Tensor, qmax: int = 127) -> QuantKV:
    """Quantize a (..., D) K/V tensor over D: one float32 scale per row."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1) * (1.0 / qmax), min=1e-10)
    q = torch.clamp(torch.round(xf / s[..., None]), -qmax, qmax).to(torch.int8)
    return QuantKV(q=q, s=s)
