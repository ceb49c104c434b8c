"""Int8 and int4 quantization: W8A8 and W4A8 weights and the int8 KV cache.

Counterpart of ``faster_whisper_tpu/ops/quant.py``:

  * weights: symmetric per-output-channel int8, scale = max|w|/127; for
    ``compute_type="int4"`` the decoder's weights and the logits head at
    4-bit range (codes in [-7, 7], kept in int8 storage), per output
    channel or with one scale per group of ``group_size`` input rows;
  * activations: dynamic symmetric per-row int8 at matmul time;
  * the product is int8 x int8 -> int32 (``torch._int_mm``; the JAX
    package leaves the same product to XLA, outside any Pallas kernel),
    rescaled in float32; with group scales, one product per group of
    input rows, each partial times its own scales, summed over the groups
    in float32.

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
# and output width that are multiples of 8.  Below a contraction of 128
# (group scales of 64 input rows or fewer), cuBLASLt on the H100 refused
# every row count that was not a multiple of 32 (CUBLAS_STATUS_NOT_SUPPORTED
# at 17, 40, 1500 and 3000 rows; 1504 rows ran).
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8
_SHORT_K = 128
_SHORT_K_ROW_ALIGN = 32


class QuantizedLinear(NamedTuple):
    """An int8 weight matrix: q (..., in, out) int8, s (..., out) float32
    per output channel, or (..., in/G, out) per group of G input rows and
    output channel (``s.dim() == q.dim()`` marks the group-wise form)."""

    q: torch.Tensor
    s: torch.Tensor


class QuantKV(NamedTuple):
    """An int8 K or V cache: q (..., D) int8 codes, s the scale of each
    row over D (one per position and head)."""

    q: torch.Tensor
    s: torch.Tensor


def quantize_weight(
    w: torch.Tensor, axis: int = -2, qmax: int = 127, group_size: Optional[int] = None,
) -> QuantizedLinear:
    """Symmetric per-output-channel quantization of an (..., in, out)
    weight; ``axis`` is the contraction (input) dimension.  ``qmax=7``
    gives 4-bit-range codes, still stored as int8.  ``group_size=G`` takes
    one scale per (group of G input rows, output channel) instead; it
    needs ``axis=-2`` and an input width that G divides."""
    wf = w.float()
    if group_size is None:
        amax = wf.abs().amax(dim=axis, keepdim=True)
        scale = torch.clamp(amax * (1.0 / qmax), min=1e-10)
        q = torch.clamp(torch.round(wf / scale), -qmax, qmax).to(torch.int8)
        return QuantizedLinear(q=q, s=scale.squeeze(axis))

    if axis not in (-2, wf.dim() - 2):
        raise ValueError("quantize_weight: group-wise scales assume an (..., in, out) weight")
    d_in, d_out = wf.shape[-2], wf.shape[-1]
    if group_size < 1 or d_in % group_size:
        raise ValueError(f"quantize_weight: group_size {group_size} does not divide the input width {d_in}")
    wg = wf.reshape(*wf.shape[:-2], d_in // group_size, group_size, d_out)
    amax = wg.abs().amax(dim=-2, keepdim=True)  # (..., nG, 1, out)
    scale = torch.clamp(amax * (1.0 / qmax), min=1e-10)
    q = torch.clamp(torch.round(wg / scale), -qmax, qmax).to(torch.int8)
    return QuantizedLinear(q=q.reshape(wf.shape), s=scale.squeeze(-2))


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
    w: QuantizedLinear,  # q (in, out), s (out,) or (nG, out)
    b: Optional[torch.Tensor] = None,
    out_dtype=None,
) -> torch.Tensor:
    """y = x @ dequant(w) + b with dynamic per-row activation quantization
    and an int8 x int8 -> int32 product.  ``out_dtype`` overrides the
    output cast (the logits head wants float32 scores).  Group-wise scales
    take one product per group of input rows (``torch._int_mm`` into one
    int32 buffer of the groups' partials); each partial is rescaled by its own
    scales and the groups summed in float32, then rescaled by the rows'."""
    xf = x.float()
    sx = xf.abs().amax(dim=-1, keepdim=True) * (1.0 / 127)
    sx = torch.clamp(sx, min=1e-10)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    x2 = xq.reshape(-1, xq.shape[-1])
    if w.s.dim() == w.q.dim():
        n_g, d_out = w.s.shape
        g = w.q.shape[0] // n_g
        m = x2.shape[0]
        rows = m
        if x2.is_cuda:
            rows = max(m, _INT_MM_MIN_ROWS)
            if g < _SHORT_K:
                rows = -(-rows // _SHORT_K_ROW_ALIGN) * _SHORT_K_ROW_ALIGN
        # (nG, rows, G): each group's activation columns, contiguous, the
        # rows padded here for the card's torch._int_mm
        xg = F.pad(x2, (0, 0, 0, rows - m)).reshape(rows, n_g, g).transpose(0, 1).contiguous()
        acc = torch.empty((n_g, rows, d_out), dtype=torch.int32, device=x2.device)
        for i in range(n_g):
            torch._int_mm(xg[i], w.q[i * g : (i + 1) * g], out=acc[i])
        y = (acc[:, :m].float() * w.s[:, None, :]).sum(dim=0).reshape(*x.shape[:-1], d_out) * sx
    else:
        acc = _int_mm(x2, w.q)
        y = acc.reshape(*x.shape[:-1], -1).float() * sx * w.s
    if b is not None:
        y = y + b.float()
    return y.to(out_dtype or x.dtype)


def _quantize_params(params: dict, dec_qmax: int, group_size: Optional[int] = None) -> dict:
    """Every transformer-layer matmul weight becomes a QuantizedLinear;
    embeddings, the conv stem and the layernorms keep their dtype.  The
    tied output projection gets its own quantized transpose
    ``decoder.logits_w``, whose columns are padded with zeros to a
    multiple of 8 (the card's int8 product needs it);
    ``models/model.py::_logits`` slices the logits back to the vocabulary.

    ``dec_qmax=7`` puts the decoder's matmuls and the logits head at 4-bit
    range (``compute_type="int4"``), with group-wise scales where
    ``group_size`` is given; the encoder stays at int8 range, per output
    channel."""

    def qw(w, qmax):
        return quantize_weight(w, qmax=qmax, group_size=group_size if qmax < 127 else None)

    def quant_attn(p, qmax):
        return dict(p, **{name: qw(p[name], qmax) for name in ("wq", "wk", "wv", "wo")})

    def quant_mlp(p, qmax):
        return dict(p, w1=qw(p["w1"], qmax), w2=qw(p["w2"], qmax))

    enc_layers = dict(params["encoder"]["layers"])
    enc_layers["attn"] = quant_attn(enc_layers["attn"], 127)
    enc_layers["mlp"] = quant_mlp(enc_layers["mlp"], 127)

    dec_layers = dict(params["decoder"]["layers"])
    dec_layers["self_attn"] = quant_attn(dec_layers["self_attn"], dec_qmax)
    dec_layers["cross_attn"] = quant_attn(dec_layers["cross_attn"], dec_qmax)
    dec_layers["mlp"] = quant_mlp(dec_layers["mlp"], dec_qmax)

    embed_t = params["decoder"]["token_embed"].float().t()  # (d, V)
    pad = -embed_t.shape[1] % _INT_MM_ALIGN
    out = dict(params)
    out["encoder"] = dict(params["encoder"], layers=enc_layers)
    out["decoder"] = dict(
        params["decoder"],
        layers=dec_layers,
        logits_w=qw(F.pad(embed_t, (0, pad)), dec_qmax),
    )
    return out


def quantize_params(params: dict) -> dict:
    """int8 (W8A8) quantization of a Whisper parameter tree (see
    ``_quantize_params``)."""
    return _quantize_params(params, 127)


def quantize_params_int4(params: dict, group_size: Optional[int] = None) -> dict:
    """``compute_type="int4"``: the decoder's matmuls and the logits head
    at 4-bit range (codes in [-7, 7], int8 storage), the encoder at int8
    range.  ``group_size`` (e.g. 64 or 128) gives the 4-bit weights one
    scale per group of that many input rows.  The codes stay unpacked: the
    JAX package packs them to int4 inside its decode program, which leaves
    its outputs unchanged."""
    return _quantize_params(params, 7, group_size)


def quantize_kv(x: torch.Tensor, qmax: int = 127) -> QuantKV:
    """Quantize a (..., D) K/V tensor over D: one float32 scale per row."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1) * (1.0 / qmax), min=1e-10)
    q = torch.clamp(torch.round(xf / s[..., None]), -qmax, qmax).to(torch.int8)
    return QuantKV(q=q, s=s)
