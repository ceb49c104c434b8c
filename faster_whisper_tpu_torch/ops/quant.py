"""Int8 and int4 quantization: W8A8 and W4A8 weights and the int8 KV cache.

Counterpart of ``faster_whisper_tpu/ops/quant.py``:

  * weights: symmetric per-output-channel int8, scale = max|w|/127; for
    ``compute_type="int4"`` the decoder's weights and the logits head at
    4-bit range (codes in [-7, 7], kept in int8 storage), per output
    channel or with one scale per group of ``group_size`` input rows;
  * activations: dynamic symmetric per-row int8 at matmul time;
  * the product is int8 x int8 -> int32, rescaled in float32 (the JAX
    package leaves it to XLA, outside any Pallas kernel); with group
    scales, one product per group of input rows, each partial times its
    own scales, summed over the groups in float32.

On the card, a weight with per-channel scales takes the hand-written
kernel of ``csrc/w8a8.cu`` (``int8_dense``, counted in
``int8_dense.launches``), which gives the bits of the PyTorch composition
``_quantize_rows``, ``_int_mm``, ``_rescale``: up to 64 rows of x, one
launch for x and up to three weights that quantizes x inside, once for the
grid, and splits each weight tile's contraction over a thread-block
cluster where the card has the room (``int8_dense.decode_launches``; its
state, x's codes and a counter, is one buffer a device, ``_state``);
above, the row quantization, then the int8 product on ``wgmma`` with the
rescale in its epilogue.  Its codes are laid out for it when they are made
on the card (``card_layout``).  ``torch._int_mm`` remains only on the
group-scale path (``_int8_product``) and the tensor-parallel one
(``int8_dense_rows``); the CPU runs the composition, the plain version.

Rounding is half to even (``torch.round``, as ``jnp.round``) and every
float32 operation runs in the JAX package's order, so codes and scales
come out equal to its own.  A scale is max|x| times the float32
reciprocal of qmax: the JAX package writes ``max|x| / qmax``, and XLA
compiles that division by a constant into this product (on the CPU, where
the tests run it under ``jit``); a product by a scalar is also what
PyTorch's CUDA division by a scalar computes.  The two differ in the last
bit for a few percent of rows.
"""

import ctypes

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from faster_whisper_tpu_torch.ops import _build
from faster_whisper_tpu_torch.tracing import span

# torch._int_mm on a CUDA tensor wants more than 16 rows and a contraction
# and output width that are multiples of 8.  Below a contraction of 128
# (group scales of 64 input rows or fewer; a row-parallel shard of 64 input
# rows, a 128-wide model over two shards), cuBLASLt on the H100 refused
# every row count that was not a multiple of 32 (CUBLAS_STATUS_NOT_SUPPORTED
# at 17, 40, 1500 and 3000 rows; 1504 rows ran).
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8
_SHORT_K = 128
_SHORT_K_ROW_ALIGN = 32

# csrc/w8a8.cu: the widths it takes (TMA rows 16-byte aligned, columns
# stored in vectors of 4 and pairs), the rows up to which it takes the
# decode plan, and that plan's sizes: weight rows a tile, contraction bytes
# a k-tile, CTAs a cluster at most (the portable cluster size), weights a
# launch, and the bytes of x's codes a CTA may keep (XS_BYTES).
_K_ALIGN = 16
_N_ALIGN = 8
_SMALL_M = 64
_TILE_ROWS = 64
_KT = 128
_MAX_CLUSTER = 8
_MAX_WEIGHTS = 3
_XS_BYTES = 144 * 1024
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}  # x's or y's dtype -> the kernel's f32 flag


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
        return card_layout(QuantizedLinear(q=q, s=scale.squeeze(axis)))

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


def card_layout(w: QuantizedLinear) -> QuantizedLinear:
    """``w`` as the card's kernel reads it: per-channel codes on a CUDA
    device as the (..., in, out) view of (..., out, in)-contiguous memory
    (``csrc/w8a8.cu``: s8 ``wgmma`` reads its operands K-major only), a
    copy where they are not so already.  Group-scale and host weights come
    back unchanged.  ``quantize_weight`` calls it; so does whatever slices
    codes on the card (``parallel/mesh.py::shard_params``)."""
    q = w.q
    if not q.is_cuda or w.s.dim() == q.dim() or q.stride(-2) == 1:
        return w
    return QuantizedLinear(q.mT.contiguous().mT, w.s)


class W8A8Plan(NamedTuple):
    """How ``csrc/w8a8.cu`` runs one launch (``_plan``)."""

    decode: bool  # the decode plan: one launch, x quantized inside
    bn: int  # x's rows in wgmma's B operand (decode), or the output tile's width (M > 64)
    cluster: int  # CTAs a cluster, splitting each tile's k-tiles; 1: each CTA takes whole tiles
    clusters: int  # clusters (CTAs for whole tiles) launched; 0: the kernel fills the card (M > 64)


def _plan(m: int, k: int, ns, slots) -> W8A8Plan:
    """The plan of one launch over ``m`` rows of x, a contraction of ``k``
    and the weights' widths ``ns``, on a card that runs ``slots[c - 1]``
    clusters of c decode CTAs at once (``_slots``: one CTA an SM): from the
    shape and the card alone.

    Above 64 rows, 128-row tiles of x against 128 weight rows, x quantized
    by a launch of its own.  Up to 64 rows, the decode plan: the weights'
    64-row tiles are wgmma's A operand and x's rows a B operand of ``bn`` =
    16, 32 or 64 columns, and the whole grid runs at once (it quantizes x
    together, behind a count every CTA waits for).  Where a cluster of
    several CTAs a tile fits every tile at once, the cluster splits each
    tile's 128-byte k-tiles: the fewest k-tiles a CTA, then the fewest
    CTAs.  Else each CTA takes whole tiles, as many CTAs as run at once.  A CTA keeps its k-tiles
    of x's codes in shared memory (``_XS_BYTES``); a contraction too long
    for that takes the tiles of 128 rows.  Every plan gives the same bits (a
    max and an int32 sum in any order, a rescale per element)."""
    if m > _SMALL_M:
        return W8A8Plan(False, 128, 1, 0)
    bn = 16 if m <= 16 else 32 if m <= 32 else 64
    tiles = sum(-(-n // _TILE_ROWS) for n in ns)
    k_tiles = -(-k // _KT)
    keep = _XS_BYTES // (bn * _KT)  # k-tiles of x's codes a CTA keeps
    fits = [c for c in range(2, min(_MAX_CLUSTER, k_tiles) + 1)
            if -(-k_tiles // c) <= keep and tiles <= slots[c - 1]]
    if fits:
        return W8A8Plan(True, bn, min(fits, key=lambda c: (-(-k_tiles // c), c)), tiles)
    if k_tiles > keep:
        return W8A8Plan(False, 128, 1, 0)
    return W8A8Plan(True, bn, 1, min(tiles, slots[0]))


_SLOTS = {}  # device index -> clusters of 1 .. 8 decode CTAs the card runs at once
_STATE = {}  # device index -> the decode plan's state (csrc/w8a8.cu: x's codes and scales, a count)


def _slots(dev: torch.device) -> tuple:
    slots = _SLOTS.get(dev.index)
    if slots is None:
        fn, n, found = _build.load("w8a8.cu").fwt_w8a8_cluster_slots, ctypes.c_int(), []
        with torch.cuda.device(dev):
            for c in range(1, _MAX_CLUSTER + 1):
                _build.check(fn(c, ctypes.byref(n)), "int8_dense: the cluster slots")
                found.append(n.value)
        slots = _SLOTS[dev.index] = tuple(found)
    return slots


def _state(dev: torch.device) -> torch.Tensor:
    """The device's decode state, zeroed once and kept: CUDA graphs hold
    its address."""
    state = _STATE.get(dev.index)
    if state is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("int8_dense: run one product of up to 64 rows on the device before capturing a "
                               "CUDA graph of one (its decode state is made then)")
        nbytes = _build.load("w8a8.cu").fwt_w8a8_state_bytes()
        state = _STATE[dev.index] = torch.zeros(nbytes, dtype=torch.uint8, device=dev)
    return state


def _int_mm_rows(m: int, k: int) -> int:
    """The rows the card's ``torch._int_mm`` takes for ``m`` rows over a
    contraction of ``k``: at least ``_INT_MM_MIN_ROWS``, and a multiple of
    ``_SHORT_K_ROW_ALIGN`` below a contraction of ``_SHORT_K`` (int4 groups
    of 64 rows or fewer, a row-parallel shard of a narrow model)."""
    rows = max(m, _INT_MM_MIN_ROWS)
    if k < _SHORT_K:
        rows = -(-rows // _SHORT_K_ROW_ALIGN) * _SHORT_K_ROW_ALIGN
    return rows


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32.  On the card, rows are
    padded with zeros up to ``_int_mm_rows`` and sliced off again."""
    if not a.is_cuda:
        return torch._int_mm(a, b)
    m, k = a.shape
    if k % _INT_MM_ALIGN or b.shape[1] % _INT_MM_ALIGN:
        raise ValueError(
            f"int8_dense: torch._int_mm on the card needs the widths {k} and "
            f"{b.shape[1]} to be multiples of {_INT_MM_ALIGN}"
        )
    rows = _int_mm_rows(m, k)
    if rows != m:
        return torch._int_mm(F.pad(a, (0, 0, 0, rows - m)), b)[:m]
    return torch._int_mm(a, b)


def _quantize_rows(xf: torch.Tensor, amax: torch.Tensor):
    """Per-row int8 codes of ``xf`` at the scale ``amax`` / 127, and that
    scale."""
    sx = torch.clamp(amax * (1.0 / 127), min=1e-10)
    return torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8), sx


def _int8_product(xq: torch.Tensor, w: QuantizedLinear) -> torch.Tensor:
    """xq (..., in) int8 @ w.q: the int32 product (..., out) with per-channel
    scales; with group scales, the float32 sum over the groups of each
    group's int32 partial times its scales (one ``torch._int_mm`` per group
    into one int32 buffer)."""
    x2 = xq.reshape(-1, xq.shape[-1])
    if w.s.dim() != w.q.dim():
        return _int_mm(x2, w.q).reshape(*xq.shape[:-1], -1)
    n_g, d_out = w.s.shape
    g = w.q.shape[0] // n_g
    m = x2.shape[0]
    rows = _int_mm_rows(m, g) if x2.is_cuda else m
    # (nG, rows, G): each group's activation columns, contiguous, the rows
    # padded here for the card's torch._int_mm
    xg = F.pad(x2, (0, 0, 0, rows - m)).reshape(rows, n_g, g).transpose(0, 1).contiguous()
    acc = torch.empty((n_g, rows, d_out), dtype=torch.int32, device=x2.device)
    for i in range(n_g):
        torch._int_mm(xg[i], w.q[i * g : (i + 1) * g], out=acc[i])
    return (acc[:, :m].float() * w.s[:, None, :]).sum(dim=0).reshape(*xq.shape[:-1], d_out)


def _rescale(acc: torch.Tensor, sx: torch.Tensor, w: QuantizedLinear, b, out_dtype):
    if w.s.dim() == w.q.dim():
        y = acc * sx  # the groups' scales are in the float32 sum already
    else:
        y = acc.float() * sx * w.s
    if b is not None:
        y = y + b.float()
    return y.to(out_dtype)


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
    scales and the groups summed in float32, then rescaled by the rows'.
    On a CUDA tensor with per-channel scales: the kernel of
    ``csrc/w8a8.cu`` (``_w8a8``), bit-equal to the composition below and
    counted in ``int8_dense.launches`` (and ``.decode_launches``); it
    raises on what it does not take.  Group scales on the card, and every
    CPU tensor, take the composition.  The call is the span
    ``fwt.int8_dense``."""
    return int8_dense_many(x, (w,), (b,), out_dtype)[0]


def int8_dense_many(x: torch.Tensor, ws, bs, out_dtype=None) -> list:
    """``[int8_dense(x, w, b) for w, b in zip(ws, bs)]``, the same bits: on
    the card, with per-channel scales, x's rows are quantized once for all
    the weights (the self-attention's q, k and v; the cross-attention's k
    and v), and up to 64 rows one launch takes x and three weights.  Each
    launch of a product kernel is a span ``fwt.int8_dense``."""
    out_dtype = out_dtype or x.dtype
    if x.is_cuda and all(w.s.dim() != w.q.dim() for w in ws):
        return _w8a8(x, ws, bs, out_dtype)
    outs = []
    for w, b in zip(ws, bs):
        with span("fwt.int8_dense"):
            xf = x.float()
            xq, sx = _quantize_rows(xf, xf.abs().amax(dim=-1, keepdim=True))
            outs.append(_rescale(_int8_product(xq, w), sx, w, b, out_dtype))
    return outs


# csrc/w8a8.cu's product kernels: one a weight above 64 rows (after x's
# quantization, a launch of its own per x), one for x and up to three
# weights up to 64 rows (the decode plan, counted in decode_launches too)
int8_dense.launches = 0
int8_dense.decode_launches = 0


def _w8a8(x: torch.Tensor, ws, bs, out_dtype) -> list:
    """``int8_dense_many`` on the card for per-channel scales: x (..., K)
    bfloat16 or float32 with a contiguous last axis and 16-byte aligned
    rows; each w.q (K, N) int8 in ``card_layout`` (16-byte aligned), w.s
    (N,) float32; each b None or (N,) bfloat16 or float32; ``out_dtype``
    bfloat16 or float32; K a multiple of 16, N of 8; all on x's device.
    Anything else raises.  The host's cost per call is most of an eager
    decode step's, so each property is read once.  The decode plan's
    launches share the device's ``_state``: they run on one stream, as
    every kernel of the port's decode does."""
    dev, k = x.device, x.shape[-1]
    x_f32, out_f32 = _DTYPES.get(x.dtype), _DTYPES.get(out_dtype)
    if x_f32 is None or out_f32 is None:
        raise TypeError(f"int8_dense: x {x.dtype} and out {out_dtype}, the kernel takes bfloat16 or float32")
    if k % _K_ALIGN:
        raise ValueError(f"int8_dense: x's width {k}, the kernel takes a multiple of {_K_ALIGN}")
    m = x.numel() // k
    if x.is_contiguous():
        rows, ldx = x, k
    else:  # a view where the leading axes flatten to one stride, else a copy
        rows = x.reshape(-1, k)
        ldx = rows.stride(0) if m > 1 else k
        if rows.stride(1) != 1:
            raise ValueError("int8_dense: the last axis of x must be contiguous")
    if (ldx << (1 + x_f32)) % 16 or rows.data_ptr() % 16:
        raise ValueError("int8_dense: x's rows must be 16-byte aligned")
    args = [_weight_args(w, b, k, dev) for w, b in zip(ws, bs)]
    outs = [torch.empty((*x.shape[:-1], a[2]), dtype=out_dtype, device=dev) for a in args]
    if not m:
        return outs
    lib = _build.load("w8a8.cu")
    xa = (rows.data_ptr(), x_f32, ldx, m, k)
    groups = [range(i, min(i + _MAX_WEIGHTS, len(args))) for i in range(0, len(args), _MAX_WEIGHTS)]
    tiled = []
    for group in groups:
        plan = _plan(m, k, [args[j][2] for j in group], _slots(dev)) if m <= _SMALL_M else _plan(m, k, (), ())
        if not plan.decode:
            tiled += group
            continue
        slots = []
        for j in group:
            slots += [*args[j], outs[j].data_ptr()]
        slots += [None, 0, 0, None, None, 0, None] * (_MAX_WEIGHTS - len(group))
        with span("fwt.int8_dense"):
            rc = _build.launch(dev, lib.fwt_w8a8_decode, *xa, out_f32, len(group), *slots, _state(dev).data_ptr(),
                               plan.bn, plan.cluster, plan.clusters)
            _build.check(rc, "int8_dense")
            _build.count(int8_dense)
            _build.count(int8_dense, "decode_launches")
    if tiled:
        # x's codes, then their scales 16-byte aligned (csrc/w8a8.cu)
        scratch = torch.empty(-(-m * k // 16) * 16 + 4 * m, dtype=torch.uint8, device=dev)
        for i, j in enumerate(tiled):
            q, ldw, n, s, b, kind = args[j]
            with span("fwt.int8_dense"):
                rc = _build.launch(dev, lib.fwt_w8a8_dense, *xa, q, ldw, n, s, b, kind, outs[j].data_ptr(), out_f32,
                                   scratch.data_ptr(), int(i == 0))
                _build.check(rc, "int8_dense")
                _build.count(int8_dense)
    return outs


def _weight_args(w: QuantizedLinear, b, k: int, dev) -> tuple:
    """(codes, their row stride, N, scales, bias, bias kind) of one weight
    for ``csrc/w8a8.cu`` (pointers as ints, None for no bias), after the
    checks ``_w8a8`` names."""
    q, s = w.q, w.s
    if q.dtype != torch.int8 or s.dtype != torch.float32 or q.dim() != 2:
        raise TypeError(f"int8_dense: codes {q.dtype} {tuple(q.shape)} and scales {s.dtype}, the "
                        "kernel takes (K, N) int8 and (N,) float32")
    n = q.shape[1]
    if s.shape != (n,) or q.shape[0] != k:
        raise ValueError(f"int8_dense: x's width {k}, codes {tuple(q.shape)}, scales {tuple(s.shape)}")
    if n % _N_ALIGN:
        raise ValueError(f"int8_dense: width {n}, the kernel takes a multiple of {_N_ALIGN}")
    one, ldw = q.stride()
    if one != 1 or ldw % 16 or ldw < k or q.data_ptr() % 16:
        raise ValueError("int8_dense: the codes must be K-major and 16-byte aligned "
                         "(ops.quant.card_layout)")
    kind = 0
    if b is not None:
        kind = 1 + _DTYPES.get(b.dtype, -9)
        if kind < 1 or b.shape != (n,) or b.stride(0) != 1 or b.device != dev:
            raise ValueError(f"int8_dense: bias {b.dtype} {tuple(b.shape)} on {b.device}, the kernel "
                             "takes (N,) bfloat16 or float32 on x's device")
    if q.device != dev or s.device != dev or s.stride(0) != 1:
        raise ValueError(f"int8_dense: codes on {q.device} and scales on {s.device} (contiguous), "
                         f"x on {dev}")
    return q.data_ptr(), ldw, n, s.data_ptr(), None if b is None else b.data_ptr(), kind


def int8_dense_rows(xs, ws, bs, group, out_dtype=None) -> list:
    """``int8_dense`` of a row-parallel weight over a model-axis group
    (``parallel/collectives.py``): shard i holds the input columns
    ``xs[i]`` and the weight's input rows ``ws[i]``; each shard gets the
    whole product plus its copy of the replicated bias ``bs[i]``.

    The per-row activation scale is the max over the WHOLE row, so the
    shards' row maxima are all-reduced (max) before quantizing, as XLA
    reduces an ``amax`` over a sharded axis.  Then the shards' int32
    products are summed, exactly, before the float32 rescale: the result
    is bit-equal to ``int8_dense`` on the unsharded weight.  With group
    scales each shard rescales its own groups and the float32 group sums
    are reduced, in another order than one shard's sum over all groups.
    The call is one span ``fwt.int8_dense``."""
    with span("fwt.int8_dense"):
        xfs = [x.float() for x in xs]
        amax = group.all_reduce_max([xf.abs().amax(dim=-1, keepdim=True) for xf in xfs])
        coded = [_quantize_rows(xf, a) for xf, a in zip(xfs, amax)]
        accs = group.all_reduce_sum([_int8_product(xq, w) for (xq, _), w in zip(coded, ws)])
        return group.replicated(
            lambda acc, c, w, b: _rescale(acc, c[1], w, b, out_dtype or xs[0].dtype), accs, coded, ws, bs,
        )


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
