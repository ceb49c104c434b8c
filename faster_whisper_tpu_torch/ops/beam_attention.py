"""Beam-grid decode self-attention with in-place KV-cache append.

Counterpart of ``faster_whisper_tpu/ops/beam_attention.py``.  One decode
step of self-attention over the per-beam cache ``(L, B, H, K, ctx, D)``:
the step's K/V are written at column ``pos`` of every beam slot of layer
``layer``, then every query beam k attends over all K slots under the
ancestry mask ``anc[b, k, c] == j AND c <= pos`` with one joint softmax
(position c of the chain now owned by beam k lives in slot
``anc[b, k, c]``, so beam re-parenting permutes ``anc`` and never the
cache).

The cache is either raw (in q's dtype) or int8 (``QuantKV``: codes
(L, B, H, K, ctx, D) int8 and per-row scales (L, B, H, K, ctx), bf16 on
the card).  On the int8 cache the step's K/V are quantized per (beam,
head) row (scale max|x|/127, stored in the scale dtype) before they are
written, and the scales fold into the scores and the PV weights.

``beam_attend_append`` runs the hand-written CUDA kernels K1 (raw cache)
and K2 (int8 cache) of ``csrc/beam_attention.cu``, each with bfloat16 or
float32 activations, on CUDA tensors and their plain version
``beam_attend_append_ref`` on CPU tensors.  The kernel splits the columns
into chunks (``_split_plan``) and merges their softmax partials in the
same launch.

Unlike the JAX functions, both update the cache tensors IN PLACE (the TPU
kernel aliased them too, but JAX returns new arrays); they return the same
tensors so that call sites read like the JAX ones.
"""

import functools
from typing import Optional, Tuple

import torch

from faster_whisper_tpu_torch.ops import _build
from faster_whisper_tpu_torch.ops.cross_attention import _buffer
from faster_whisper_tpu_torch.ops.quant import QuantKV, quantize_kv

NEG_INF = -1e30

_HEAD_DIM = 64  # csrc/beam_attention.cu: K1_D
_MAX_BEAMS = 32  # csrc/beam_attention.cu: K1_MAXK, one bit per beam
_MAX_CHUNK = 64  # csrc/beam_attention.cu: K1_MAX_CHUNK
_CHUNK = 32  # columns per block, chosen by timing K1/K2 on an H100 (PERF.md section 6)
_CHUNK_ALIGN = 8
_ROW_BUDGET = 64 * 1024  # bytes of K and V row slots a block holds in shared memory
_ROW_PAD = 16  # csrc/beam_attention.cu: row_stride, a row and 16 bytes


@functools.lru_cache(maxsize=None)
def _split_plan(k: int, ctx: int, row_bytes: int) -> Tuple[int, int]:
    """(chunk, n_chunks): K1/K2 split the ctx columns into n_chunks chunks
    of ``chunk`` columns: 32, or fewer where the k * chunk K and V row
    slots (``row_bytes`` and 16 bytes of padding each) would not fit in 64
    KB of shared memory (a multiple of 8, never below 8).  The chunk
    depends on the beam count and the row size alone, never on the batch,
    the heads, the card's SM count, ctx or the write position: a larger
    batch or more heads only add blocks, and a row's softmax partials merge
    in the same order whatever the batch bucket, the heads of a
    ``tensor_parallel`` shard, the card or the table's width.  At K=5
    with bf16 or int8 rows: 14 chunks of 32 at ctx=448 (280 blocks at B=1,
    H=20; 2240 at B=8)."""
    if min(k, ctx, row_bytes) < 1:
        raise ValueError(f"beam_attend_append: no work in K={k}, ctx={ctx}")
    slot = row_bytes + _ROW_PAD
    fit = max(_CHUNK_ALIGN, _ROW_BUDGET // (2 * k * slot) // _CHUNK_ALIGN * _CHUNK_ALIGN)
    chunk = min(_CHUNK, _MAX_CHUNK, fit)
    return chunk, -(-ctx // chunk)


def beam_attend_append(
    layer: int,
    pos_row: torch.Tensor,  # (B,) int32, per-row write position
    q: torch.Tensor,  # (B, H, K, D)
    k_new: torch.Tensor,  # (B, H, K, D)
    v_new: torch.Tensor,
    self_k,  # (L, B, H, K, ctx, D) or QuantKV; updated in place
    self_v,
    anc: torch.Tensor,  # (B, K, ctx) int32
    *,
    pos_bk: Optional[torch.Tensor] = None,  # (B, K) per-beam positions
):
    """Returns (attn (B, H, K, D) in q.dtype, self_k, self_v).

    On a CUDA tensor: K1 (raw cache in q's dtype) or K2 (``QuantKV``
    cache, int8 codes and bf16 scales), with bfloat16 or float32 q, k_new
    and v_new, launched on the current stream and counted in
    ``beam_attend_append.launches`` (K1), ``.launches_f32`` (K1, float32),
    ``.launches_int8`` (K2) or ``.launches_int8_f32`` (K2, float32); all
    write every beam at ``pos_row`` and ignore ``pos_bk``, which differs
    from the plain version only in the slots of finished sampling beams,
    whose outputs are never read (as with the TPU kernels).  Requires
    ``0 <= pos_row < ctx``, a head dim of 64 and at most 32 beams.  A call
    allocates only its output: scratch and ticket counters are kept per
    device.  The column chunks (``_split_plan``) do not depend on B, H or
    ctx, so a row's output is the same bits in any batch, as a slice of
    its heads, and in a table of any width (whose merge reads only the
    chunks up to ``pos_row``).  On a CPU tensor:
    ``beam_attend_append_ref``, which honours ``pos_bk``."""
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"beam_attend_append: no path for device {q.device}")
        return beam_attend_append_ref(
            layer, pos_row, q, k_new, v_new, self_k, self_v, anc, pos_bk=pos_bk
        )

    quant = isinstance(self_k, QuantKV)
    b, h, k, d = q.shape
    codes_k = self_k.q if quant else self_k
    if codes_k.dim() != 6:
        raise ValueError(
            f"beam_attend_append: cache must be (L,B,H,K,ctx,D), got {tuple(codes_k.shape)}"
        )
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"beam_attend_append: q is {q.dtype}, the kernel takes bfloat16 or float32")
    n_layer, ctx = codes_k.shape[0], codes_k.shape[4]
    cache_shape = (n_layer, b, h, k, ctx, d)
    bhk = (b, h, k, d)
    checks = [
        ("q", q, bhk, q.dtype),
        ("k_new", k_new, bhk, q.dtype),
        ("v_new", v_new, bhk, q.dtype),
        ("anc", anc, (b, k, ctx), torch.int32),
        ("pos_row", pos_row, (b,), torch.int32),
    ]
    if quant:
        checks += [
            ("self_k.q", self_k.q, cache_shape, torch.int8),
            ("self_k.s", self_k.s, cache_shape[:5], torch.bfloat16),
            ("self_v.q", self_v.q, cache_shape, torch.int8),
            ("self_v.s", self_v.s, cache_shape[:5], torch.bfloat16),
        ]
    else:
        checks += [
            ("self_k", self_k, cache_shape, q.dtype),
            ("self_v", self_v, cache_shape, q.dtype),
        ]
    for name, t, shape, dtype in checks:
        if t.device != q.device:
            raise ValueError(f"beam_attend_append: {name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"beam_attend_append: {name} is {t.dtype}, the kernel takes {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"beam_attend_append: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"beam_attend_append: {name} is not contiguous")
    if d != _HEAD_DIM:
        raise ValueError(f"beam_attend_append: head dim {d}, the kernel is built for 64 (every Whisper size)")
    if not 1 <= k <= _MAX_BEAMS:
        raise ValueError(f"beam_attend_append: {k} beams, the kernel takes 1..{_MAX_BEAMS}")
    if not 0 <= layer < n_layer:
        raise ValueError(f"beam_attend_append: layer {layer} outside [0, {n_layer})")
    if any(t.data_ptr() % 16 for t in (q, k_new, v_new, codes_k, self_v.q if quant else self_v)):
        raise ValueError("beam_attend_append: q, k_new, v_new and the caches must be 16-byte aligned")

    row_bytes = d * (1 if quant else q.element_size())
    chunk, _ = _split_plan(k, ctx, row_bytes)
    out = _launch(layer, pos_row, q, k_new, v_new, self_k, self_v, anc, chunk)
    counter = ("launches_int8" if quant else "launches") + ("_f32" if q.dtype == torch.float32 else "")
    _build.count(beam_attend_append, counter)
    return out, self_k, self_v


def _launch(layer, pos_row, q, k_new, v_new, self_k, self_v, anc, chunk: int) -> torch.Tensor:
    """K1/K2 over checked arguments with ``chunk`` columns per block;
    returns the output.  ``beam_attend_append`` passes its plan's chunk."""
    quant = isinstance(self_k, QuantKV)
    b, h, k, d = q.shape
    ctx = (self_k.q if quant else self_k).shape[4]
    n_chunks = -(-ctx // chunk)
    # Scratch for the chunks' partials: (B*H, n_chunks, K, D) sums, then
    # (B*H, n_chunks, K, 2) max and denominator, addressed by pointer.
    n_part = b * h * n_chunks * k
    part_o = _buffer(q.device, "beam_attend scratch", n_part * (d + 2), torch.float32).data_ptr()
    part_ml = part_o + 4 * n_part * d
    tickets = _buffer(q.device, "beam_attend tickets", b * h, torch.int32)
    lib = _build.load("beam_attention.cu")
    out = torch.empty_like(q)
    f32 = q.dtype == torch.float32
    tail = (
        anc.data_ptr(), pos_row.data_ptr(), out.data_ptr(), part_o, part_ml, tickets.data_ptr(),
        b, h, k, ctx, d, int(layer), chunk, float(d) ** -0.5,
    )
    if quant:
        fn = lib.fwt_beam_attend_append_int8_f32 if f32 else lib.fwt_beam_attend_append_int8
        rc = _build.launch(
            q.device, fn, q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            self_k.q.data_ptr(), self_k.s.data_ptr(),
            self_v.q.data_ptr(), self_v.s.data_ptr(), *tail,
        )
    else:
        fn = lib.fwt_beam_attend_append_f32 if f32 else lib.fwt_beam_attend_append_bf16
        rc = _build.launch(
            q.device, fn, q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            self_k.data_ptr(), self_v.data_ptr(), *tail,
        )
    _build.check(rc, "beam_attend_append")
    return out


beam_attend_append.launches = 0  # K1, bfloat16
beam_attend_append.launches_f32 = 0  # K1, float32
beam_attend_append.launches_int8 = 0  # K2, bfloat16 activations
beam_attend_append.launches_int8_f32 = 0  # K2, float32 activations


def beam_attend_append_ref(
    layer: int,
    pos_row: torch.Tensor,  # (B,)
    q: torch.Tensor,  # (B, H, K, D)
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    self_k,  # (L, B, H, K, ctx, D) or QuantKV; updated in place
    self_v,
    anc: torch.Tensor,  # (B, K, ctx)
    *,
    pos_bk: Optional[torch.Tensor] = None,  # (B, K) per-beam positions
):
    """The plain PyTorch version of K1 and K2 (``beam_attend_append_xla``).

    ``pos_bk`` optionally carries per-(row, beam) positions: the sampling
    path freezes finished beams at their own positions.  On an int8 cache
    the new column is quantized, written with its scale rounded to the
    scale dtype, and read back like every other column."""
    quant = isinstance(self_k, QuantKV)
    b, h, k, d = q.shape
    ctx = (self_k.q if quant else self_k).shape[4]
    dtype = q.dtype
    dev = q.device
    if pos_bk is None:
        pos_bk = pos_row[:, None].expand(b, k)
    pos_bk = pos_bk.long()

    b_idx = torch.arange(b, device=dev)[:, None].expand(b, k)
    k_idx = torch.arange(k, device=dev)[None, :].expand(b, k)
    # index dims (B, K) come first, then the sliced H (and the trailing D)
    kn_bk, vn_bk = k_new.transpose(1, 2), v_new.transpose(1, 2)  # (B, K, H, D)
    if quant:
        for cache, new in ((self_k, kn_bk), (self_v, vn_bk)):
            qn = quantize_kv(new)  # q (B, K, H, D), s (B, K, H)
            cache.q[layer][b_idx, :, k_idx, pos_bk] = qn.q
            cache.s[layer][b_idx, :, k_idx, pos_bk] = qn.s.to(cache.s.dtype)
        sk, sv = self_k.q[layer], self_v.q[layer]  # (B, H, K, ctx, D) views
        sks, svs = self_k.s[layer].float(), self_v.s[layer].float()  # (B, H, K, ctx)
    else:
        sk, sv = self_k[layer], self_v[layer]
        sk[b_idx, :, k_idx, pos_bk] = kn_bk.to(sk.dtype)
        sv[b_idx, :, k_idx, pos_bk] = vn_bk.to(sv.dtype)

    qs = (q.float() * d ** -0.5).to(dtype)
    scores = torch.einsum("bhkd,bhjcd->bhkjc", qs.float(), sk.to(dtype).float())
    if quant:
        scores = scores * sks[:, :, None]
    allow = torch.arange(ctx, device=dev)[None, None, :] <= pos_bk[:, :, None]
    sel = anc[:, :, None, :] == torch.arange(k, device=dev)[None, None, :, None]
    mask = sel & allow[:, :, None, :]  # (B, Kq, J, ctx)
    scores = torch.where(mask[:, None], scores, NEG_INF)

    w = torch.softmax(scores.reshape(b, h, k, k * ctx), dim=-1)
    w = w.reshape(b, h, k, k, ctx)
    if quant:
        w = w * svs[:, :, None]
    attn = torch.einsum("bhkjc,bhjcd->bhkd", w.to(dtype).float(), sv.to(dtype).float())
    return attn.to(dtype), self_k, self_v
