"""Beam-grid decode self-attention with in-place KV-cache append.

Counterpart of ``faster_whisper_tpu/ops/beam_attention.py``.  One decode
step of self-attention over the per-beam cache ``(L, B, H, K, ctx, D)``:
the step's K/V are written at column ``pos`` of every beam slot of layer
``layer``, then every query beam k attends over all K slots under the
ancestry mask ``anc[b, k, c] == j AND c <= pos`` with one joint softmax
(position c of the chain now owned by beam k lives in slot
``anc[b, k, c]``, so beam re-parenting permutes ``anc`` and never the
cache).

``beam_attend_append`` runs the hand-written CUDA kernel K1
(``csrc/beam_attention.cu``) on CUDA tensors and its plain version
``beam_attend_append_ref`` on CPU tensors.

Unlike the JAX functions, both update the cache tensors IN PLACE (the TPU
kernel aliased them too, but JAX returns new arrays); they return the same
tensors so that call sites read like the JAX ones.
"""

from typing import Optional

import torch

from faster_whisper_tpu_torch.ops import _build

NEG_INF = -1e30


def beam_attend_append(
    layer: int,
    pos_row: torch.Tensor,  # (B,) int32, per-row write position
    q: torch.Tensor,  # (B, H, K, D)
    k_new: torch.Tensor,  # (B, H, K, D)
    v_new: torch.Tensor,
    self_k: torch.Tensor,  # (L, B, H, K, ctx, D), updated in place
    self_v: torch.Tensor,
    anc: torch.Tensor,  # (B, K, ctx) int32
    *,
    pos_bk: Optional[torch.Tensor] = None,  # (B, K) per-beam positions
):
    """Returns (attn (B, H, K, D) in q.dtype, self_k, self_v).

    On a CUDA tensor: K1, launched on the current stream and counted in
    ``beam_attend_append.launches``; it writes every beam at ``pos_row``
    and ignores ``pos_bk``, which differs from the plain version only in
    the slots of finished sampling beams, whose outputs are never read (as
    with the TPU kernel).  Requires ``0 <= pos_row < ctx``.  On a CPU
    tensor: ``beam_attend_append_ref``, which honours ``pos_bk``."""
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"beam_attend_append: no path for device {q.device}")
        return beam_attend_append_ref(
            layer, pos_row, q, k_new, v_new, self_k, self_v, anc, pos_bk=pos_bk
        )

    b, h, k, d = q.shape
    if self_k.dim() != 6:
        raise ValueError(f"beam_attend_append: cache must be (L,B,H,K,ctx,D), got {tuple(self_k.shape)}")
    n_layer, ctx = self_k.shape[0], self_k.shape[4]
    for name, t, shape, dtype in (
        ("q", q, (b, h, k, d), torch.bfloat16),
        ("k_new", k_new, (b, h, k, d), torch.bfloat16),
        ("v_new", v_new, (b, h, k, d), torch.bfloat16),
        ("self_k", self_k, (n_layer, b, h, k, ctx, d), torch.bfloat16),
        ("self_v", self_v, (n_layer, b, h, k, ctx, d), torch.bfloat16),
        ("anc", anc, (b, k, ctx), torch.int32),
        ("pos_row", pos_row, (b,), torch.int32),
    ):
        if t.device != q.device:
            raise ValueError(f"beam_attend_append: {name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"beam_attend_append: {name} is {t.dtype}, the kernel takes {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"beam_attend_append: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"beam_attend_append: {name} is not contiguous")
    if d % 8 or d > 256:
        raise ValueError(f"beam_attend_append: head dim {d} must be a multiple of 8, at most 256")
    if not 0 <= layer < n_layer:
        raise ValueError(f"beam_attend_append: layer {layer} outside [0, {n_layer})")

    lib = _build.load("beam_attention.cu")
    out = torch.empty_like(q)
    rc = lib.fwt_beam_attend_append_bf16(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        self_k.data_ptr(), self_v.data_ptr(), anc.data_ptr(),
        pos_row.data_ptr(), out.data_ptr(),
        b, h, k, ctx, d, int(layer), float(d) ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, "beam_attend_append")
    beam_attend_append.launches += 1
    return out, self_k, self_v


beam_attend_append.launches = 0


def beam_attend_append_ref(
    layer: int,
    pos_row: torch.Tensor,  # (B,)
    q: torch.Tensor,  # (B, H, K, D)
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    self_k: torch.Tensor,  # (L, B, H, K, ctx, D), updated in place
    self_v: torch.Tensor,
    anc: torch.Tensor,  # (B, K, ctx)
    *,
    pos_bk: Optional[torch.Tensor] = None,  # (B, K) per-beam positions
):
    """The plain PyTorch version of K1 (``beam_attend_append_xla``).

    ``pos_bk`` optionally carries per-(row, beam) positions: the sampling
    path freezes finished beams at their own positions."""
    b, h, k, d = q.shape
    ctx = self_k.shape[4]
    dtype = q.dtype
    dev = q.device
    if pos_bk is None:
        pos_bk = pos_row[:, None].expand(b, k)
    pos_bk = pos_bk.long()

    b_idx = torch.arange(b, device=dev)[:, None].expand(b, k)
    k_idx = torch.arange(k, device=dev)[None, :].expand(b, k)
    sk, sv = self_k[layer], self_v[layer]  # (B, H, K, ctx, D) views
    # index dims (B, K) come first, then the sliced H and the trailing D
    sk[b_idx, :, k_idx, pos_bk] = k_new.transpose(1, 2).to(sk.dtype)
    sv[b_idx, :, k_idx, pos_bk] = v_new.transpose(1, 2).to(sv.dtype)

    qs = (q.float() * d ** -0.5).to(dtype)
    scores = torch.einsum("bhkd,bhjcd->bhkjc", qs.float(), sk.float())
    allow = torch.arange(ctx, device=dev)[None, None, :] <= pos_bk[:, :, None]
    sel = anc[:, :, None, :] == torch.arange(k, device=dev)[None, None, :, None]
    mask = sel & allow[:, :, None, :]  # (B, Kq, J, ctx)
    scores = torch.where(mask[:, None], scores, NEG_INF)

    w = torch.softmax(scores.reshape(b, h, k, k * ctx), dim=-1)
    w = w.reshape(b, h, k, k, ctx)
    attn = torch.einsum("bhkjc,bhjcd->bhkd", w.to(dtype).float(), sv.float())
    return attn.to(dtype), self_k, self_v
