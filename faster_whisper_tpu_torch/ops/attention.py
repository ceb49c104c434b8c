"""Multi-head attention.

Counterpart of ``faster_whisper_tpu/ops/attention.py``.  ``mha`` and
``mha_hmajor`` are plain PyTorch (scores and softmax in f32, the weights
rounded to the value dtype before PV), as the JAX package left them to XLA.
``mha_full``, the encoder self-attention, runs the hand-written CUDA flash
kernel K3 (``csrc/flash_attention.cu``: TMA and wgmma in bfloat16, a plain
FMA form in float32) on a CUDA tensor and its plain version ``mha`` on a
CPU tensor.
"""

from typing import Optional

import torch

from faster_whisper_tpu_torch.ops import _build

NEG_INF = -1e30


def mha(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, H, D)
    v: torch.Tensor,  # (B, T, H, D)
    mask: Optional[torch.Tensor] = None,  # broadcastable to (B, H, S, T), bool
) -> torch.Tensor:
    """Scaled dot-product attention; ``mask`` is True where allowed."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", weights.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def mha_hmajor(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, H, T, D) head-major (decoder KV-cache layout)
    v: torch.Tensor,  # (B, H, T, D)
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``mha`` over a head-major K/V cache."""
    return mha(q, k.transpose(1, 2), v.transpose(1, 2), mask=mask)


def mha_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K3 on the card: unmasked self-attention over (B, S, H, 64), bfloat16
    or float32.

    Launches ``csrc/flash_attention.cu`` on the current stream and counts
    the launch in ``mha_flash.launches`` (bf16) or ``.launches_f32``.
    Raises on what the kernel does not take; never falls back to the plain
    version."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"mha_flash: {name} is not on a CUDA device")
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != q.dtype:
            raise TypeError(
                f"mha_flash: {name} is {t.dtype}, the kernel takes bfloat16 or float32 "
                f"(one dtype for q, k and v)"
            )
        if not t.is_contiguous():
            raise ValueError(f"mha_flash: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"mha_flash: {name} is not 16-byte aligned")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape or q.shape[3] != 64:
        raise ValueError(
            f"mha_flash: needs q, k, v of one shape (B, S, H, 64), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    lib = _build.load("flash_attention.cu")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, float(d) ** -0.5)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.float32:
        _build.check(lib.fwt_mha_flash_f32(*args, stream), "mha_flash (float32)")
        mha_flash.launches_f32 += 1
    else:
        _build.check(lib.fwt_mha_flash_bf16(*args, stream), "mha_flash")
        mha_flash.launches += 1
    return out


mha_flash.launches = 0  # bfloat16
mha_flash.launches_f32 = 0


def mha_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unmasked full MHA (encoder self-attention), (B, S, H, D) layout:
    the K3 kernel for a CUDA tensor, the plain ``mha`` for a CPU tensor."""
    if q.is_cuda:
        return mha_flash(q, k, v)
    if q.device.type != "cpu":
        raise ValueError(f"mha_full: no path for device {q.device}")
    return mha(q, k, v)
