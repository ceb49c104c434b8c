"""Decode-step cross-attention over the shared encoder K/V.

Counterpart of ``faster_whisper_tpu/ops/beam_attention.py::cross_attend``:
K beam queries (B, H, K, D) of one decoder layer attend over that layer's
encoder K/V, stacked for all layers as (L, B, H, T, D).  The cache is raw
(bf16 on the card) or int8 (``QuantKV``: codes (L, B, H, T, D) and scales
(L, B, H, 1, T), bf16 on the card), whose scales fold into the scores (K)
and the softmax weights (V).

``cross_attend`` runs the hand-written CUDA kernel K4
(``csrc/cross_attention.cu``: its bf16 form for K4a, its int8 form for the
function of K4b and K4c) on CUDA tensors, and the plain version
``cross_attend_ref`` on CPU tensors.  The plain version computes what the
JAX decode step computes without its fused kernel.
"""

import torch

from faster_whisper_tpu_torch.ops import _build
from faster_whisper_tpu_torch.ops.quant import QuantKV

_MAX_BEAMS = 16  # csrc/cross_attention.cu: K4_MAXK


def cross_attend(layer: int, q: torch.Tensor, cross_k, cross_v) -> torch.Tensor:
    """Returns attn (B, H, K, D) in q.dtype for layer ``layer``.

    On a CUDA tensor: K4, launched on the current stream and counted in
    ``cross_attend.launches`` (bf16 cache) or ``.launches_int8`` (int8
    cache).  It takes bf16 queries, at most 16 beams and a head dim of 64.
    On a CPU tensor: ``cross_attend_ref``."""
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"cross_attend: no path for device {q.device}")
        return cross_attend_ref(layer, q, cross_k, cross_v)

    quant = isinstance(cross_k, QuantKV)
    b, h, k, d = q.shape
    codes = cross_k.q if quant else cross_k
    if codes.dim() != 5:
        raise ValueError(f"cross_attend: cache must be (L,B,H,T,D), got {tuple(codes.shape)}")
    n_layer, t = codes.shape[0], codes.shape[3]
    cache_shape = (n_layer, b, h, t, d)
    checks = [("q", q, (b, h, k, d), torch.bfloat16)]
    if quant:
        checks += [
            ("cross_k.q", cross_k.q, cache_shape, torch.int8),
            ("cross_k.s", cross_k.s, (n_layer, b, h, 1, t), torch.bfloat16),
            ("cross_v.q", cross_v.q, cache_shape, torch.int8),
            ("cross_v.s", cross_v.s, (n_layer, b, h, 1, t), torch.bfloat16),
        ]
    else:
        checks += [
            ("cross_k", cross_k, cache_shape, torch.bfloat16),
            ("cross_v", cross_v, cache_shape, torch.bfloat16),
        ]
    for name, x, shape, dtype in checks:
        if x.device != q.device:
            raise ValueError(f"cross_attend: {name} is on {x.device}, q on {q.device}")
        if x.dtype != dtype:
            raise TypeError(f"cross_attend: {name} is {x.dtype}, the kernel takes {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"cross_attend: {name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"cross_attend: {name} is not contiguous")
    if d != 64:
        raise ValueError(f"cross_attend: head dim {d}, the kernel is built for 64 (every Whisper size)")
    if not 1 <= k <= _MAX_BEAMS:
        raise ValueError(f"cross_attend: {k} beams, the kernel takes 1..{_MAX_BEAMS}")
    if not 0 <= layer < n_layer:
        raise ValueError(f"cross_attend: layer {layer} outside [0, {n_layer})")

    lib = _build.load("cross_attention.cu")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if quant:
        rc = lib.fwt_cross_attend_int8(
            q.data_ptr(), cross_k.q.data_ptr(), cross_k.s.data_ptr(),
            cross_v.q.data_ptr(), cross_v.s.data_ptr(), out.data_ptr(),
            b, h, k, t, d, int(layer), float(d) ** -0.5, stream,
        )
        _build.check(rc, "cross_attend (int8)")
        cross_attend.launches_int8 += 1
    else:
        rc = lib.fwt_cross_attend_bf16(
            q.data_ptr(), cross_k.data_ptr(), cross_v.data_ptr(), out.data_ptr(),
            b, h, k, t, d, int(layer), float(d) ** -0.5, stream,
        )
        _build.check(rc, "cross_attend")
        cross_attend.launches += 1
    return out


cross_attend.launches = 0  # K4, bf16 form (K4a)
cross_attend.launches_int8 = 0  # K4, int8 form (K4b/K4c)


def cross_attend_ref(layer: int, q: torch.Tensor, cross_k, cross_v) -> torch.Tensor:
    """The plain PyTorch version of K4: scores in f32 times d**-0.5 (times
    the K scales), softmax, (times the V scales,) weights cast to q.dtype,
    then PV."""
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    if isinstance(cross_k, QuantKV):
        ck, cv = cross_k.q[layer].to(dtype), cross_v.q[layer].to(dtype)
        ks, vs = cross_k.s[layer].float(), cross_v.s[layer].float()  # (B, H, 1, T)
    else:
        ck, cv = cross_k[layer], cross_v[layer]
        ks = vs = None
    scores = torch.einsum("bhkd,bhtd->bhkt", q.float(), ck.float()) * scale
    if ks is not None:
        scores = scores * ks
    w = torch.softmax(scores, dim=-1)
    if vs is not None:
        w = w * vs
    return torch.einsum("bhkt,bhtd->bhkd", w.to(dtype).float(), cv.float()).to(dtype)
