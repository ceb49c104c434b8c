"""Decode-step cross-attention over the shared encoder K/V.

Counterpart of ``faster_whisper_tpu/ops/beam_attention.py::cross_attend``:
K beam queries (B, H, K, D) of one decoder layer attend over that layer's
encoder K/V, stacked for all layers as (L, B, H, T, D).  The cache is raw
(q's dtype) or int8 (``QuantKV``: codes (L, B, H, T, D) and scales
(L, B, H, 1, T), bf16 on the card), whose scales fold into the scores (K)
and the softmax weights (V).

``cross_attend`` runs the hand-written CUDA kernel K4
(``csrc/cross_attention.cu``: its raw form for K4a, its int8 form for the
function of K4b and K4c, each with bfloat16 or float32 activations) on
CUDA tensors, and the plain version ``cross_attend_ref`` on CPU tensors.
The plain version computes what the JAX decode step computes without its
fused kernel.  The kernel splits T into chunks (``_split_plan``) and
merges their softmax partials in the same launch.
"""

import functools
from typing import Dict, List, Tuple

import torch

from faster_whisper_tpu_torch.ops import _build
from faster_whisper_tpu_torch.ops.quant import QuantKV

_MAX_BEAMS = 16  # csrc/cross_attention.cu: K4_MAXK
_MAX_CHUNK = 128  # csrc/cross_attention.cu: K4_MAX_CHUNK, one column per thread
_CHUNK_ALIGN = 16
_BLOCKS_PER_SM = 3

# Per device and use: buffers that a kernel keeps between calls, such as
# its (B*H,) ticket counters, zero between calls (the last block of each
# (b, h) sets its counter back to 0; one stream at a time may run a kernel
# on a device).  A buffer outgrown by a larger call stays allocated, since a
# captured CUDA graph may still address it.  And per device, the SM count.
_buffers: Dict[Tuple[torch.device, str], List[torch.Tensor]] = {}
_n_sm: Dict[torch.device, int] = {}


@functools.lru_cache(maxsize=None)
def _split_plan(b: int, h: int, t: int, n_sm: int = 132) -> Tuple[int, int]:
    """(chunk, n_chunks): K4 splits T into n_chunks chunks of ``chunk``
    columns (the last one ragged, none empty), aiming the grid of
    n_chunks * b * h blocks at three blocks per SM; a chunk is a multiple of
    16 columns (rounded up, which may leave fewer blocks) and at most 128.
    At B=1, H=20, T=1500: 19 chunks of 80, 380 blocks."""
    if min(b, h, t) < 1:
        raise ValueError(f"cross_attend: no work in B={b}, H={h}, T={t}")
    want = -(-_BLOCKS_PER_SM * n_sm // (b * h))  # chunks per (b, h)
    chunk = -(-t // want)
    chunk = min(_MAX_CHUNK, -(-chunk // _CHUNK_ALIGN) * _CHUNK_ALIGN)
    return chunk, -(-t // chunk)


def _buffer(device: torch.device, use: str, n: int, dtype: torch.dtype) -> torch.Tensor:
    """The zero-initialised buffer of at least ``n`` elements kept for
    ``use`` on ``device``."""
    bufs = _buffers.setdefault((device, use), [])
    buf = bufs[-1] if bufs else None
    if buf is None or buf.numel() < n:
        # returned from this frame, not re-read from the list: another
        # thread may append a smaller buffer in between
        buf = torch.zeros(max(n, 256), dtype=dtype, device=device)
        bufs.append(buf)
    return buf


def _sm_count(device: torch.device) -> int:
    if device not in _n_sm:
        _n_sm[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _n_sm[device]


def cross_attend(layer: int, q: torch.Tensor, cross_k, cross_v) -> torch.Tensor:
    """Returns attn (B, H, K, D) in q.dtype for layer ``layer``.

    On a CUDA tensor: K4, launched on the current stream and counted in
    ``cross_attend.launches`` (bf16), ``.launches_f32`` (float32),
    ``.launches_int8`` (int8 cache, bf16 queries) or ``.launches_int8_f32``
    (int8 cache, float32 queries): one count per call.  It takes bfloat16
    or float32 queries, a raw cache of the same dtype or an int8 cache with
    bf16 scales, at most 16 beams and a head dim of 64.  On a CPU tensor:
    ``cross_attend_ref``."""
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"cross_attend: no path for device {q.device}")
        return cross_attend_ref(layer, q, cross_k, cross_v)

    quant = isinstance(cross_k, QuantKV)
    b, h, k, d = q.shape
    codes = cross_k.q if quant else cross_k
    if codes.dim() != 5:
        raise ValueError(f"cross_attend: cache must be (L,B,H,T,D), got {tuple(codes.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"cross_attend: q is {q.dtype}, the kernel takes bfloat16 or float32")
    n_layer, t = codes.shape[0], codes.shape[3]
    cache_shape = (n_layer, b, h, t, d)
    checks = [("q", q, (b, h, k, d), q.dtype)]
    if quant:
        checks += [
            ("cross_k.q", cross_k.q, cache_shape, torch.int8),
            ("cross_k.s", cross_k.s, (n_layer, b, h, 1, t), torch.bfloat16),
            ("cross_v.q", cross_v.q, cache_shape, torch.int8),
            ("cross_v.s", cross_v.s, (n_layer, b, h, 1, t), torch.bfloat16),
        ]
    else:
        checks += [
            ("cross_k", cross_k, cache_shape, q.dtype),
            ("cross_v", cross_v, cache_shape, q.dtype),
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
    if codes.data_ptr() % 16 or (cross_v.q if quant else cross_v).data_ptr() % 16:
        raise ValueError("cross_attend: the caches must be 16-byte aligned (16-byte copies)")

    chunk, n_chunks = _split_plan(b, h, t, _sm_count(q.device))
    # Scratch for the chunks' partials: (B*H, n_chunks, K, D) sums, then
    # (B*H, n_chunks, K, 2) max and denominator (addressed by pointer: a
    # view per part would cost the host more than the kernel's launch).
    n_part = b * h * n_chunks * k
    scratch = torch.empty(n_part * (d + 2), dtype=torch.float32, device=q.device)
    part_o = scratch.data_ptr()
    part_ml = part_o + 4 * n_part * d
    tickets = _buffer(q.device, "cross_attend tickets", b * h, torch.int32)
    lib = _build.load("cross_attention.cu")
    out = torch.empty_like(q)
    f32 = q.dtype == torch.float32
    tail = (
        out.data_ptr(), part_o, part_ml, tickets.data_ptr(),
        b, h, k, t, d, int(layer), chunk, float(d) ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if quant:
        fn = lib.fwt_cross_attend_int8_f32 if f32 else lib.fwt_cross_attend_int8
        rc = fn(
            q.data_ptr(), cross_k.q.data_ptr(), cross_k.s.data_ptr(),
            cross_v.q.data_ptr(), cross_v.s.data_ptr(), *tail,
        )
    else:
        fn = lib.fwt_cross_attend_f32 if f32 else lib.fwt_cross_attend_bf16
        rc = fn(q.data_ptr(), cross_k.data_ptr(), cross_v.data_ptr(), *tail)
    _build.check(rc, "cross_attend")
    counter = ("launches_int8" if quant else "launches") + ("_f32" if f32 else "")
    setattr(cross_attend, counter, getattr(cross_attend, counter) + 1)
    return out


cross_attend.launches = 0  # K4, raw bf16 cache (K4a)
cross_attend.launches_f32 = 0  # K4, raw float32 cache
cross_attend.launches_int8 = 0  # K4, int8 cache, bf16 queries (K4b/K4c)
cross_attend.launches_int8_f32 = 0  # K4, int8 cache, float32 queries


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
