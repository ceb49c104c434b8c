"""The two kernel probes of the decode self-attention: P1 and P2.

Counterparts of the kernels of the JAX package's probe scripts, which ask
what bounds K2 (``ops/beam_attention.py``) and what a decoder-layer
megakernel may do:

* P1, ``attend_only`` (``benchmarks/profile_call_anatomy.py::
  _attend_only_kernel``): K2's attention over the int8 cache with the
  append taken out, one output and no aliasing, on the TPU's s8 path.
  q * D**-0.5 is quantized to s8 per (h, k) row; per slot j an s8 . s8 ->
  s32 dot against the cache codes, times q's and the K row's scales; the
  mask ``anc == j & c <= pos``; one softmax over all (j, c); the weights
  times V's row scales, quantized to s8 per (h, k, j) row (not clipped);
  an s8 . s8 -> s32 PV dot per slot, times the weights' scale, summed over
  the slots.  Beside K2 it shows what the append costs.
* P2, ``scores_batched`` and ``scores_perhead`` (``benchmarks/
  profile_mosaic_micro.py::_batched_kernel``, ``::_perhead_kernel``): the
  int8 QK scores of one layer, summed over the slots and the columns.
  ``scores_batched`` quantizes q (B, H, K, D) per (h, k) row and returns
  (B, H, K); ``scores_perhead`` takes q as flat rows (B, K, H*D), quantizes
  each whole row with one scale over all heads, dots each head's slice and
  returns (B, K).  Side by side they show whether per-head slices of flat
  rows cost more than a head-batched product.  (The JAX script's
  ``call_batched`` declares a (1, K) output block for the body's (H, K)
  result and raises when traced; the port computes what the body does.)

Each wrapper runs its hand-written CUDA kernel of ``csrc/probes.cu`` on
CUDA tensors, counted in ``<wrapper>.launches``, and its plain PyTorch
version (``<wrapper>_plain``) on CPU tensors; a CUDA tensor never reaches
the plain version.  Every integer product is exact: the kernels sum s8
products in s32 (``__dp4a``), the plain versions in float32, where every
partial sum of a 64-wide row (at most 64 * 127 * 127) and of a PV column
(at most 448 * 127 * 127) is an integer below 2**24.  A scale is max|x|
times the float32 reciprocal of 127, as XLA compiles the scripts'
``max|x| / 127.0``, floored at 1e-10; codes round half to even.

``python -m faster_whisper_tpu_torch.ops.probes`` repeats the two scripts'
sweeps on the card at their shapes (B=8, H=20, K=5, ctx=192, D=64, 32
layers, 64 steps) and prints ms per 32-layer step: the anatomy probe's
"full" column is the port's own K2 (``beam_attend_append`` over the int8
cache), which does not use s8 (it follows the JAX package's XLA path),
beside P1; the micro probe's two columns are P2b and P2h.
"""

import argparse
import time

from typing import Dict, Optional, Tuple

import torch

from faster_whisper_tpu_torch.ops import _build
from faster_whisper_tpu_torch.ops.quant import QuantKV

NEG_INF = -1e30
_HEAD_DIM = 64  # csrc/probes.cu: PR_D
_MAX_BEAMS = 8  # csrc/probes.cu: PR_MAXK
_MIN_SCALE = 1e-10

# The scripts' shapes: B, H, K, ctx, D, L and the steps of a sweep.
PROBE_SHAPE = dict(B=8, H=20, K=5, ctx=192, D=64, L=32)
PROBE_STEPS = 64
PROBE_POS = 120


def quantize_rows(x: torch.Tensor, clip: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes int8, scale (..., 1) float32) of float32 ``x`` per row of its
    last axis: scale = max(max|x| * f32(1/127), 1e-10), codes
    round(x / scale), clipped to [-127, 127] with ``clip``."""
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True) * (1.0 / 127), min=_MIN_SCALE)
    codes = torch.round(x / scale)
    if clip:
        codes = torch.clamp(codes, -127, 127)
    return codes.to(torch.int8), scale


# ---------------------------------------------------------------------------
# P1: attention-only over the int8 cache
# ---------------------------------------------------------------------------


def attend_only_plain(layer: int, pos_row, q, self_k: QuantKV, self_v: QuantKV, anc, *, codes=False):
    """The plain PyTorch version of P1.  Returns attn (B, H, K, D) in q's
    dtype; with ``codes`` also q's codes (B, H, K, D) and the weights'
    codes (B, H, K, J, ctx), 0 where masked."""
    b, h, k, d = q.shape
    ctx = self_k.q.shape[4]
    dev = q.device
    q_i8, q_s = quantize_rows(q.float() * d ** -0.5)  # (B, H, K, D), (B, H, K, 1)
    kq, vq = self_k.q[layer].float(), self_v.q[layer].float()  # (B, H, J, ctx, D)
    ks, vs = self_k.s[layer].float(), self_v.s[layer].float()  # (B, H, J, ctx)
    dots = torch.einsum("bhkd,bhjcd->bhkjc", q_i8.float(), kq)  # exact integers
    s = dots * q_s[..., None] * ks[:, :, None]
    sel = anc.long()[:, :, None, :] == torch.arange(k, device=dev)[None, None, :, None]
    allow = torch.arange(ctx, device=dev)[None, :] <= pos_row.long()[:, None]  # (B, ctx)
    mask = sel & allow[:, None, None, :]  # (B, K, J, ctx)
    s = torch.where(mask[:, None], s, NEG_INF)
    m = s.amax(dim=(-2, -1), keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True).sum(dim=-2, keepdim=True)
    p = e / denom * vs[:, :, None]
    p_i8, p_s = quantize_rows(p, clip=False)  # per (h, k, j) row over ctx
    pv = torch.einsum("bhkjc,bhjcd->bhkjd", p_i8.float(), vq)  # exact integers
    attn = torch.zeros((b, h, k, d), dtype=torch.float32, device=dev)
    for j in range(k):
        attn = attn + pv[:, :, :, j] * p_s[:, :, :, j]
    out = attn.to(q.dtype)
    return (out, q_i8, p_i8) if codes else out


def attend_only(layer: int, pos_row, q, self_k: QuantKV, self_v: QuantKV, anc, *, codes=False):
    """P1: attn (B, H, K, D) bfloat16 of one layer, ``layer``, of the int8
    cache (codes (L, B, H, K, ctx, D), bf16 scales (L, B, H, K, ctx)) for
    bf16 queries (B, H, K, D) at per-row positions ``pos_row`` (B,) int32
    under the ancestry ``anc`` (B, K, ctx) int32.  With ``codes`` also q's
    codes and the weights' codes, as ``attend_only_plain`` returns them.

    On a CUDA tensor: the kernel, a cluster of CTAs per (b, h) that split
    its columns (4 of 48 columns at ctx=192), counted in
    ``attend_only.launches``; requires D=64, 1..8 beams and
    0 <= pos_row < ctx.  On a CPU tensor: ``attend_only_plain``."""
    if not q.is_cuda:
        _host_only(q, "attend_only")
        return attend_only_plain(layer, pos_row, q, self_k, self_v, anc, codes=codes)
    b, h, k, d = q.shape
    n_layer, ctx = self_k.q.shape[0], self_k.q.shape[4]
    cache = (n_layer, b, h, k, ctx, d)
    _check("attend_only", q, d, k, layer, n_layer, [
        ("q", q, (b, h, k, d), torch.bfloat16),
        ("self_k.q", self_k.q, cache, torch.int8),
        ("self_k.s", self_k.s, cache[:5], torch.bfloat16),
        ("self_v.q", self_v.q, cache, torch.int8),
        ("self_v.s", self_v.s, cache[:5], torch.bfloat16),
        ("anc", anc, (b, k, ctx), torch.int32),
        ("pos_row", pos_row, (b,), torch.int32),
    ])
    out = torch.empty_like(q)
    q_codes = torch.empty(q.shape, dtype=torch.int8, device=q.device) if codes else None
    p_codes = torch.zeros((b, h, k, k, ctx), dtype=torch.int8, device=q.device) if codes else None
    rc = _build.launch(
        q.device, _build.load("probes.cu").fwt_attend_only_int8, q.data_ptr(), self_k.q.data_ptr(),
        self_k.s.data_ptr(), self_v.q.data_ptr(), self_v.s.data_ptr(), anc.data_ptr(), pos_row.data_ptr(), out.data_ptr(),
        _ptr(q_codes), _ptr(p_codes), b, h, k, ctx, d, int(layer), float(d) ** -0.5,
    )
    _build.check(rc, "attend_only")
    _build.count(attend_only)
    return (out, q_codes, p_codes) if codes else out


attend_only.launches = 0


# ---------------------------------------------------------------------------
# P2: int8 QK scores summed over slots and columns
# ---------------------------------------------------------------------------


def scores_batched_plain(layer: int, q, kq, *, codes=False):
    """The plain version of P2b: (B, H, K) float32, the sum over the slots
    j and the columns c of the s32 dot of q's codes (per (h, k) row, no
    D**-0.5) with ``kq[layer, b, h, j, c]``, each times q's scale; with
    ``codes`` also q's codes (B, H, K, D)."""
    k = q.shape[2]
    q_i8, q_s = quantize_rows(q.float())
    dots = torch.einsum("bhkd,bhjcd->bhkjc", q_i8.float(), kq[layer].float())
    acc = dots[:, :, :, 0] * q_s
    for j in range(1, k):
        acc = acc + dots[:, :, :, j] * q_s
    out = acc.sum(dim=-1)
    return (out, q_i8) if codes else out


def scores_perhead_plain(layer: int, q, kq, *, codes=False):
    """The plain version of P2h: q flat (B, K, H*D) quantized per whole
    row (one scale over all heads); (B, K) float32, the sum over j and the
    heads h of the column sum of head h's slice dotted with
    ``kq[layer, b, h, j]``, times the row's scale; with ``codes`` also q's
    codes (B, K, H*D)."""
    b, k, hd = q.shape
    h = kq.shape[2]
    d = hd // h
    q_i8, q_s = quantize_rows(q.float())  # (B, K, H*D), (B, K, 1)
    dots = torch.einsum("bkhd,bhjcd->bkhjc", q_i8.float().reshape(b, k, h, d), kq[layer].float())
    out = torch.zeros((b, k), dtype=torch.float32, device=q.device)
    for j in range(k):
        for hi in range(h):
            out = out + dots[:, :, hi, j].sum(dim=-1) * q_s[:, :, 0]
    return (out, q_i8) if codes else out


def score_magnitudes(layer: int, q, kq, perhead: bool) -> torch.Tensor:
    """Sum over the terms of P2b (``perhead`` False, (B, H, K)) or P2h
    ((B, K)) of their magnitudes |dot| * scale: the scale of the float32
    sums' rounding."""
    if perhead:
        b, k, hd = q.shape
        h = kq.shape[2]
        q_i8, q_s = quantize_rows(q.float())
        dots = torch.einsum("bkhd,bhjcd->bkhjc", q_i8.float().reshape(b, k, h, -1), kq[layer].float())
        return dots.abs().sum(dim=(2, 3, 4)) * q_s[:, :, 0]
    q_i8, q_s = quantize_rows(q.float())
    dots = torch.einsum("bhkd,bhjcd->bhkjc", q_i8.float(), kq[layer].float())
    return dots.abs().sum(dim=(3, 4)) * q_s[..., 0]


def scores_batched(layer: int, q, kq, *, codes=False):
    """P2b: q (B, H, K, D) bf16 and the int8 cache codes kq (L, B, H, K,
    ctx, D) -> (B, H, K) float32 (see ``scores_batched_plain``).  On a CUDA
    tensor: the kernel, one block per (b, h), counted in
    ``scores_batched.launches``; on a CPU tensor the plain version."""
    if not q.is_cuda:
        _host_only(q, "scores_batched")
        return scores_batched_plain(layer, q, kq, codes=codes)
    b, h, k, d = q.shape
    n_layer, ctx = kq.shape[0], kq.shape[4]
    _check("scores_batched", q, d, k, layer, n_layer, [
        ("q", q, (b, h, k, d), torch.bfloat16),
        ("kq", kq, (n_layer, b, h, k, ctx, d), torch.int8),
    ])
    out = torch.empty((b, h, k), dtype=torch.float32, device=q.device)
    q_codes = torch.empty(q.shape, dtype=torch.int8, device=q.device) if codes else None
    rc = _build.launch(
        q.device, _build.load("probes.cu").fwt_scores_batched_int8, q.data_ptr(), kq.data_ptr(),
        out.data_ptr(), _ptr(q_codes), b, h, k, ctx, d, int(layer),
    )
    _build.check(rc, "scores_batched")
    _build.count(scores_batched)
    return (out, q_codes) if codes else out


scores_batched.launches = 0


def scores_perhead(layer: int, q, kq, *, codes=False):
    """P2h: q flat (B, K, H*D) bf16 and kq (L, B, H, K, ctx, D) int8 ->
    (B, K) float32 (see ``scores_perhead_plain``).  On a CUDA tensor: the
    kernel, one cluster of 8 CTAs per batch row, which share the row's
    scale and meet in exact int64 sums in the cluster's shared memory,
    counted in ``scores_perhead.launches``; it keeps no state between
    calls.  On a CPU tensor the plain version."""
    if not q.is_cuda:
        _host_only(q, "scores_perhead")
        return scores_perhead_plain(layer, q, kq, codes=codes)
    b, k, hd = q.shape
    n_layer, h, ctx, d = kq.shape[0], kq.shape[2], kq.shape[4], kq.shape[5]
    _check("scores_perhead", q, d, k, layer, n_layer, [
        ("q", q, (b, k, h * d), torch.bfloat16),
        ("kq", kq, (n_layer, b, h, k, ctx, d), torch.int8),
    ])
    out = torch.empty((b, k), dtype=torch.float32, device=q.device)
    q_codes = torch.empty(q.shape, dtype=torch.int8, device=q.device) if codes else None
    rc = _build.launch(
        q.device, _build.load("probes.cu").fwt_scores_perhead_int8, q.data_ptr(), kq.data_ptr(),
        out.data_ptr(), _ptr(q_codes), b, h, k, ctx, d, int(layer),
    )
    _build.check(rc, "scores_perhead")
    _build.count(scores_perhead)
    return (out, q_codes) if codes else out


scores_perhead.launches = 0


# ---------------------------------------------------------------------------
# Argument checks
# ---------------------------------------------------------------------------


def _host_only(q, name):
    if q.device.type != "cpu":
        raise ValueError(f"{name}: no path for device {q.device}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(name, q, d, k, layer, n_layer, checks):
    for what, t, shape, dtype in checks:
        if t.device != q.device:
            raise ValueError(f"{name}: {what} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {what} is {t.dtype}, the kernel takes {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} is not contiguous and 16-byte aligned")
    if d != _HEAD_DIM:
        raise ValueError(f"{name}: head dim {d}, the kernel is built for 64")
    if not 1 <= k <= _MAX_BEAMS:
        raise ValueError(f"{name}: {k} beams, the kernel takes 1..{_MAX_BEAMS}")
    if not 0 <= layer < n_layer:
        raise ValueError(f"{name}: layer {layer} outside [0, {n_layer})")


# ---------------------------------------------------------------------------
# The probes' sweeps
# ---------------------------------------------------------------------------


def probe_inputs(B, H, K, ctx, D, L, device, seed=0, pos=PROBE_POS):
    """The scripts' inputs, made on ``device`` from ``seed``: q (B, H, K,
    D) and its flat form (B, K, H*D), the new K/V rows, bf16; an int8 K and
    V cache of L layers with bf16 scales in [0.5, 1.5); the identity
    ancestry; every row at ``pos``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)

    def cache():
        codes = torch.randint(-127, 128, (L, B, H, K, ctx, D), generator=g, device=device,
                              dtype=torch.int8)
        scales = torch.rand((L, B, H, K, ctx), generator=g, device=device) + 0.5
        return QuantKV(codes, scales.to(torch.bfloat16))

    return dict(
        q=randn(B, H, K, D), q_flat=randn(B, K, H * D), k_new=randn(B, H, K, D),
        v_new=randn(B, H, K, D), self_k=cache(), self_v=cache(),
        anc=torch.arange(K, dtype=torch.int32, device=device)[None, :, None].expand(B, K, ctx).contiguous(),
        pos=torch.full((B,), pos, dtype=torch.int32, device=device),
    )


def _step_ms(step, steps: int, reps: int, device) -> Tuple[float, Optional[float]]:
    """(host-issued ms per step, ms per step replayed from a CUDA graph of
    one step, or None on the CPU): the best of ``reps`` sweeps of
    ``steps`` steps, after one step of warm-up."""
    step()
    if device.type != "cuda":
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            best = min(best, time.perf_counter() - t0)
        return best / steps * 1e3, None
    torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            step()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    graph.replay()
    torch.cuda.synchronize(device)
    replayed = float("inf")
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            graph.replay()
        end.record()
        end.synchronize()
        replayed = min(replayed, start.elapsed_time(end))
    return best / steps, replayed / steps


def run_sweeps(device="cuda", steps=PROBE_STEPS, reps=3, seed=0, **shape) -> Dict[str, Tuple]:
    """The two scripts' sweeps: ``steps`` steps of L layers, each layer one
    call of the probe's kernels at the scripts' shapes (``shape``
    overrides them).  Returns {column: (host-issued ms per L-layer step,
    CUDA-graph ms per step or None)} for "full" (K2, the port's
    ``beam_attend_append`` over the int8 cache, appending at pos),
    "attend-only" (P1), "batched H-dot" (P2b) and "per-head dots" (P2h).
    The scripts' running sum of the outputs is left out: eager PyTorch
    hoists no call out of the loop."""
    from faster_whisper_tpu_torch.ops.beam_attention import beam_attend_append

    dims = dict(PROBE_SHAPE, **shape)
    device = torch.device(device)
    x = probe_inputs(**dims, device=device, seed=seed, pos=min(PROBE_POS, dims["ctx"] - 1))
    n_layer = dims["L"]
    sk, sv, kq = x["self_k"], x["self_v"], x["self_k"].q

    def full():
        for layer in range(n_layer):
            beam_attend_append(layer, x["pos"], x["q"], x["k_new"], x["v_new"], sk, sv, x["anc"])

    def attend():
        for layer in range(n_layer):
            attend_only(layer, x["pos"], x["q"], sk, sv, x["anc"])

    def batched():
        for layer in range(n_layer):
            scores_batched(layer, x["q"], kq)

    def perhead():
        for layer in range(n_layer):
            scores_perhead(layer, x["q_flat"], kq)

    with torch.no_grad():
        return {
            name: _step_ms(fn, steps, reps, device)
            for name, fn in (("full", full), ("attend-only", attend),
                             ("batched H-dot", batched), ("per-head dots", perhead))
        }


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m faster_whisper_tpu_torch.ops.probes",
        description="The anatomy and micro probes' sweeps: ms per 32-layer decode step of "
        "K2 against P1 (attend-only), and of P2b (batched H-dot) against P2h (per-head dots).",
    )
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu' (the plain versions)")
    ap.add_argument("--steps", type=int, default=PROBE_STEPS)
    ap.add_argument("--reps", type=int, default=3)
    for key, val in PROBE_SHAPE.items():
        ap.add_argument(f"--{key}", type=int, default=val)
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("the probes time the card: torch.cuda.is_available() is false")
    shape = {key: getattr(args, key) for key in PROBE_SHAPE}
    where = (f"{torch.cuda.get_device_name(torch.device(args.device))}" if args.device != "cpu"
             else "the host CPU (plain versions; no device time)")
    res = run_sweeps(args.device, steps=args.steps, reps=args.reps, **shape)
    print(f"# B={shape['B']} H={shape['H']} K={shape['K']} ctx={shape['ctx']} D={shape['D']} "
          f"L={shape['L']}, {args.steps} steps, pos {min(PROBE_POS, shape['ctx'] - 1)}, on {where}")
    print("# 'full' is the port's K2 (append + attend over the int8 cache without s8 products);"
          " the TPU script's full column was an s8 kernel")
    labels = {
        "full": "full (K2 append+attend, not s8)",
        "attend-only": "attend-only (P1, s8)",
        "batched H-dot": "batched H-dot (P2b)",
        "per-head dots": "per-head dots (P2h)",
    }
    for name, (host, graph) in res.items():
        g = "n/a" if graph is None else f"{graph:8.4f}"
        print(f"{labels[name]:33s}: {host:8.4f} ms/{shape['L']}-layer-step issued from the host, "
              f"{g} ms replayed from a CUDA graph")
    return res


if __name__ == "__main__":
    main()
