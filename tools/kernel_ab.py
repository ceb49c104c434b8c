#!/usr/bin/env python3
"""A/B of two versions of the port's attention kernels on one card.

    python3 tools/kernel_ab.py A_DIR B_DIR

A_DIR and B_DIR each hold a ``beam_attention.cu`` (K1/K2), a
``cross_attention.cu`` (K4) and a ``flash_attention.cu`` (K3), for example
an unpacked parent commit's ``faster_whisper_tpu_torch/csrc`` and the
working tree's.  Both are built with the package's nvcc flags into
``build/ab/``; each case then runs with A's and B's libraries in turn (A,
B, B, A), at the main path's shapes, through the package's wrappers.  A
``cross_attention.cu`` without ``fwt_cross_attend_f32`` is the earlier K4
with one block per (b, h) and no split over T, whose C functions take no
scratch: it is called directly through that interface.  Prints each
case's device time (a CUDA graph of 50 calls, L2 warm), its time with L2
cold, and its time per call issued from the host, in ms, on the card named
by nvidia-smi.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from faster_whisper_tpu_torch.ops import _build  # noqa: E402
from faster_whisper_tpu_torch.ops.quant import QuantKV  # noqa: E402

SOURCES = ("beam_attention.cu", "cross_attention.cu", "flash_attention.cu")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The C interface of K4 before its split over T.
UNSPLIT_K4 = {
    "fwt_cross_attend_bf16": [_P] * 4 + [_I] * 6 + [_F, _P],
    "fwt_cross_attend_int8": [_P] * 6 + [_I] * 6 + [_F, _P],
}


def build(src_dir, tag):
    out_dir = os.path.join(ROOT, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    libs = {}
    for src in SOURCES:
        out = os.path.join(out_dir, f"lib_{tag}_{src[:-3]}.so")
        subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, os.path.join(src_dir, src)],
            check=True, capture_output=True,
        )
        lib = ctypes.CDLL(out)
        sigs = _build.SIGNATURES[src]
        if src == "cross_attention.cu" and not hasattr(lib, "fwt_cross_attend_f32"):
            sigs = UNSPLIT_K4
        for name, argtypes in sigs.items():
            if hasattr(lib, name):  # an earlier source may lack the float32 forms
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        libs[src] = lib
    return libs


def unsplit_cross_attend(lib, layer, q, ck, cv):
    """K4 through the interface before the split over T."""
    b, h, k, d = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    if isinstance(ck, QuantKV):
        t = ck.q.shape[3]
        rc = lib.fwt_cross_attend_int8(
            q.data_ptr(), ck.q.data_ptr(), ck.s.data_ptr(), cv.q.data_ptr(), cv.s.data_ptr(),
            out.data_ptr(), b, h, k, t, d, layer, d ** -0.5, stream,
        )
    else:
        t = ck.shape[3]
        rc = lib.fwt_cross_attend_bf16(
            q.data_ptr(), ck.data_ptr(), cv.data_ptr(), out.data_ptr(),
            b, h, k, t, d, layer, d ** -0.5, stream,
        )
    _build.check(rc, "cross_attend (unsplit)")
    return out


def main(a_dir, b_dir):
    cs.require_card()
    print(cs.card_line())
    libs = {"A": build(a_dir, "A"), "B": build(b_dir, "B")}

    from faster_whisper_tpu_torch.ops.attention import mha_flash
    from faster_whisper_tpu_torch.ops.beam_attention import beam_attend_append
    from faster_whisper_tpu_torch.ops.cross_attention import cross_attend

    def k4(args):
        lib = _build._libs["cross_attention.cu"]
        if hasattr(lib, "fwt_cross_attend_f32"):
            return cross_attend(*args)
        return unsplit_cross_attend(lib, *args)

    x1 = cs.k1_inputs(1, 447, divergent=True)
    x2 = cs.k2_inputs(1, 447, divergent=True)
    x5 = cs.k1_inputs(5, 223, divergent=True)
    k4b, k4i = cs.k4_inputs(1, False), cs.k4_inputs(1, True)
    k4b8, k4i8 = cs.k4_inputs(8, False), cs.k4_inputs(8, True)
    k3b1, k3b8 = cs.k3_inputs(1), cs.k3_inputs(8)
    cases = {
        "K1 B=1 pos=447": lambda: cs._k1_call(beam_attend_append, x1, (x1["self_k"], x1["self_v"])),
        "K2 B=1 pos=447": lambda: cs._k1_call(beam_attend_append, x2, (x2["self_k"], x2["self_v"])),
        "K1 B=5 pos=223": lambda: cs._k1_call(beam_attend_append, x5, (x5["self_k"], x5["self_v"])),
        "K3 (1,1500,20,64)": lambda: mha_flash(*k3b1),
        "K3 (8,1500,20,64)": lambda: mha_flash(*k3b8),
        "K4 bf16 B=1": lambda: k4(k4b),
        "K4 int8 B=1": lambda: k4(k4i),
        "K4 bf16 B=8": lambda: k4(k4b8),
        "K4 int8 B=8": lambda: k4(k4i8),
    }
    res = {}
    for tag in ("A", "B", "B", "A"):
        _build._libs.update(libs[tag])
        for name, fn in cases.items():
            res.setdefault(name, []).append(
                (tag, cs.time_ms(fn, iters=50), cs.cold_ms(fn), cs.call_ms(fn, iters=50))
            )
    for name, r in res.items():
        print(name, "device", " ".join(f"{t}={ms:.4f}" for t, ms, _, _ in r),
              "| L2 cold", " ".join(f"{t}={ms:.4f}" for t, _, ms, _ in r),
              "| per host call", " ".join(f"{t}={ms:.4f}" for t, _, _, ms in r))


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    main(os.path.abspath(sys.argv[1]), os.path.abspath(sys.argv[2]))
