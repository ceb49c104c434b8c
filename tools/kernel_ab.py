#!/usr/bin/env python3
"""A/B of two versions of the port's attention kernels on one card.

    python3 tools/kernel_ab.py A_DIR B_DIR

A_DIR and B_DIR each hold a ``beam_attention.cu`` (K1/K2), a
``cross_attention.cu`` (K4) and a ``flash_attention.cu`` (K3), for example
an unpacked parent commit's ``faster_whisper_tpu_torch/csrc`` and the
working tree's.  Both are built with the package's nvcc flags into
``build/ab/``; each case then runs with A's and B's libraries in turn (A,
B, B, A), at the main path's shapes, through the package's wrappers.  A
``beam_attention.cu`` whose kernel takes no scratch is the earlier K1/K2
with one block per (b, h) and no split over the columns: it is called
directly through that interface.  Prints each case's device time (a CUDA
graph of 50 calls, L2 warm), its time with L2 cold, and its time per call
issued from the host, in ms, on the card named by nvidia-smi.
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
# The C interface of K1/K2 before their split over the columns.
UNSPLIT_K1 = {
    "fwt_beam_attend_append_bf16": [_P] * 8 + [_I] * 6 + [_F, _P],
    "fwt_beam_attend_append_f32": [_P] * 8 + [_I] * 6 + [_F, _P],
    "fwt_beam_attend_append_int8": [_P] * 10 + [_I] * 6 + [_F, _P],
    "fwt_beam_attend_append_int8_f32": [_P] * 10 + [_I] * 6 + [_F, _P],
}


def is_unsplit_k1(src_dir):
    with open(os.path.join(src_dir, "beam_attention.cu")) as f:
        return "part_o" not in f.read()


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
        if src == "beam_attention.cu" and is_unsplit_k1(src_dir):
            sigs = UNSPLIT_K1
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        libs[src] = lib
    return libs


def unsplit_beam_attend(lib, x):
    """K1/K2 through the interface before the split over the columns."""
    q, sk, sv = x["q"], x["self_k"], x["self_v"]
    b, h, k, d = q.shape
    out = torch.empty_like(q)
    f32 = q.dtype == torch.float32
    tail = (
        x["anc"].data_ptr(), x["pos_row"].data_ptr(), out.data_ptr(),
        b, h, k, (sk.q if isinstance(sk, QuantKV) else sk).shape[4], d, x["layer"], d ** -0.5,
        torch.cuda.current_stream().cuda_stream,
    )
    new = (q.data_ptr(), x["k_new"].data_ptr(), x["v_new"].data_ptr())
    if isinstance(sk, QuantKV):
        fn = lib.fwt_beam_attend_append_int8_f32 if f32 else lib.fwt_beam_attend_append_int8
        rc = fn(*new, sk.q.data_ptr(), sk.s.data_ptr(), sv.q.data_ptr(), sv.s.data_ptr(), *tail)
    else:
        fn = lib.fwt_beam_attend_append_f32 if f32 else lib.fwt_beam_attend_append_bf16
        rc = fn(*new, sk.data_ptr(), sv.data_ptr(), *tail)
    _build.check(rc, "beam_attend_append (unsplit)")
    return out


def main(a_dir, b_dir):
    cs.require_card()
    print(cs.card_line())
    libs = {"A": build(a_dir, "A"), "B": build(b_dir, "B")}

    from faster_whisper_tpu_torch.ops.attention import mha_flash
    from faster_whisper_tpu_torch.ops.beam_attention import beam_attend_append
    from faster_whisper_tpu_torch.ops.cross_attention import cross_attend

    unsplit = {"A": is_unsplit_k1(a_dir), "B": is_unsplit_k1(b_dir)}
    now = {}  # the tag whose libraries are loaded

    def k1(x):
        if unsplit[now["tag"]]:
            return unsplit_beam_attend(_build._libs["beam_attention.cu"], x)
        return cs._k1_call(beam_attend_append, x, (x["self_k"], x["self_v"]))

    f32 = torch.float32
    k1_cases = {
        f"{form} B={B} pos={pos}": ((cs.k2_inputs if quant else cs.k1_inputs)(
            B, pos, divergent=True, dtype=dtype))
        for form, (quant, dtype) in cs.K1_FORMS.items()
        for B, pos in ((1, 447), (8, 447))
    }
    k1_cases["K1 B=5 pos=223"] = cs.k1_inputs(5, 223, divergent=True)
    k4b, k4i = cs.k4_inputs(1, False), cs.k4_inputs(1, True)
    k4b8, k4i8 = cs.k4_inputs(8, False), cs.k4_inputs(8, True)
    k3b1, k3b8 = cs.k3_inputs(1), cs.k3_inputs(8)
    k3f1, k3f8 = cs.k3_inputs(1, dtype=f32), cs.k3_inputs(8, dtype=f32)
    cases = {name: (lambda x=x: k1(x)) for name, x in k1_cases.items()}
    cases.update({
        "K3 (1,1500,20,64)": lambda: mha_flash(*k3b1),
        "K3 (8,1500,20,64)": lambda: mha_flash(*k3b8),
        "K3 f32 (1,1500,20,64)": lambda: mha_flash(*k3f1),
        "K3 f32 (8,1500,20,64)": lambda: mha_flash(*k3f8),
        "K4 bf16 B=1": lambda: cross_attend(*k4b),
        "K4 int8 B=1": lambda: cross_attend(*k4i),
        "K4 bf16 B=8": lambda: cross_attend(*k4b8),
        "K4 int8 B=8": lambda: cross_attend(*k4i8),
    })
    res = {}
    for tag in ("A", "B", "B", "A"):
        _build._libs.update(libs[tag])
        now["tag"] = tag
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
