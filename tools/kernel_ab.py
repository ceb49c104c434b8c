#!/usr/bin/env python3
"""A/B of two versions of the port's decode-attention kernels on one card.

    python3 tools/kernel_ab.py A_DIR B_DIR

A_DIR and B_DIR each hold a ``beam_attention.cu`` (K1/K2) and a
``cross_attention.cu`` (K4) with the C interface of
``faster_whisper_tpu_torch/ops/_build.py::SIGNATURES``, for example an
unpacked parent commit's ``faster_whisper_tpu_torch/csrc`` and the working
tree's.  Both are built with the package's nvcc flags into ``build/ab/``;
each case then runs through the package's wrappers with A's and B's
libraries in turn (A, B, B, A), at the main path's shapes.  Prints each
case's device time (a CUDA graph of 50 calls) and its time per call issued
from the host, in ms, on the card named by nvidia-smi.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from faster_whisper_tpu_torch.ops import _build  # noqa: E402

SOURCES = ("beam_attention.cu", "cross_attention.cu")


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
        for name, argtypes in _build.SIGNATURES[src].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        libs[src] = lib
    return libs


def main(a_dir, b_dir):
    cs.require_card()
    print(cs.card_line())
    libs = {"A": build(a_dir, "A"), "B": build(b_dir, "B")}

    from faster_whisper_tpu_torch.ops.beam_attention import beam_attend_append
    from faster_whisper_tpu_torch.ops.cross_attention import cross_attend

    x1 = cs.k1_inputs(1, 447, divergent=True)
    x2 = cs.k2_inputs(1, 447, divergent=True)
    x5 = cs.k1_inputs(5, 223, divergent=True)
    k4b, k4i, k4b8 = cs.k4_inputs(1, False), cs.k4_inputs(1, True), cs.k4_inputs(8, False)
    cases = {
        "K1 B=1 pos=447": lambda: cs._k1_call(beam_attend_append, x1, (x1["self_k"], x1["self_v"])),
        "K2 B=1 pos=447": lambda: cs._k1_call(beam_attend_append, x2, (x2["self_k"], x2["self_v"])),
        "K1 B=5 pos=223": lambda: cs._k1_call(beam_attend_append, x5, (x5["self_k"], x5["self_v"])),
        "K4 bf16 B=1": lambda: cross_attend(*k4b),
        "K4 int8 B=1": lambda: cross_attend(*k4i),
        "K4 bf16 B=8": lambda: cross_attend(*k4b8),
    }
    res = {}
    for tag in ("A", "B", "B", "A"):
        _build._libs.update(libs[tag])
        for name, fn in cases.items():
            res.setdefault(name, []).append(
                (tag, cs.time_ms(fn, iters=50), cs.call_ms(fn, iters=50))
            )
    for name, r in res.items():
        print(name, "device", " ".join(f"{t}={ms:.4f}" for t, ms, _ in r),
              "| per host call", " ".join(f"{t}={ms:.4f}" for t, _, ms in r))


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    main(os.path.abspath(sys.argv[1]), os.path.abspath(sys.argv[2]))
