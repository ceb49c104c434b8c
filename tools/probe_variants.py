#!/usr/bin/env python3
"""Variants of the probe kernels P1 and P2h on one card.

    python3 tools/probe_variants.py [CSRC_DIR]

Copies ``probes.cu`` from CSRC_DIR (default: the package's ``csrc/``),
changes one design constant per copy by text replacement (P1's columns
per CTA and threads; P2h's CTAs per cluster, threads and register bound),
builds each with the package's nvcc flags into ``build/probe_variants/``
and calls its launchers through ``ctypes`` at the probe scripts' shape
(B=8, H=20, K=5, ctx=192, pos 120).  Every variant's output must equal the
package's kernel's bit for bit.  Prints each one's device time (a CUDA
graph of 50 calls, L2 warm), in three rounds, beside P2b and K2 at the
same shape, on the card named by nvidia-smi.
"""

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from faster_whisper_tpu_torch.ops import _build, probes  # noqa: E402
from faster_whisper_tpu_torch.ops.beam_attention import beam_attend_append  # noqa: E402

P2H_BOUND = "__launch_bounds__(P2H_THREADS, 2)"
VARIANTS = {  # name -> {text: replacement} in probes.cu
    "P1 as built": {},
    "P1 24 columns per CTA": {"P1_COLS = 48": "P1_COLS = 24"},
    "P1 96 columns per CTA": {"P1_COLS = 48": "P1_COLS = 96"},
    "P1 256 threads": {"P1_THREADS = 128": "P1_THREADS = 256"},
    "P2h as built": {},
    "P2h clusters of 16 CTAs": {"P2H_CLUSTER = 8;": "P2H_CLUSTER = 16;"},
    "P2h clusters of 4 CTAs": {"P2H_CLUSTER = 8;": "P2H_CLUSTER = 4;"},
    "P2h 256 threads": {"P2H_THREADS = 512;": "P2H_THREADS = 256;", P2H_BOUND: "__launch_bounds__(P2H_THREADS, 4)"},
    "P2h 1024 threads": {"P2H_THREADS = 512;": "P2H_THREADS = 1024;", P2H_BOUND: "__launch_bounds__(P2H_THREADS, 1)"},
    "P2h no register bound": {P2H_BOUND: "__launch_bounds__(P2H_THREADS, 1)"},
}


def build(src_dir):
    """{variant: loaded library}, one nvcc per variant, all started together."""
    out_dir = os.path.join(ROOT, "build", "probe_variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(src_dir, "probes.cu")) as f:
        src = f.read()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs.items():
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in {src_dir}/probes.cu")
            text = text.replace(old, new)
        path = os.path.join(out_dir, re.sub(r"\W+", "_", name) + ".cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", path[:-3] + ".so", path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                       path[:-3] + ".so")
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed:\n{log}")
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines() if "registers" in ln]
        print(f"built {name}: {regs}")
        lib = libs[name] = ctypes.CDLL(so)
        for fn, argtypes in _build.SIGNATURES["probes.cu"].items():
            getattr(lib, fn).argtypes = argtypes
    return libs


def main(src_dir):
    cs.require_card()
    card = cs.card_line()
    libs = build(src_dir)
    dims = probes.PROBE_SHAPE
    B, H, K, ctx, D = dims["B"], dims["H"], dims["K"], dims["ctx"], dims["D"]
    layer = dims["L"] - 1
    x = probes.probe_inputs(**dims, device="cuda", pos=probes.PROBE_POS)
    kq = x["self_k"].q
    args = (layer, x["pos"], x["q"], x["self_k"], x["self_v"], x["anc"])
    want = {"P1": probes.attend_only(*args), "P2h": probes.scores_perhead(layer, x["q_flat"], kq)}
    caches = (cs._clone(x["self_k"]), cs._clone(x["self_v"]))  # K2 appends at pos
    calls = {
        "K2 at the probe shape": lambda: beam_attend_append(layer, x["pos"], x["q"], x["k_new"], x["v_new"],
                                                            *caches, x["anc"]),
        "P2b": lambda: probes.scores_batched(layer, x["q"], kq),
    }

    def stream():
        return torch.cuda.current_stream().cuda_stream

    for name, lib in libs.items():
        kind = name.split()[0]
        out = torch.empty_like(want[kind])
        if kind == "P1":
            call = (lambda lib=lib, out=out: lib.fwt_attend_only_int8(
                x["q"].data_ptr(), kq.data_ptr(), x["self_k"].s.data_ptr(), x["self_v"].q.data_ptr(),
                x["self_v"].s.data_ptr(), x["anc"].data_ptr(), x["pos"].data_ptr(), out.data_ptr(),
                None, None, B, H, K, ctx, D, layer, D ** -0.5, stream()))
        else:
            call = (lambda lib=lib, out=out: lib.fwt_scores_perhead_int8(
                x["q_flat"].data_ptr(), kq.data_ptr(), out.data_ptr(), None, B, H, K, ctx, D, layer,
                stream()))
        rc = call()
        torch.cuda.synchronize()
        if rc != 0 or not torch.equal(out, want[kind]):
            raise SystemExit(f"{name}: CUDA error {rc} or an output unlike the package's kernel's")
        calls[name] = call
    times = {}
    for _ in range(3):
        for name, call in calls.items():
            times.setdefault(name, []).append(cs.time_ms(call, iters=50))
    for name, ts in times.items():
        print(f"{name}: {'/'.join(f'{t:.4f}' for t in ts)} ms warm (B={B} H={H} K={K} ctx={ctx} "
              f"pos={probes.PROBE_POS}) on {card}")


if __name__ == "__main__":
    if len(sys.argv) > 2:
        sys.exit(__doc__)
    main(os.path.abspath(sys.argv[1]) if len(sys.argv) == 2
         else os.path.join(ROOT, "faster_whisper_tpu_torch", "csrc"))
