"""Builds the port's native sources and loads them with ctypes.

Each source under ``csrc/`` has a plain C interface and becomes one shared
library under ``build/torch_kernels/`` at the root of the checkout, named
after a hash of the source and the compiler and link flags: an unchanged
source is built once and then reused.  The CUDA kernels (``.cu``) are
built with ``nvcc``; the host libraries (``.cpp``: the FLAC decoder, the
DTW of word timestamps, the VAD's state machine and the media decoder)
with the host ``g++``.  A source may link system libraries (``LINK_FLAGS``:
the media decoder links FFmpeg's).

The build runs at first use, or for the default set at once (one compiler
per source, started together) through ``build()``.  The default set is
every source but those that link system libraries, which a machine may
lack; they are built only when first used.  A failed build raises; the kernels
and the FLAC, DTW and VAD libraries never fall back to a plain version
(``media_native.py`` passes its build error on to ``decode_audio``).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")
# source -> the system libraries it links (flags after the source on the
# command line).  Such a source is left out of the default build set: a
# machine may lack the libraries and their headers.
LINK_FLAGS = {"media_decoder.cpp": ("-lavformat", "-lavcodec", "-lavutil", "-lswresample")}

_P, _I, _F, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long, ctypes.c_double

# source file -> {C function: argtypes}; a kernel launcher returns a
# cudaError_t as an int, 0 on success; ``_RESTYPES`` names the others.
SIGNATURES = {
    "beam_attention.cu": {
        "fwt_beam_attend_append_bf16": [_P] * 11 + [_I] * 7 + [_F, _P],
        "fwt_beam_attend_append_f32": [_P] * 11 + [_I] * 7 + [_F, _P],
        "fwt_beam_attend_append_int8": [_P] * 13 + [_I] * 7 + [_F, _P],
        "fwt_beam_attend_append_int8_f32": [_P] * 13 + [_I] * 7 + [_F, _P],
    },
    "cross_attention.cu": {
        "fwt_cross_attend_bf16": [_P] * 7 + [_I] * 7 + [_F, _P],
        "fwt_cross_attend_f32": [_P] * 7 + [_I] * 7 + [_F, _P],
        "fwt_cross_attend_int8": [_P] * 9 + [_I] * 7 + [_F, _P],
        "fwt_cross_attend_int8_f32": [_P] * 9 + [_I] * 7 + [_F, _P],
    },
    "flash_attention.cu": {
        "fwt_mha_flash_bf16": [_P] * 4 + [_I] * 3 + [_F, _P],
        "fwt_mha_flash_f32": [_P] * 4 + [_I] * 3 + [_F, _P],
    },
    # returns 0 or a negative code for a malformed stream
    "flac_decoder.cpp": {
        "fwt_flac_decode": [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64), *[ctypes.POINTER(ctypes.c_int32)] * 3,
        ],
        "fwt_flac_free": [ctypes.POINTER(ctypes.c_int32)],
    },
    # returns the path's length
    "dtw.cpp": {"fwt_dtw": [_P, _L, _L, _P, _P]},
    # returns the number of speech segments written
    "vad_sm.cpp": {"fwt_vad_hysteresis": [_P, _L, _D, _D, _L, _D, _D, _D, _D, _L, _P, _L]},
    # returns 0 or a negative code (bad arguments, allocation, no audio
    # stream, no decoder, a failed conversion)
    "media_decoder.cpp": {
        "fwt_media_decode": [
            ctypes.c_char_p, ctypes.c_size_t, _I, _I,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)), ctypes.POINTER(ctypes.c_int64),
        ],
        "fwt_media_free": [ctypes.POINTER(ctypes.c_int16)],
    },
}
_RESTYPES = {"fwt_flac_free": None, "fwt_dtw": _L, "fwt_vad_hysteresis": _L, "fwt_media_free": None}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built from source at first use"
        )
    return path


def _gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found on PATH: the host libraries are built from source at first use")
    return path


def _command(source: str):
    """(compiler, flags) of ``source``; the compiler is looked up at build."""
    if source.endswith(".cu"):
        return _nvcc, NVCC_FLAGS
    return _gxx, HOST_FLAGS


def library_path(source: str) -> Path:
    flags = (*_command(source)[1], *LINK_FLAGS.get(source, ()))
    digest = hashlib.sha256((CSRC_DIR / source).read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}_{digest}.so"


def build(sources: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Build the libraries of ``sources`` (default: every source that
    links no system library) that are missing, one compiler per source,
    all started together.  Returns {source: compiler output} (for the
    kernels the ``-Xptxas -v`` register and shared-memory lines),
    "(cached)" for a library that was already built.  Raises if any build
    fails."""
    if sources is None:
        sources = [src for src in SIGNATURES if src not in LINK_FLAGS]
    sources = list(sources)
    logs, procs = {}, {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for src in sources:
        out = library_path(src)
        if out.exists():
            logs[src] = "(cached)"
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        compiler, flags = _command(src)
        cmd = [compiler(), *flags, "-o", str(tmp), str(CSRC_DIR / src), *LINK_FLAGS.get(src, ())]
        procs[src] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            out,
        )
    failed = []
    for src, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[src] = text
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    if failed:
        raise RuntimeError("native build failed:\n" + "\n".join(failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if it is missing."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(library_path(source)))
            for name, argtypes in SIGNATURES[source].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _libs[source] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero CUDA error code returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
