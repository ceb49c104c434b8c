"""Monotonic DTW over a word-alignment cost matrix.

``dtw_path`` runs the native library (``csrc/dtw.cpp``, built with ``g++``
into ``build/torch_kernels/`` at first use by ``ops/_build.py``); a failed
build raises, with no fallback.  ``_dtw_path_numpy`` is the port's copy of
the JAX package's numpy version (``models/engine.py::_dtw_path_numpy``):
the plain version that the tests hold the native one to, index for index.
Both accumulate in float64; ties prefer the match (diagonal), then the
insertion.
"""

import ctypes

from typing import Tuple

import numpy as np


def dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(text_idx, time_idx) of the backtraced path through an (N, M)
    cost matrix, in forward order, as int64 arrays."""
    from faster_whisper_tpu_torch.ops import _build

    if ctypes.sizeof(ctypes.c_long) != 8:
        raise RuntimeError("dtw.cpp writes C longs; this platform's are not 64-bit")
    lib = _build.load("dtw.cpp")
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    n, m = cost.shape
    out_text = np.empty(n + m, dtype=np.int64)
    out_time = np.empty(n + m, dtype=np.int64)
    k = lib.fwt_dtw(cost.ctypes.data, n, m, out_text.ctypes.data, out_time.ctypes.data)
    return out_text[:k].copy(), out_time[:k].copy()


def _dtw_path_numpy(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The plain version of ``dtw_path``, vectorized over anti-diagonals."""
    n, m = cost.shape
    INF = np.float64(np.inf)
    acc = np.full((n + 1, m + 1), INF, dtype=np.float64)
    acc[0, 0] = 0.0
    trace = np.zeros((n + 1, m + 1), dtype=np.int8)

    # anti-diagonal d ranges over i + j
    for d in range(1, n + m + 1):
        i_lo = max(1, d - m)
        i_hi = min(n, d)
        if i_lo > i_hi:
            continue
        i = np.arange(i_lo, i_hi + 1)
        j = d - i
        valid = (j >= 1) & (j <= m)
        i, j = i[valid], j[valid]
        c0 = acc[i - 1, j - 1]  # match (diag)
        c1 = acc[i - 1, j]  # insertion
        c2 = acc[i, j - 1]  # deletion
        best = np.minimum(np.minimum(c0, c1), c2)
        acc[i, j] = cost[i - 1, j - 1] + best
        trace[i, j] = np.where(best == c0, 0, np.where(best == c1, 1, 2))

    # backtrace
    i, j = n, m
    text_idx, time_idx = [], []
    while i > 0 or j > 0:
        text_idx.append(i - 1)
        time_idx.append(j - 1)
        if i > 0 and j > 0:
            t = trace[i, j]
        elif i > 0:
            t = 1
        else:
            t = 2
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.array(text_idx[::-1]), np.array(time_idx[::-1])
