"""4-stream byte delta filter — SPEC.md §2.2 (delta.cpp:30-71, 230+).

The 4-way stream split exists so the inverse (a byte prefix-sum) can run as 4
independent scans. Host code: only the zstd methods of the frame layer use
it.
"""

import numpy as np


def _split(n):
    if n <= 2048:
        return None
    return n // 4


def delta_np(src: np.ndarray) -> np.ndarray:
    n = len(src)
    if n == 0:
        return src.copy()
    s = src.astype(np.int32)
    out = np.empty(n, dtype=np.int32)
    q = _split(n)
    if q is None:
        out[0] = s[0]
        out[1:] = s[1:] - s[:-1]
    else:
        for k in range(4):
            st = k * q
            out[st] = s[st]
            out[st + 1 : st + q] = s[st + 1 : st + q] - s[st : st + q - 1]
        for j in range(4 * q, n):
            out[j] = s[j] - s[j - 1]
    return (out & 255).astype(np.uint8)


def delta_inv_np(src: np.ndarray) -> np.ndarray:
    n = len(src)
    if n == 0:
        return src.copy()
    s = src.astype(np.int64)
    out = np.empty(n, dtype=np.int64)
    q = _split(n)
    if q is None:
        out[:] = np.cumsum(s)
    else:
        for k in range(4):
            st = k * q
            out[st : st + q] = np.cumsum(s[st : st + q])
        prev = out[4 * q - 1] if n > 4 * q else 0
        for j in range(4 * q, n):
            prev = prev + s[j]
            out[j] = prev
    return (out & 255).astype(np.uint8)
