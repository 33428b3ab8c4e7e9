"""Byte shuffle (Blosc-style transpose) — SPEC.md §2.1.

Host-side numpy reshape+transpose: the frame layer shuffles for the zstd
methods and the LZ estimators, which stay host code.
"""

import numpy as np


def shuffle_np(data: np.ndarray, bpp: int) -> np.ndarray:
    """dst[p*ne + e] = src[e*bpp + p]; trailing n % bpp bytes copied as-is."""
    n = data.shape[0]
    if bpp == 1:
        return data.copy()
    ne = n // bpp
    rem = n % bpp
    out = np.empty_like(data)
    out[: ne * bpp] = data[: ne * bpp].reshape(ne, bpp).T.reshape(-1)
    if rem:
        out[ne * bpp :] = data[ne * bpp :]
    return out


def unshuffle_np(data: np.ndarray, bpp: int) -> np.ndarray:
    n = data.shape[0]
    if bpp == 1:
        return data.copy()
    ne = n // bpp
    rem = n % bpp
    out = np.empty_like(data)
    out[: ne * bpp] = data[: ne * bpp].reshape(bpp, ne).T.reshape(-1)
    if rem:
        out[ne * bpp :] = data[ne * bpp :]
    return out
