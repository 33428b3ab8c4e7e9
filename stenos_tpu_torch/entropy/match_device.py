"""LZ77 match candidates and the matchiness probe on the card, as torch ops:
the port of stenos_tpu/entropy/match_device.py (_candidates_impl,
_matchiness_impl), with the same outputs.

Per doubling level k = 2 .. MAX_K the 2^k-byte windows are grouped by a
stable sort of (group id at i, group id at i + 2^(k-1)) pairs; within a
group the stable order ascends by position, so each element's sorted
predecessor with an equal key pair is its nearest earlier occurrence. torch
sorts one key: the pair is fused into one int64, (key1 mod 2^32) << 32 |
key2 (a fingerprint's high bit lands in the sign bit, which changes only
the order). The group ORDER then differs from the JAX package's two-key signed
sort, and so do the group id values, but candidates depend only on key
equality and sort stability, so they agree bit for bit. The unpermute back
to position order is a scatter. The JAX package pads the batch to a power
of two and works in groups of 16 blocks only to bound XLA compiles; here one
call takes every block.
"""

import numpy as np
import torch

MIN_K = 2          # first level: 4-byte windows
MAX_K = 12         # guaranteed-length cap 4096 (exact extension is unbounded)

CAND_DIST_MASK = 0x00FFFFFF  # low 24 bits: distance; bits 24..27: k


def _fingerprints(blocks):
    """(B, N) uint8 -> the exact 4-byte window at each position as an int64
    in [0, 2^32) (bytes past the block read as 0), and the second key that
    gives each position whose window runs off the block a unique pair."""
    B, N = blocks.shape
    b = torch.cat([blocks.long(), torch.zeros((B, 3), dtype=torch.int64,
                                              device=blocks.device)], 1)
    fp = b[:, :N] | (b[:, 1:N + 1] << 8) | (b[:, 2:N + 2] << 16) \
        | (b[:, 3:N + 3] << 24)
    iota = torch.arange(N, device=blocks.device)
    key2 = torch.where(iota + 4 > N, iota + 1, 0).expand(B, N)
    return fp, key2, iota


def _same_as_prev(keys_sorted):
    same = torch.zeros_like(keys_sorted, dtype=torch.bool)
    same[:, 1:] = keys_sorted[:, 1:] == keys_sorted[:, :-1]
    return same


def match_candidates(blocks, max_k: int = MAX_K):
    """blocks: (B, N) uint8 tensor -> (B, N) int32 packed candidates on its
    device: entry i holds dist | (k << 24) where the 2^k-byte windows at i
    and i - dist are identical (largest such k per position, nearest such
    earlier occurrence at that k), or 0 when position i opens no match."""
    B, N = blocks.shape
    fp, key2, iota = _fingerprints(blocks)
    key1 = fp
    cand = torch.zeros((B, N), dtype=torch.int64, device=blocks.device)
    k = MIN_K
    while True:
        keys_s, ps = torch.sort((key1 << 32) | key2, dim=1, stable=True)
        same = _same_as_prev(keys_s)
        dist_s = torch.zeros_like(ps)
        dist_s[:, 1:] = ps[:, 1:] - ps[:, :-1]
        dist_s = torch.where(same, dist_s, 0)
        gid_s = torch.cumsum((~same).long(), dim=1)
        dist_p = torch.empty_like(dist_s).scatter_(1, ps, dist_s)
        gid_p = torch.empty_like(gid_s).scatter_(1, ps, gid_s)
        cand = torch.where(dist_p > 0, dist_p | (k << 24), cand)
        if k >= max_k:
            break
        # next level: pair each window's id with the id 2^k bytes later;
        # ids are in [1, N], so N + 1 + i is a unique code past the block
        L = 1 << k
        key1 = gid_p
        key2 = (N + 1 + iota).expand(B, N).clone()
        key2[:, :max(N - L, 0)] = gid_p[:, L:]
        k += 1
    return cand.to(torch.int32)


def matchiness(blocks) -> np.ndarray:
    """(B, N) uint8 tensor -> (B,) float32 on the host: the fraction of
    positions whose 4-byte window already occurred in the block (duplicate
    4-grams: LZ potential). An integer count over N, exact, as the JAX
    package's float32 mean is (N = 2^17), so the routing test
    mfrac >= 1/8 agrees."""
    fp, key2, _ = _fingerprints(blocks)
    keys_s, _ = torch.sort((fp << 32) | key2, dim=1)
    counts = _same_as_prev(keys_s).sum(dim=1).cpu().numpy()
    return (counts / blocks.shape[1]).astype(np.float32)
