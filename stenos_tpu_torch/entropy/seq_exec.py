"""zstd sequence execution: the CUDA kernel (X1) and its plain torch
version.

execute(out, lits, rows, ll, ml, off, blocks, lanes) writes the bytes of
blocks of zstd frames into out, in place: per block, its sequences (ll
literals, then ml bytes copied from off bytes back) and then its trailing
literals; a block without sequences is its literals. A CUDA tensor goes
through csrc/seq_exec.cu, a kernel of the port alone: in stenos_tpu the
work is XLA glue (stenos_tpu/entropy/seq_exec.py::run_programs, no Pallas),
whose round loop would cost two torch launches a round here. A CPU tensor
goes through execute_plain, the JAX package's algorithm: the literals
gathered into one buffer, then the native W-byte copy-op programs
(stn_seq_ops) run in rounds of one gather and one scatter, op r of every
lane a round, each op writing only its valid bytes (up to the next op's
destination) so no lane needs a gap for overruns.

  out    (dsize,) uint8  the output of one or more frames
  lits   (nlits,) uint8  literals decoded on the host
  rows   (nrows, 32768) uint8  the anchored Huffman decode's output (K5):
                         a block's literals are its 4 stream rows, ceil(n/4)
                         symbols each and the rest in the last
  ll, ml, off (total,) int32  sequences, offsets resolved (> 0)
  blocks (nblk, 7) int64  out_off, out_len, lit_off, lit_len, seq_off,
                          nseq, row: the literals are lits[lit_off:] when
                          row is -1, else rows[row : row + 4]
  lanes  (nlanes, 3) int64  ranges of blocks, run in order, lanes in
                          parallel, and a staged flag: the lane is one block
                          of at most 128 KiB whose matches stay inside it
                          (the kernel builds it in shared memory). Matches
                          of other lanes may read earlier blocks of the lane.
"""

import ctypes

import numpy as np
import torch

from .. import native
from ..ops import _cuda

W = 1024          # bytes an op copies in the plain version's rounds
MAX_STAGED = 131072
BLOCK_COLS = 7
ROW_BYTES = 32768

# kernel launches (chip_smoke.py reads this)
launches = 0

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {"stenos_seq_exec": [_P, _P, _P, _P, _P, _P, _P, _P, _LL,
                                   _LL, _P]}


def _programs(ll, ml, off, blocks, lanes, lit_base):
    """Per lane, the (dst, src, valid) copy ops of its blocks in order, as
    numpy; dst and src index the flat buffer [out | lits]."""
    lib = native.load()
    progs = []
    for b0, b1 in lanes:
        parts = []
        for b in range(b0, b1):
            o_off, o_len, l_off, l_len, s_off, n = (int(v)
                                                   for v in blocks[b, :6])
            sl = slice(s_off, s_off + n)
            trailing = l_len - int(ll[sl].sum())
            ops = lib.seq_ops(ll[sl], ml[sl], off[sl].astype(np.int64),
                              o_off, lit_base + l_off, trailing,
                              o_off + o_len, W)
            if isinstance(ops, int):
                raise ValueError(f"seq_exec: block {b} is corrupt ({ops})")
            dst = ops[:, 0].astype(np.int64)
            valid = np.diff(np.append(dst, o_off + o_len))
            parts.append(np.stack([dst, ops[:, 1].astype(np.int64), valid],
                                  1))
        progs.append(np.concatenate(parts) if parts
                     else np.zeros((0, 3), np.int64))
    return progs


def gather_literals(lits, rows, blocks):
    """(lits, blocks) with every block's literals in the one buffer: the
    literals of row-sourced blocks, their 4 stream rows cut to their
    symbol counts, appended to lits (their row set to -1)."""
    b = blocks.cpu().numpy().copy()
    parts, pos = [lits], lits.numel()
    for i in np.nonzero(b[:, 6] >= 0)[0]:
        n, r = int(b[i, 3]), int(b[i, 6])
        s1 = (n + 3) // 4
        parts += [rows[r, :s1], rows[r + 1, :s1], rows[r + 2, :s1],
                  rows[r + 3, : n - 3 * s1]]
        b[i, 2], b[i, 6] = pos, -1
        pos += n
    return torch.cat(parts), torch.from_numpy(b).to(blocks.device)


def execute_plain(out, lits, rows, ll, ml, off, blocks, lanes):
    """Plain torch version (see the module docstring); updates out in place
    and returns it. The staged flags change nothing here."""
    dev = out.device
    lits, blocks = gather_literals(lits, rows, blocks)
    progs = _programs(*(t.cpu().numpy() for t in (ll, ml, off, blocks,
                                                  lanes[:, :2])),
                      lit_base=out.numel())
    L = len(progs)
    R = max((len(p) for p in progs), default=0)
    if R == 0:
        return out
    ops = np.zeros((L, R, 3), np.int64)
    for i, p in enumerate(progs):
        ops[i, : len(p)] = p
    ops = torch.from_numpy(ops).to(dev)
    buf = torch.cat([out, lits, torch.zeros(W, dtype=torch.uint8,
                                            device=dev)])
    col = torch.arange(W, device=dev)
    for r in range(R):
        dst, src, valid = ops[:, r].unbind(1)
        chunk = buf[src[:, None] + col]
        keep = col < valid[:, None]
        buf[(dst[:, None] + col)[keep]] = chunk[keep]
    out.copy_(buf[: out.numel()])
    return out


def execute(out, lits, rows, ll, ml, off, blocks, lanes):
    """The wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors (see the module docstring). Updates out in place and
    returns it."""
    global launches
    if out.device.type == "cpu":
        return execute_plain(out, lits, rows, ll, ml, off, blocks, lanes)
    dev = out.device
    n = ll.numel()
    nblk = blocks.shape[0]
    nl = lanes.shape[0]
    for name, t, dtype, shape in (
            ("out", out, torch.uint8, (out.numel(),)),
            ("lits", lits, torch.uint8, (lits.numel(),)),
            ("rows", rows, torch.uint8, (rows.shape[0], ROW_BYTES)),
            ("ll", ll, torch.int32, (n,)), ("ml", ml, torch.int32, (n,)),
            ("off", off, torch.int32, (n,)),
            ("blocks", blocks, torch.int64, (nblk, BLOCK_COLS)),
            ("lanes", lanes, torch.int64, (nl, 3))):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"seq_exec: {name} must be a contiguous {shape} "
                             f"{dtype} tensor on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"seq_exec: unsupported device {dev}")
    staged_bytes = 0
    staged = lanes[:, 2] != 0
    if bool(staged.any()):
        staged_bytes = int(blocks[lanes[staged, 0], 1].max())
        if staged_bytes > MAX_STAGED:
            raise ValueError(f"seq_exec: a staged block of {staged_bytes} "
                             f"bytes exceeds {MAX_STAGED}")
    if nl:
        lib = _cuda.load("seq_exec", _SIGNATURES)
        _cuda.check(lib.stenos_seq_exec(
            out.data_ptr(), lits.data_ptr(), rows.data_ptr(), ll.data_ptr(),
            ml.data_ptr(), off.data_ptr(), blocks.data_ptr(),
            lanes.data_ptr(), nl, staged_bytes,
            torch.cuda.current_stream(dev).cuda_stream), "seq_exec")
        launches += 1
    return out
