"""Decode of zstd entropy payloads on the card: the port of
stenos_tpu/entropy/device_decode.py (decode_payload_device), batched over
payloads.

Covers the payloads of methods ZSTD, TRANSPOSED_ZSTD and
TRANSPOSED_DELTA_ZSTD, this package's frames and libzstd's alike.
decode_payloads_device decodes a batch of payloads (the frame layer gathers
64 MiB of superblocks) with one launch each of three kernels:

1. prepare: a host pass over each payload's headers and tables, in native
   code (stn_zstd_prep_batch: the sidecar layout of
   sidecar.py, the frame parse of zstd_parse.py). Per compressed block, the
   literals are a job of the anchored Huffman decode (K5,
   huff_decode_kernel.py, with its decode tables) when they are 4 Huffman
   streams with anchors, from the decode-anchor sidecar or a length-only
   scan (stn_huf_anchors, the route of libzstd's frames), and host bytes
   otherwise (raw, RLE, native huf_lits); the sequences section gets its
   FSE tables (stn_zstd_dtables, the Repeat_Mode tables chained through
   the frame's blocks in order). The anchor scans are its costly part: it
   runs on one thread, and on up to host/staging.py's HOST_THREADS when
   the batch has scans to run (one thread for each 8). The frame layer
   runs it on a thread while the batch before decodes; decode_prepared
   does steps 2-4.
2. One host-to-device copy of the packed inputs; K5 over every job's 4
   streams, and K7 (seqdec_kernel.py) with one lane a payload: the raw
   sequences, the repeat offsets resolved on the card (chained across the
   payload's blocks from the registers [1, 4, 8]) and a summary of each
   section.
3. One small device-to-host copy of the summaries and error bits: the host
   checks them and lays out every block of the batch.
4. X1 (seq_exec.py) writes the blocks: literals from the host buffer or in
   place from K5's rows, then the matches; one lane a block when no match of
   the payload reaches before its block, else one lane over the payload's
   blocks in order.

A payload whose frame, block or section headers the parsers here reject is
None, and the frame layer asks host libzstd: the ladder of
stenos.cpp:681-753. host_ladder counts those payloads, and the first of
them warns. Once the headers parse, a K7 error flag and any other
inconsistency (literals, repeat offsets, sizes, a match before the frame)
raise StenosError(ERROR_INVALID_INPUT), as host libzstd's failure does: a
kernel fault never turns into host work.
"""

import contextlib
import sys
import warnings

import numpy as np
import torch

from .. import native
from ..constants import ERROR_INVALID_INPUT
from ..frame import StenosError
from ..host import staging as host_staging
from ..utils import trace
from .huff_decode_kernel import decode_streams
from .huff_kernel import STREAM, WOUT_WORDS
from .seq_exec import execute
from .seqdec_kernel import decode_sections

BLOCK_MAX = 131072

# payloads handed back to host libzstd (chip_smoke.py reads this)
host_ladder = 0

# seconds by step of the decode, summed over calls, when set to a dict
# (chip_smoke.py does): each step is a span of utils/trace.py, and setting
# this also turns that recorder on. _HOST_STEPS take the host's time; on a
# CUDA device the others take their CUDA events' time, added by settle()
# once the call has waited for the card
timing = None
_HOST_STEPS = ("host_pass", "frame_out")
_unsettled = []  # (step, span) of device steps not yet added to timing
_LADDER, _CORRUPT = 1, 2  # its payload statuses


@contextlib.contextmanager
def step(name, device):
    """The span "stn.zstd.<name>" around the step; its time goes to
    timing[name] when timing is a dict (see there)."""
    on_card = device.type == "cuda" and name not in _HOST_STEPS
    with trace.span("stn.zstd." + name, device if on_card else None) as s:
        yield
    if timing is not None:
        if on_card:
            _unsettled.append((name, s))
        else:
            timing[name] = timing.get(name, 0.0) + s.host_ms / 1e3


def settle():
    """Add the device steps' event times to timing. It waits for the
    events it reads: the frame layer calls it once its copy of a batch's
    output has waited for the card, decode_payloads_device at its end."""
    while _unsettled:
        name, s = _unsettled.pop(0)
        if timing is not None:
            timing[name] = timing.get(name, 0.0) + s.device_ms() / 1e3


def _corrupt():
    raise StenosError(ERROR_INVALID_INPUT)


def _upload(arrays, staging, name):
    """One host-to-device copy of numpy arrays, each 16-byte aligned,
    through staging's buffer name: their device views."""
    offs, pos = [], 0
    for a in arrays:
        offs.append(pos)
        pos += -(-a.nbytes // 16) * 16
    stage = staging.get(name, max(pos, 16))
    host = stage.numpy()
    for a, o in zip(arrays, offs):
        host[o : o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(
            np.uint8)
    dev = stage.to(staging.device, copy=True)
    return [dev[o : o + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
            .view(a.shape) for a, o in zip(arrays, offs)]


def _layout(blocks, dsizes, meta, summ):
    """X1's blocks (nblk, 7) and lanes (nlanes, 3) from the host pass's
    blocks and K7's section summaries, after their checks; raises
    StenosError on a corrupt payload (the first in order)."""
    starts = np.cumsum([0] + list(dsizes[:-1])).tolist()
    rows, lanes = [], []
    o = b0 = 0
    gapped = True
    summ, meta = summ.tolist(), meta.tolist()
    blocks = blocks.tolist()
    for k, (pay, regen, lit_off, job, sec) in enumerate(blocks):
        seq_off = nseq = 0
        out_len = regen
        if sec >= 0:
            sum_ll, sum_ml, lo_src, err = summ[sec]
            if err or regen < sum_ll:
                _corrupt()
            out_len = regen + sum_ml
            if out_len > BLOCK_MAX or lo_src + o < 0:
                _corrupt()  # too long, or a match before the frame
            gapped &= lo_src >= 0
            nseq, seq_off = meta[sec][3], meta[sec][4]
        if o + out_len > dsizes[pay]:
            _corrupt()
        rows.append((starts[pay] + o, out_len, lit_off, regen, seq_off, nseq,
                     -1 if job < 0 else 4 * job))
        o += out_len
        if k + 1 == len(blocks) or blocks[k + 1][0] != pay:  # its last block
            if o != dsizes[pay]:
                _corrupt()
            if gapped:
                lanes += [(b, b + 1, int(rows[b][5] > 0))
                          for b in range(b0, k + 1)]
            else:
                lanes.append((b0, k + 1, 0))
            o, b0, gapped = 0, k + 1, True
    return (np.asarray(rows, np.int64).reshape(-1, 7),
            np.asarray(lanes, np.int64).reshape(-1, 3))


def _decode(buf, dsizes, prep, out, staging):
    """Steps 2-4 of the module docstring: prep is the host pass's blocks,
    K5 rows, anchors, code lengths and tables, K7 meta and tables, host
    literals."""
    device = staging.device
    blocks, rows, anch, _, tabs5, meta, tabs, lits, _ = prep
    secs = blocks[blocks[:, 4] >= 0, 0]
    lane_sizes = np.bincount(secs, minlength=len(dsizes))
    lane_sizes = lane_sizes[lane_sizes > 0]
    ends = np.cumsum(lane_sizes)
    lanes7 = np.stack([ends - lane_sizes, ends], 1).astype(np.int64)
    k5 = [rows, anch, tabs5]
    with step("h2d", device):
        dev = _upload([*k5, buf, meta, tabs, lanes7,
                       np.append(lits, np.uint8(0))], staging, "inputs")
    with step("k5", device):
        rows_d = (decode_streams(*dev[:3]) if len(rows) else
                  torch.empty((0, STREAM), dtype=torch.uint8, device=device))
    if len(meta):
        with step("k7", device):
            ll, ml, _, off, summ = decode_sections(*dev[3:7])
        with step("d2h_summaries", device):
            summ = summ.cpu().numpy()
    else:
        ll = ml = off = torch.empty(0, dtype=torch.int32, device=device)
        summ = np.zeros((0, 4), np.int64)
    with step("layout", device):
        xblocks, xlanes = _layout(blocks, dsizes, meta, summ)
        blocks_d, lanes_d = _upload([xblocks, xlanes], staging, "layout")
    with step("x1", device):
        execute(out, dev[7], rows_d, ll, ml, off, blocks_d, lanes_d)


def prepare(buf, offs, lens, dsizes):
    """Step 1 for the payloads buf[offs[i] : offs[i] + lens[i]] of dsizes[i]
    bytes (buf: uint8, a multiple of 4 bytes long): (status, prep) for
    decode_prepared. Native and without the GIL, so a caller may run it on
    a thread while an earlier batch decodes."""
    return native.load().zstd_prep_batch(buf, offs, lens, dsizes,
                                         host_staging.HOST_THREADS,
                                         4 * WOUT_WORDS)


def decode_prepared(buf, dsizes, prepared, out, staging=None):
    """Steps 2-4 of a prepare()d batch into out (a (sum(dsizes),) uint8
    tensor, payload i at the sum of the dsizes before it), through the
    caller's staging buffers (a Staging on out's device; a new one when
    None). Counts the ladder payloads and raises StenosError on the first
    corrupt payload in order. Returns, per payload, whether it decoded
    (False: the host ladder; its part of out is left as it was)."""
    global host_ladder
    status, *prep = prepared
    for st in status.tolist():
        if st == _CORRUPT:
            _corrupt()
        if st == _LADDER:
            if not host_ladder:
                warnings.warn("a zstd payload the device decode cannot "
                              "parse goes to host libzstd "
                              "(device_decode.host_ladder counts them)",
                              RuntimeWarning, stacklevel=3)
            host_ladder += 1
    if len(prep[0]):
        _decode(buf, dsizes, prep, out, staging or host_staging.Staging(out.device))
    return [st == 0 for st in status.tolist()]


def decode_payloads_device(payloads, dsizes, device="cuda"):
    """payloads: method 2/3/4/5 superblock payloads (a zstd frame and an
    optional sidecar each) of dsizes bytes. Returns, per payload, its
    (dsize,) uint8 slice of one device output, or None when its headers are
    not device-decodable (counted in host_ladder; the caller asks host
    libzstd). Raises StenosError when a payload whose headers parse is
    corrupt: the first such payload in order."""
    device = torch.device(device)
    dsizes = [int(d) for d in dsizes]
    lens = [len(p) for p in payloads]
    offs = np.cumsum([0] + lens[:-1])
    buf = np.zeros(max(4, -(-sum(lens) // 4) * 4), np.uint8)
    for p, o, n in zip(payloads, offs, lens):
        buf[o : o + n] = np.frombuffer(p, np.uint8)
    out = torch.empty(sum(dsizes), dtype=torch.uint8, device=device)
    with step("host_pass", device):
        prepared = prepare(buf, offs, lens, dsizes)
    ok = decode_prepared(buf, dsizes, prepared, out)
    settle()
    res, o = [], 0
    for good, d in zip(ok, dsizes):
        res.append(out[o : o + d] if good else None)
        o += d
    return res


def decode_payload_device(payload, dsize: int, device="cuda"):
    """One payload (see decode_payloads_device): (dsize,) uint8 on device or
    None (the host ladder)."""
    return decode_payloads_device([payload], [dsize], device)[0]


trace.switch(sys.modules[__name__])
