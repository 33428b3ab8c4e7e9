"""RFC 8878 zstd frames with Huffman-coded literals and FSE-coded sequences,
encoded with the card's help: the port of encode_frame_device and the
helpers it calls in stenos_tpu/entropy/zstd_frame.py, byte-identical to it.

Full 128 KiB blocks without LZ potential run their byte histogram (K3) and
their four Huffman streams (K4) through huff_kernel.py's kernels; the host
builds the tables and tree descriptions and assembles the sections. Blocks
with LZ potential, and the partial tail, go to the native block encoder
(stn_encode_block: match finding, greedy parse, Huffman literals, FSE
sequences); their match candidates come from the card (match_device.py)
unless STENOS_DEVICE_MATCH=0. The output is plain standard zstd, decodable
by libzstd, followed (unless sidecar=False) by a skippable sidecar of
decode anchors (sidecar.py) that lets device_decode.py decode the literals
on the card without scanning them. STENOS_SEQ_ANCHORS=0 leaves the blocks
of the native encoder out of the sidecar: the decode then scans their
literals (stn_huf_anchors), as it does for libzstd's frames.
encode_frame_host encodes every block through the native encoder (its own
match finding), with no sidecar.
"""

import os

import numpy as np
import torch

from .. import native
from .huff_kernel import STREAM, encode_streams, histogram
from .huffman import build_ctables_batch, code_lengths_batch
from .match_device import match_candidates, matchiness
from .sequences import FRESH_REPS
from .sidecar import pack_sidecar
from .zstd_parse import BlockSpec, _parse_sections

BLOCK_MAX = 128 * 1024
MAGIC = 0xFD2FB528


def _seq_anchors_on() -> bool:
    """STENOS_SEQ_ANCHORS: "0" or "false" leaves the native encoder's
    blocks without sidecar anchors."""
    return os.environ.get("STENOS_SEQ_ANCHORS", "1") not in ("0", "false")


def _header(n: int) -> bytearray:
    """Frame header: single segment, 4-byte content size; an empty frame
    gets its one empty raw block."""
    out = bytearray(MAGIC.to_bytes(4, "little") + bytes([0xA0])
                    + n.to_bytes(4, "little"))
    if n == 0:
        out += (1 | (0 << 1) | (0 << 3)).to_bytes(3, "little")
    return out


def _u8(data) -> np.ndarray:
    return np.frombuffer(bytes(data), np.uint8) if not isinstance(
        data, np.ndarray) else np.asarray(data, np.uint8)


def encode_block(data: np.ndarray, last: bool, reps=None, cand=None):
    """One zstd block through the native encoder: (block bytes, reps out).
    reps: the running repeat-offset registers (they persist across the
    blocks of a frame), None at the frame start. cand: device match
    candidates (match_device.match_candidates) in place of the host
    fp4-map finder. The native build raises on failure."""
    rarr = np.asarray(FRESH_REPS if reps is None else reps, np.int64).copy()
    blk = native.load().encode_block(data, last, rarr, cand)
    return blk, tuple(int(v) for v in rarr)


def _block_anchor_entry(blk: bytes):
    """Decode-anchor sidecar entry of one encoded block (3-byte header and
    content): (lens (256,), anchors (4, 256)) when its literals are
    4-stream Huffman of at least 64 bytes, else None. Sequence-bearing
    blocks get anchors too, from a length-only native scan of the literal
    streams (stn_huf_anchors); the block bytes do not change.
    anchors[s][g] = bit read position of stream s's symbol g*128."""
    bh = int.from_bytes(blk[:3], "little")
    if ((bh >> 1) & 3) != 2:
        return None
    spec = BlockSpec(2, 3, len(blk) - 3, 0)
    if _parse_sections(blk, spec) is None:
        return None
    lit = spec.lit
    if (lit is None or lit.kind != "huf" or not lit.four or lit.treeless
            or lit.regenerated < 64):
        return None
    lib = native.load()
    r = lib.huf_anchors(blk[lit.off : lit.off + lit.length], lit.regenerated,
                        lib.zstd_ctx())
    if isinstance(r, int):
        return None
    return r[0].astype(np.int64), r[1]


def _route_blocks(full, device):
    """(runny, cands) of the (nfull, BLOCK_MAX) full blocks: runny marks the
    blocks that go to the sequence encoder (neighbour-equal runs or
    duplicate 4-grams), cands maps each of them to its device match
    candidates. STENOS_DEVICE_MATCH=0 routes by the native prefix probe and
    leaves the matching to the native fp4-map walk. Anything else takes the
    device candidates: the JAX package's rule when its bus probe finds the
    host link healthy (utils.bus.d2h_gbps() >= 0.5), which a card's PCIe or
    NVLink host link always is."""
    eqc = (full[:, 1:] == full[:, :-1]).sum(axis=1)
    runny = eqc >= BLOCK_MAX // 32
    cands = {}
    if os.environ.get("STENOS_DEVICE_MATCH", "auto") == "0":
        lib = native.load()
        mfrac = np.array([lib.matchiness(b) for b in full], np.float32)
        return runny | (mfrac >= 1 / 8), cands
    x = torch.from_numpy(np.require(full, requirements=["C", "W"])).to(device)
    runny = runny | (matchiness(x) >= 1 / 8)
    idx = np.flatnonzero(runny)
    if len(idx):
        got = match_candidates(x[torch.from_numpy(idx).to(device)]).cpu()
        cands = {int(b): got[j].numpy() for j, b in enumerate(idx)}
    return runny, cands


def encode_frame_host(data) -> bytes:
    """data: bytes or uint8 array -> one zstd frame (single segment, 4-byte
    content size) of 128 KiB blocks through the native encoder, with no
    sidecar."""
    data = _u8(data)
    n = len(data)
    out = _header(n)
    pos = 0
    reps = None
    while pos < n:
        chunk = data[pos : pos + BLOCK_MAX]
        pos += len(chunk)
        blk, reps = encode_block(chunk, pos >= n, reps)
        out += blk
    return bytes(out)


def encode_frame_device(data, device="cuda", sidecar: bool = True) -> bytes:
    """data: bytes or uint8 array -> one zstd frame (single segment, 4-byte
    content size) and, when sidecar is true, the decode-anchor skippable
    frame, which libzstd and the C++ reference skip. device: where K3, K4
    and the match candidates run (a CPU device takes their plain
    versions)."""
    device = torch.device(device)
    data = _u8(data)
    n = len(data)
    out = _header(n)
    if n == 0:
        return bytes(out)
    nfull = n // BLOCK_MAX
    blocks = []
    sc_entries = []
    reps = None  # repeat-offset registers persist across blocks
    host_anchors = sidecar and _seq_anchors_on()

    def host_block(chunk, last, cand=None):
        nonlocal reps
        blk, reps = encode_block(chunk, last, reps, cand=cand)
        blocks.append(blk)
        sc_entries.append(_block_anchor_entry(blk) if host_anchors else None)

    if nfull:
        full = data[: nfull * BLOCK_MAX].reshape(nfull, BLOCK_MAX)
        runny, cands = _route_blocks(full, device)
        # the histogram and stream kernels run only on the other blocks
        dev_idx = np.flatnonzero(~runny)
        metas = [None] * nfull
        if len(dev_idx):
            xb = torch.from_numpy(np.ascontiguousarray(full[dev_idx])).to(
                device)
            hist = histogram(xb).cpu().numpy()
            lens_all = code_lengths_batch(hist)
            codes_all = build_ctables_batch(lens_all)
            trees = native.load().huff_tree_descs(lens_all)
            luts = np.zeros((len(dev_idx), 256), np.int32)
            for j, b in enumerate(dev_idx):
                if int((lens_all[j] > 0).sum()) < 2 or trees[j] is None:
                    continue
                metas[b] = (j, lens_all[j], trees[j])
                luts[j] = (codes_all[j].astype(np.int32)
                           | (lens_all[j].astype(np.int32) << 11))
            slut = torch.from_numpy(np.repeat(luts, 4, axis=0)).to(device)
            words, sizes, anchors = encode_streams(
                xb.view(-1, STREAM), slut, with_anchors=True)
            wbytes = words.cpu().numpy().view("<u1").reshape(
                words.shape[0], -1)
            sizes = sizes.cpu().numpy()
            anchors = anchors.cpu().numpy()
        for b in range(nfull):
            chunk = full[b]
            last = (b == nfull - 1) and n == nfull * BLOCK_MAX
            m = metas[b]
            if m is None:
                host_block(chunk, last, cands.get(b))
                continue
            j, lens_b, tree = m
            enc = [bytes(wbytes[4 * j + s][: sizes[4 * j + s]])
                   for s in range(4)]
            if any(len(e) > 0xFFFF for e in enc[:3]):
                host_block(chunk, last)
                continue
            jump = b"".join(len(e).to_bytes(2, "little") for e in enc[:3])
            payload = tree + jump + b"".join(enc)
            csize = len(payload)
            if csize + 6 >= BLOCK_MAX:
                host_block(chunk, last)
                continue
            hdr = 2 | (3 << 2) | (BLOCK_MAX << 4) | (csize << 22)
            content = hdr.to_bytes(5, "little") + payload + b"\x00"
            bh = int(last) | (2 << 1) | (len(content) << 3)
            blocks.append(bh.to_bytes(3, "little") + content)
            sc_entries.append((lens_b, anchors[4 * j : 4 * j + 4]))
    if n > nfull * BLOCK_MAX:
        host_block(data[nfull * BLOCK_MAX :], True)
    for blk in blocks:
        out += blk
    if sidecar and any(e is not None for e in sc_entries):
        out += pack_sidecar(sc_entries)
    return bytes(out)
