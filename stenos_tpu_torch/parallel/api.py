"""End-to-end multi-device frame compression over torch.distributed.

The public sharded paths. Every rank runs the same calls (SPMD):

  compress_sharded / ShardedEngine  every rank passes the whole input; its
      share of the full superblocks goes through K1 on its device, the
      encoded streams and sizes are gathered to every rank, and each rank
      runs the host frame layer (method selection, LZ patch-up, the zstd
      stage) and returns the same frame, byte-identical to the
      single-device frame at every level.
  compress_device_sharded           every rank passes its own (n_local, sb)
      tensor; each rank writes its contiguous frame segment on its device
      (one K1 launch) and one all_to_all_single leaves rank t
      holding frame bytes [t*S, (t+1)*S): the ragged pipeline.
  compress_device_sharded_gathered  the same input; the record rows are
      gathered to every rank, and one place_records on each builds the
      whole frame.
  decompress_sharded                every rank passes the whole frame; a
      frame whose full superblocks are all METHOD_BLOCK decodes its share
      on each rank (the native parse, one K2 launch), the decoded bytes
      all-gathered; any other frame takes the single-device path.

The device frames equal engine.compress_frame_device of the whole input,
and so stenos_tpu's compress_frame_device_jit. Counterpart of
stenos_tpu/parallel/api.py. A kernel, a native parse or a collective that
fails raises: nothing here falls back to another route.
"""

import numpy as np
import torch

from ..constants import ERROR_INVALID_INPUT
from ..engine import (CHUNK_BYTES, TorchEngine, _block_records, _to_device,
                      frame_header_bytes, prepare_blocks)
from ..host.staging import Staging, put
from ..ops.decode_kernel import decode_rows
from ..ops.encode_kernel import (encode_superblocks,
                                 encode_superblocks_records, place_records)
from .sharding import (all_gather, assemble_frame_sharded, check_shares,
                       encode_segments_sharded, gather_encoded, gather_ints,
                       group_of, rank_device)


def compress_device_sharded(local, bpp: int, level: int = 1, mesh=None):
    """The ragged pipeline. local: this rank's (n_local, sb) uint8 tensor
    on its device, every rank holding n_local superblocks of the
    (nd * n_local, sb) whole, in rank order (ValueError otherwise).

    Returns (shard, total): this rank's frame bytes [t*S, min((t+1)*S,
    total)) with S = ceil(total / nd), on its device; concatenated in rank
    order, the shards are the frame of compress_frame_device on the whole
    input, total bytes long."""
    group = group_of(mesh)
    n_local, sb = local.shape
    hdr = frame_header_bytes(n_local * group.size() * sb, sb, bpp, level)
    seg, lens = encode_segments_sharded(group, local, bpp,
                                        2 if level else 0, hdr)
    return assemble_frame_sharded(group, seg, lens), int(lens.sum())


def compress_device_sharded_gathered(local, bpp: int, level: int = 1,
                                     mesh=None):
    """The gathered variant: this rank's superblocks encoded into record
    rows (K1), one all-gather of the rows to every rank (each record's
    length is in its header), then one place_records on every rank.
    Returns (frame, length): the whole frame, frame[:length], the same on
    every rank, on this rank's device."""
    group = group_of(mesh)
    n_local, sb = local.shape
    check_shares(group, n_local, local.device)
    rows = encode_superblocks_records(local, bpp, 2 if level else 0)[0]
    rows = all_gather(rows, group).to(local.device)
    hdr = rows[:, 1:4].to(torch.int32)
    totals = hdr[:, 0] | hdr[:, 1] << 8 | hdr[:, 2] << 16
    frame, length = place_records(
        rows, totals, frame_header_bytes(rows.shape[0] * sb, sb, bpp, level),
        sb // (256 * bpp), bpp)
    return frame, int(length)


class ShardedEngine(TorchEngine):
    """The frame layer's engine with the batched encode split over the
    ranks of a mesh: each rank encodes its share, ceil(n_full / nd), of
    the full superblocks (the last share zero-padded) on its own device,
    in rounds of CHUNK_BYTES, and gather_encoded brings every rank's
    streams and sizes to every rank after each round. Every rank makes the
    same number of rounds, so the collectives line up. Method selection,
    the LZ patch-up, the partial tail and the zstd stage are
    TorchEngine's, on this rank's device."""

    def __init__(self, mesh=None, device=None):
        super().__init__(rank_device(device))
        self.group = group_of(mesh)

    def encode_batch(self, data, bpp: int, sb: int, block_level: int = 2):
        nbytes = len(data)
        n_sb = -(-nbytes // sb)
        n_full = nbytes // sb
        if n_full == 0 or sb % (256 * bpp):
            return [None] * n_sb
        nd, rank = self.group.size(), self.group.rank()
        share = -(-n_full // nd)
        per_call = max(1, CHUNK_BYTES // sb)
        pre = [None] * n_sb
        for k in range(0, share, per_call):
            m = min(per_call, share - k)
            lo = min(rank * share + k, n_full)
            hi = min(rank * share + k + m, n_full)
            batch = np.asarray(data[lo * sb : hi * sb]).reshape(hi - lo, sb)
            if hi - lo < m:
                batch = np.concatenate(
                    [batch, np.zeros((m - (hi - lo), sb), np.uint8)])
            with self.lock:
                streams, totals, bsizes, fsizes = gather_encoded(
                    self.group, *encode_superblocks(
                        _to_device(batch, self.device), bpp, block_level))
            for i in range(nd * m):
                g = i // m * share + k + i % m
                if g < n_full:
                    pre[g] = (streams[i], int(totals[i]), bsizes[i],
                              fsizes[i])
        return pre


def compress_sharded(data, bpp: int, level: int = 1, mesh=None,
                     entropy=None, device=None) -> bytes:
    """Whole-input sharded compress: collective, every rank passes the same
    data (bytes or a 1-D uint8 array) and gets the same frame, equal to the
    single-device frame. The frame layer runs with a ShardedEngine on
    this rank's device (`device`, else the current CUDA device); level 0
    is the host memcpy frame, with no device work."""
    from .. import frame as fr

    if isinstance(data, (bytes, bytearray, memoryview)):
        data = np.frombuffer(bytes(data), np.uint8)
    data = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    if level == 0:
        return fr.compress(data, bpp, level)
    return fr.compress(data, bpp, level, engine=ShardedEngine(mesh, device),
                       entropy=entropy)


def decompress_sharded(frame, bpp: int, mesh=None, device=None):
    """Whole-frame sharded decompress: collective, every rank passes the
    same frame and gets the same uint8 numpy array. A frame whose full
    superblocks are all METHOD_BLOCK decodes on the mesh
    (_decode_frame_sharded); any other goes to frame.decompress with
    engine="auto"'s choice made on this rank's device."""
    from .. import frame as fr

    frame = (np.frombuffer(bytes(frame), np.uint8)
             if not isinstance(frame, np.ndarray)
             else np.ascontiguousarray(frame).view(np.uint8).reshape(-1))
    dev = rank_device(device)
    out = _decode_frame_sharded(frame, bpp, group_of(mesh), dev)
    if out is not None:
        return out
    engine = (TorchEngine(dev) if len(frame) >= fr.AUTO_DECOMPRESS_BYTES
              else None)
    return fr.decompress(frame, bpp, engine=engine)


def _decode_frame_sharded(frame: np.ndarray, bpp: int, group, dev):
    """The mesh decode of an all-METHOD_BLOCK frame, or None (on every
    rank alike) for a frame it does not take: another method on a full
    superblock, a record past the frame's end, or a superblock some rank's
    native parse rejects. Rank t parses superblocks [t*share,
    (t+1)*share), share = ceil(n_sb / nd), and decodes them with one K2
    launch; the shares, zero-padded to share superblocks, are all-gathered
    on the group's device and copied to the host once. A short final
    superblock is decoded on the host (decompress_superblock)."""
    from .. import frame as fr

    found = _block_records(frame, bpp, tail=True)
    if found is None:
        return None
    sb, items = found
    dsize_total = fr.get_info(frame[:12].tobytes(), bpp)[0]
    n_sb = dsize_total // sb
    tail = items[n_sb:]
    nd, rank = group.size(), group.rank()
    share = -(-n_sb // nd)
    mine = items[rank * share : min((rank + 1) * share, n_sb)]
    prep = (prepare_blocks(frame, mine, bpp, sb, Staging(dev)) if mine
            else {"n_ok": 0})
    if gather_ints([len(mine) - prep["n_ok"]], group, dev).any():
        return None
    if mine:
        words = decode_rows(*[a.to(dev, non_blocking=True)
                              for a in prep["args"]], bpp, sb // (256 * bpp))
    else:
        words = torch.empty((0, sb), dtype=torch.uint8, device=dev)
    if len(mine) < share:  # equal shapes for the gather
        words = torch.cat([words, words.new_zeros((share - len(mine), sb))])
    out = np.empty(dsize_total, np.uint8)
    dec = all_gather(words, group)[:n_sb].view(-1)
    if dec.device.type == "cuda":  # one copy down, into a pinned buffer
        dec = Staging(dev).get("decoded", dec.numel()).copy_(dec)
    put(out, [0, 0, n_sb * sb], dec.numpy())  # page faults: on threads
    if tail:
        code, p, csize, w = tail[0]
        r = fr.decompress_superblock(code, frame[p : p + csize], bpp,
                                     dsize_total - w)
        if len(r) != dsize_total - w:
            raise fr.StenosError(ERROR_INVALID_INPUT)
        out[w:] = r
    return out
