"""Plain PyTorch reference of the stenos frame of a 1-D column of any length
whose every superblock is a METHOD_BLOCK record: the whole superblocks as
block_frame.py encodes them, then, when the length is no whole number of
superblocks, the short last one: its whole blocks through the same block
encode, the 0xFE marker and the partial segment of the bytes past them.

The partial segment is a plain copy of the C++ stenos library's partial
block encode (block_compress.h, as stenos_tpu_torch/codec/encode_np.py's
encode_partial): the block padded with its last byte and analysed without
RLE; with at least one whole line of 16 elements, the planes' code nibbles
(ALL_SAME 0, else NORMAL 2), then each plane's first byte (ALL_SAME) or the
headers of its whole rows, their minimums (rows that are not raw) and the
rows themselves; then the bytes past the last whole line, raw. A short
superblock under 128 bytes takes the library's small-input route (ZSTD or
COPY) instead, which this reference does not cover: it raises.

It imports nothing of the port; block_frame.py is its only import.
"""

import torch

from reference.block_frame import (I32, analyze_planes, encode_streams,
                                   frame_header, pack16, superblock_params)

BLOCK_PARTIAL = 0xFE
SMALL_INPUT = 128


def encode_partial(tail, bpp: int):
    """The partial segment, without its marker, of tail (a 1-D uint8 tensor
    of 1 <= n < 256 * bpp bytes), as a 1-D uint8 tensor on its device."""
    rbytes = tail.numel()
    lines = rbytes // (16 * bpp)
    if not lines:
        return tail.clone()
    el = torch.cat([tail, tail[-1:].expand(256 * bpp - rbytes)]).view(
        256, bpp).to(I32)
    x = el.t().reshape(bpp, 16, 16)
    info = analyze_planes(x, el[0], False)
    codes = [0 if s else 2 for s in info["all_same"].tolist()] + [0]
    out = [codes[j] | (codes[j + 1] << 4) for j in range(0, bpp, 2)]
    heads, mins = info["headers"].tolist(), info["minbytes"].tolist()
    xs, ds = x.tolist(), info["deltas"].tolist()
    for p in range(bpp):
        if codes[p] == 0:
            out.append(xs[p][0][0])
            continue
        h = heads[p][:lines] + [0]
        out += [h[r] | (h[r + 1] << 4) for r in range(0, lines, 2)]
        out += [mins[p][r] for r in range(lines) if h[r] != 15]
        for r in range(lines):
            if h[r] == 15:
                out += xs[p][r]
            elif h[r] & 7:
                sub = xs[p][r] if h[r] < 8 else ds[p][r]
                v = torch.tensor([(s - mins[p][r]) & 255 for s in sub],
                                 dtype=I32)
                out += pack16(v, h[r] & 7).tolist()
    out += tail[lines * 16 * bpp :].tolist()
    return torch.tensor(out, dtype=torch.uint8, device=tail.device)


def _records(streams, totals):
    """[1, csize u24 LE, stream] of each row, back to back."""
    hdr4 = torch.stack([torch.ones_like(totals), totals & 255,
                        (totals >> 8) & 255, (totals >> 16) & 255],
                       -1).to(torch.uint8)
    rec = torch.cat([hdr4, streams], -1)
    keep = (torch.arange(rec.shape[1], device=rec.device)
            < (totals + 4)[:, None])
    return rec[keep]


def column_frame(data, bpp: int, level: int, block_level: int = 2,
                 rows_per_step: int = 256):
    """The frame of data (a 1-D uint8 tensor) with the level's superblocks,
    every one a METHOD_BLOCK record encoded at block_level, as a 1-D uint8
    tensor on data's device. Whole superblocks are encoded rows_per_step at
    a time, so that the intermediates stay a few GiB at most."""
    nbytes = data.numel()
    sb = superblock_params(bpp, nbytes, level)[0]
    n_full, r = divmod(nbytes, sb)
    if 0 < r < SMALL_INPUT:
        raise ValueError(f"a short superblock of {r} bytes takes the "
                         "small-input route, which this reference lacks")
    dev = data.device
    parts = [torch.tensor(list(frame_header(nbytes, bpp, level)),
                          dtype=torch.uint8, device=dev)]
    for i in range(0, n_full, rows_per_step):
        rows = data[i * sb : min(n_full, i + rows_per_step) * sb].view(-1, sb)
        parts.append(_records(*encode_streams(rows, bpp, block_level)))
    if r:
        blk = 256 * bpp
        nbs = r // blk
        tail = data[n_full * sb :]
        stream = torch.zeros(0, dtype=torch.uint8, device=dev)
        if nbs:
            streams, totals = encode_streams(tail[: nbs * blk].view(1, -1),
                                             bpp, block_level)
            stream = streams[0, : int(totals[0])]
        if r % blk:
            stream = torch.cat([
                stream, torch.full((1,), BLOCK_PARTIAL, dtype=torch.uint8,
                                   device=dev),
                encode_partial(tail[nbs * blk :], bpp)])
        parts.append(_records(stream[None], torch.tensor(
            [stream.numel()], dtype=I32, device=dev)))
    return torch.cat(parts)
