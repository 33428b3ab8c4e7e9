"""zstd frame and block structural parser (host, O(headers)): the port's
copy of parse_frame and _parse_sections of stenos_tpu/entropy/zstd_parse.py.

Splits any zstd frame, this package's or libzstd's, into per-block literal
and sequence section descriptors without touching the bulk payload bytes,
which device_decode.py hands to the kernels. Format: RFC 8878 §3.1.1.
"""

from __future__ import annotations

import dataclasses

MAGIC = 0xFD2FB528


@dataclasses.dataclass
class LitSpec:
    kind: str          # "raw" | "rle" | "huf"
    regenerated: int
    off: int = 0       # raw/huf: byte offset into payload
    length: int = 0    # raw/huf: section byte length
    byte: int = 0      # rle fill byte
    four: bool = False     # huf: 4-stream layout
    treeless: bool = False  # huf: reuse previous block's table


@dataclasses.dataclass
class BlockSpec:
    btype: int          # 0 raw, 1 RLE, 2 compressed
    start: int          # payload offset of the block body
    size: int           # block body bytes (RLE: 1)
    rsize: int          # regenerated bytes (raw/RLE blocks)
    lit: LitSpec | None = None     # compressed blocks only
    seq_off: int = 0    # sequences section offset (compressed)
    seq_len: int = 0


def parse_frame(payload, end: int | None = None):
    """Walk one zstd frame's headers -> (content_size or None, [BlockSpec],
    frame_end). Returns None if the structure is not a lone zstd frame we
    understand (the caller asks host libzstd)."""
    payload = memoryview(payload)
    n = len(payload) if end is None else end
    if n < 5 or int.from_bytes(payload[:4], "little") != MAGIC:
        return None
    fhd = payload[4]
    p = 5
    dict_flag = fhd & 3
    checksum = (fhd >> 2) & 1
    single = (fhd >> 5) & 1
    fcs_code = fhd >> 6
    if dict_flag:
        return None  # dictionaries unsupported (the reference never uses them)
    if not single:
        p += 1  # window descriptor
    fcs_bytes = {0: 1 if single else 0, 1: 2, 2: 4, 3: 8}[fcs_code]
    content = None
    if fcs_bytes:
        if p + fcs_bytes > n:
            return None
        content = int.from_bytes(payload[p : p + fcs_bytes], "little")
        if fcs_bytes == 2:
            content += 256
        p += fcs_bytes
    blocks = []
    last = False
    while not last:
        if p + 3 > n:
            return None
        bh = int.from_bytes(payload[p : p + 3], "little")
        last = bool(bh & 1)
        btype = (bh >> 1) & 3
        bsize = bh >> 3
        p += 3
        if btype == 3:
            return None
        body = 1 if btype == 1 else bsize
        if p + body > n:
            return None
        rsize = bsize if btype != 2 else 0
        spec = BlockSpec(btype, p, body, rsize)
        if btype == 2:
            if _parse_sections(payload, spec) is None:
                return None
        blocks.append(spec)
        p += body
    if checksum:
        p += 4
    if p > n:
        return None
    return content, blocks, p


def _parse_sections(payload, spec: BlockSpec):
    """Fill lit/seq fields of a compressed block (RFC §3.1.1.3.1)."""
    p = spec.start
    end = spec.start + spec.size
    if p >= end:
        return None
    b0 = payload[p]
    ltype = b0 & 3
    sf = (b0 >> 2) & 3
    if ltype <= 1:  # Raw / RLE
        if sf == 0 or sf == 2:
            regen = b0 >> 3
            hlen = 1
        elif sf == 1:
            if p + 2 > end:
                return None
            regen = (b0 >> 4) | (payload[p + 1] << 4)
            hlen = 2
        else:
            if p + 3 > end:
                return None
            regen = (b0 >> 4) | (payload[p + 1] << 4) | (payload[p + 2] << 12)
            hlen = 3
        body = regen if ltype == 0 else 1
        if p + hlen + body > end:
            return None
        if ltype == 0:
            spec.lit = LitSpec("raw", regen, off=p + hlen, length=regen)
        else:
            spec.lit = LitSpec("rle", regen, byte=payload[p + hlen])
        p += hlen + body
    else:  # Compressed / Treeless
        if sf == 0 or sf == 1:
            if p + 3 > end:
                return None
            h = int.from_bytes(payload[p : p + 3], "little")
            regen = (h >> 4) & 0x3FF
            csize = (h >> 14) & 0x3FF
            hlen = 3
            four = sf == 1
        elif sf == 2:
            if p + 4 > end:
                return None
            h = int.from_bytes(payload[p : p + 4], "little")
            regen = (h >> 4) & 0x3FFF
            csize = (h >> 18) & 0x3FFF
            hlen = 4
            four = True
        else:
            if p + 5 > end:
                return None
            h = int.from_bytes(payload[p : p + 5], "little")
            regen = (h >> 4) & 0x3FFFF
            csize = (h >> 22) & 0x3FFFF
            hlen = 5
            four = True
        if p + hlen + csize > end:
            return None
        spec.lit = LitSpec("huf", regen, off=p + hlen, length=csize,
                           four=four, treeless=ltype == 3)
        p += hlen + csize
    spec.seq_off = p
    spec.seq_len = end - p
    return spec
