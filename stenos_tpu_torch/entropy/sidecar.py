"""Decode-anchor sidecar: a zstd SKIPPABLE frame appended to device-encoded
entropy payloads (the port's copy of stenos_tpu/entropy/sidecar.py).

The zstd literals bitstream is sequential; the anchored decode kernel
(huff_decode_kernel.py) needs per-segment anchors. Anchors and code lengths
ride a skippable frame (magic 0x184D2A5C) appended AFTER the real zstd
frame: libzstd and the C++ reference decode the concatenation unchanged,
while device_decode.py reads the sidecar and decodes on the card.

Layout (little-endian):
  u32 magic = 0x184D2A5C
  u32 payload size
  u8  version = 1
  u24 n_blocks
  per block:
    u8 flag        1 = device-decodable (compressed literals, 0 sequences,
                   regenerated == 131072); 0 = opaque (host decode)
    if flag == 1:
      128 B  code lengths as nibbles (len[2i] | len[2i+1] << 4, <= 11)
      4 x [u32 total_bits, 255 x u16 segment bit-deltas]   (per stream)

Cost: 2185 B per 128 KiB block = 1.67%.
"""

import numpy as np

MAGIC = 0x184D2A5C
SEGS = 256


def pack_sidecar(entries) -> bytes:
    """entries: list over blocks of None (opaque) or (lens (256,) int,
    anchors (4, 256) int — descending read positions per stream)."""
    body = bytearray()
    body.append(1)
    body += len(entries).to_bytes(3, "little")
    for e in entries:
        if e is None:
            body.append(0)
            continue
        lens, anchors = e
        body.append(1)
        lens = np.asarray(lens, np.uint8)
        body += bytes((lens[0::2] | (lens[1::2] << 4)).tobytes())
        anchors = np.asarray(anchors, np.int64).reshape(4, SEGS)
        for s in range(4):
            a = anchors[s]
            body += int(a[0]).to_bytes(4, "little")
            deltas = (a[:-1] - a[1:]).astype("<u2")
            body += deltas.tobytes()
    return MAGIC.to_bytes(4, "little") + len(body).to_bytes(4, "little") \
        + bytes(body)


def split_sidecar(payload: bytes):
    """payload = [zstd frame][sidecar?] -> (frame_end, entries or None).

    The sidecar is found from the END (fixed-size scan: its length field),
    so the zstd frame needn't be walked."""
    n = len(payload)
    if n < 9:
        return n, None
    # the sidecar is the LAST thing in the payload; find the last MAGIC
    # whose length field lands exactly on the payload end
    magic = MAGIC.to_bytes(4, "little")
    pos = payload.rfind(magic)
    while pos != -1:
        if pos + 8 <= n:
            size = int.from_bytes(payload[pos + 4 : pos + 8], "little")
            if pos + 8 + size == n and size >= 4 and payload[pos + 8] == 1:
                return pos, _parse_entries(payload[pos + 9 : n])
        pos = payload.rfind(magic, 0, pos)
    return n, None


def _parse_entries(body: bytes):
    nb = int.from_bytes(body[0:3], "little")
    entries = []
    p = 3
    for _ in range(nb):
        if p >= len(body):
            return None
        flag = body[p]
        p += 1
        if flag == 0:
            entries.append(None)
            continue
        if p + 128 + 4 * (4 + 510) > len(body):
            return None
        nib = np.frombuffer(body[p : p + 128], np.uint8)
        lens = np.zeros(256, np.int32)
        lens[0::2] = nib & 15
        lens[1::2] = nib >> 4
        p += 128
        anchors = np.zeros((4, SEGS), np.int64)
        for s in range(4):
            total = int.from_bytes(body[p : p + 4], "little")
            deltas = np.frombuffer(body[p + 4 : p + 4 + 510], "<u2")
            a = np.zeros(SEGS, np.int64)
            a[0] = total
            a[1:] = total - np.cumsum(deltas.astype(np.int64))
            anchors[s] = a
            p += 4 + 510
        entries.append((lens, anchors))
    return entries
