"""Decode-anchor sidecar: a zstd SKIPPABLE frame appended to device-encoded
entropy payloads (the port's copy of stenos_tpu/entropy/sidecar.py).

The zstd literals bitstream is sequential; the anchored decode kernel
(huff_decode_kernel.py) needs per-segment anchors. Anchors and code lengths
ride a skippable frame (magic 0x184D2A5C) appended AFTER the real zstd
frame: libzstd and the C++ reference decode the concatenation unchanged,
while the device decode's native host pass (stn_zstd_prep_batch, called by
device_decode.py) reads the sidecar and the card decodes.

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
