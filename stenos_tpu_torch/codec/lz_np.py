"""Host implementation of the intra-block LZ encoder (SPEC.md 3.5).

Behavioral equivalent of lz_compress (lz_compress.h:192-277); LZ blocks
decode in the native runtime (stn_parse_rows inlines them).
The reference declares its 256-entry hash table UNINITIALIZED inside the
block loop (block_compress.h:1211) — in practice the stack slot carries the
previous block's table across iterations, so LZ attempts see candidates
seeded by earlier blocks of the SAME superblock. We reproduce that with an
explicit `table` argument the caller persists across a superblock's LZ
attempts (updates survive aborted attempts, exactly like the reference's
partial scans). Table start-of-superblock state is deterministic "empty"
(the reference's is leftover stack garbage, which in practice yields no
valid candidates — its exact block-0 bytes are irreproducible by design).
"""

import numpy as np

_EMPTY = 0xFFFF  # sentinel position: never satisfies `pos_stored < pos`


def fresh_table():
    """Per-superblock LZ hash table (persisted across that superblock's
    block loop by the caller, matching block_compress.h:1152-1223)."""
    return [_EMPTY] * 256


def lz_compress_block(block: np.ndarray, bpp: int, max_size: int,
                      table=None):
    """Compress one 256-element block (raw, unshuffled bytes).

    table: the persistent per-superblock hash table (fresh_table());
    mutated in place, including by aborted attempts. None = fresh.
    Returns the payload bytes or None on budget failure (mirrors the nullptr
    returns of lz_compress, incl. the 0.4*budget early stop at i > count/4).
    """
    if bpp % 8 == 0:
        B = 8
    elif bpp % 4 == 0 or bpp <= 2:
        B = 4
    else:
        return None
    if bpp > 512:
        return None
    data = block.tobytes()
    count = (256 * bpp) // B
    if B == 4:
        vals = np.frombuffer(data, dtype="<u4")
        hashes = ((vals.astype(np.uint64) * 2654435761) & 0xFFFFFFFF) & 255
    else:
        vals = np.frombuffer(data, dtype="<u8")
        hashes = (
            (vals.astype(object) * 14313749767032793493)
            % (1 << 64)
        ) >> 56
    vals = vals.tolist()
    hashes = [int(h) for h in hashes]

    if table is None:
        table = fresh_table()
    out = bytearray()
    failed = 0
    max_failed = 3
    once = False

    for i in range(0, count, 8):
        anchor_pos = len(out)
        out.append(0)
        if failed == max_failed:
            failed = 0
            max_failed -= 1
            if max_failed == 0:
                max_failed = 1
            out += data[i * B : (i + 8) * B]
        else:
            anchor = 0
            for j in range(8):
                pos = i + j
                h = hashes[pos]
                stored = table[h]
                if stored < pos and vals[stored] == vals[pos]:
                    diff = pos - stored
                    if diff < 128:
                        out.append(diff)
                    else:
                        out.append((diff & 127) | 128)
                        out.append(diff >> 7)
                    anchor |= 1 << j
                else:
                    out += data[pos * B : (pos + 1) * B]
                table[h] = pos
            out[anchor_pos] = anchor
            failed += anchor == 0
        produced = len(out)
        if produced > max_size:
            return None
        if not once and i > count // 4:
            if produced > max_size * 0.4:
                return None
            once = True
    return bytes(out)
