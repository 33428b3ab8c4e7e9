"""Format constants for the stenos frame/block codec.

See SPEC.md; derived from the C++ stenos library's stenos.h:57-84,
internal/block_compress.h:52-60 and internal/stenos.cpp:34-39.
"""

# Frame-level superblock methods (stenos.cpp:34-39)
METHOD_BLOCK = 1
METHOD_ZSTD = 2
METHOD_TRANSPOSED_ZSTD = 3
METHOD_TRANSPOSED_DELTA_ZSTD = 4
METHOD_BLOCK_ZSTD = 5
METHOD_COPY = 6

# Per-plane codes inside the block codec (block_compress.h:52-55)
PLANE_ALL_SAME = 0
PLANE_ALL_RAW = 1
PLANE_NORMAL = 2
PLANE_NORMAL_RLE = 3

# Whole-block escape markers (block_compress.h:58-60)
BLOCK_COPY = 252
BLOCK_LZ = 253
BLOCK_PARTIAL = 254

# Limits (stenos.h:57-65)
STENOS_BLOCK_SIZE = 131072
MAX_BLOCK_BYTES = (1 << 24) - 1
MAX_BYTESOFTYPE = MAX_BLOCK_BYTES // 256
NO_BLOCK_SHIFT = 2**64 - 1

# Error codes (stenos.h:75-84): returned as negative ints from the Python API
# internals and mapped to exceptions at the public boundary.
ERROR_UNDEFINED = -1
ERROR_SRC_OVERFLOW = -2
ERROR_ALLOC = -3
ERROR_INVALID_INPUT = -4
ERROR_INVALID_INSTRUCTION_SET = -5
ERROR_DST_OVERFLOW = -6
ERROR_INVALID_BYTESOFTYPE = -7
ERROR_ZSTD_INTERNAL = -8
ERROR_INVALID_PARAMETER = -9

# Per-block-level thresholds (block_compress.h:1110-1111)
RAW_DIFF = (25, 16, 0)  # plane goes ALL_RAW above 256 - diff[level]
LEVEL_METHODS_RLE = (False, True, True)  # RLE enabled per block level


def super_block_size(block_size: int) -> int:
    """Base superblock size for a 256-element block size (stenos.cpp:71-76)."""
    if block_size > STENOS_BLOCK_SIZE:
        return block_size
    return (STENOS_BLOCK_SIZE // block_size) * block_size


def compress_bound(nbytes: int) -> int:
    """Worst-case compressed size (stenos.h:36-42)."""
    min_sb = 65792
    count = nbytes // min_sb + (1 if nbytes % min_sb else 0)
    return 12 + max(count, 1) * 4 + nbytes
