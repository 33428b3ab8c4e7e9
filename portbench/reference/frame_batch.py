"""Plain PyTorch reference of a batch of stenos frames, one an image, as
stenos_tpu_torch.engine.compress_frames_device lays them out: image f's
frame is block_frame.py's frame of its superblocks (every superblock a
METHOD_BLOCK record), in row f of the output, zeros after it up to the
row's stride (the frame's capacity, its header and a record bound a
superblock, rounded up to a multiple of 16 bytes).

It imports nothing of the port; block_frame.py is its only import.
"""

import torch

from reference.block_frame import block_frame, frame_header, superblock_params


def record_bound(nb: int, bpp: int) -> int:
    """The longest record [1, csize u24, stream] of nb blocks: a block is at
    most (bpp + 1) // 2 header bytes and 256 * bpp raw bytes."""
    return 4 + nb * ((bpp + 1) // 2 + 256 * bpp)


def frame_batch(frames, bpp: int, level: int, block_level: int = 2):
    """(out (F, stride) uint8, lengths (F,) int64) of frames, a (F, n) uint8
    tensor of F images of n bytes, n a whole number of the level's
    superblocks, on frames' device: out[f, :lengths[f]] is image f's frame
    encoded at block_level, zeros follow."""
    n_frames, n = frames.shape
    sb = superblock_params(bpp, n, level)[0]
    if n % sb:
        raise ValueError(f"a frame of {n} bytes is no whole number of "
                         f"{sb}-byte superblocks")
    n_sb = n // sb
    hlen = len(frame_header(n, bpp, level))
    cap = hlen + n_sb * record_bound(sb // (256 * bpp), bpp)
    stride = -(-cap // 16) * 16
    out = torch.zeros((n_frames, stride), dtype=torch.uint8,
                      device=frames.device)
    lengths = []
    for f in range(n_frames):
        frame = block_frame(frames[f].view(n_sb, sb), bpp, level, block_level)
        out[f, : frame.numel()] = frame
        lengths.append(frame.numel())
    return out, torch.tensor(lengths, dtype=torch.int64, device=frames.device)
