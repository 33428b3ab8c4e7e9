"""Huffman histogram and stream encode: the CUDA kernels and their plain
torch versions.

histogram(blocks) is the byte histogram of 128 KiB blocks: a CUDA tensor
goes through csrc/huff_encode.cu (it replaces the TPU kernel in
stenos_tpu/entropy/huff_pallas.py::_hist_call), a CPU tensor through
histogram_plain.

  blocks (nblk, BLOCK) uint8 -> (nblk, 256) int32 counts

encode_streams(streams, luts, with_anchors) is the huff0 literal encode of
32 KiB streams (it replaces huff_pallas.py::make_stream_kernel; plain
version encode_streams_plain). Symbols are emitted last first: natural index
i sits at emission position STREAM - 1 - i, each as its code (luts: code |
len << 11, len <= 11 and code < 2^len, as luts_batch makes them) at the bit
offset given by the exclusive sum of the lengths in emission order,
little-endian in 32-bit words, and one end-mark bit follows the last code.

  streams (ns, STREAM) uint8, luts (ns, 256) int32 ->
  words   (ns, WOUT_WORDS) int32  the bitstream, zero past the end mark
  sizes   (ns,) int32             bytes of the bitstream, (total + 8) >> 3
  anchors (ns, 256) int32         (with_anchors) the bit read position of
                                  segment g's first symbol, natural index
                                  g*128: the inclusive sum of the lengths at
                                  emission index (255 - g)*128 + 127

Outputs lie on the input's device.
"""

import ctypes

import torch

from ..ops import _cuda

STREAM = 32768          # bytes per Huffman stream
BLOCK = 4 * STREAM      # a 128 KiB entropy block: four streams
WOUT_WORDS = 96 * 128   # words per encoded stream: >= 11 bits x STREAM + 1
SEGS = 256              # decode segments (anchors) per stream
SEG = STREAM // SEGS    # symbols per segment

# kernel launches (chip_smoke.py reads these)
launches_histogram = 0
launches_encode = 0

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {
    "stenos_huff_histogram": [_P, _LL, _P, _P],
    "stenos_huff_encode": [_P, _P, _LL, _P, _P, _P, _P],
}


def histogram_plain(blocks):
    """Plain torch version: (nblk, n) uint8 -> (nblk, 256) int32."""
    hist = torch.zeros((blocks.shape[0], 256), dtype=torch.int64,
                       device=blocks.device)
    hist.scatter_add_(1, blocks.long(), torch.ones_like(blocks,
                                                        dtype=torch.int64))
    return hist.to(torch.int32)


def encode_streams_plain(streams, luts, with_anchors: bool = False):
    """Plain torch version: each code's low part ORs into word off >> 5 and
    its high part, (code >> 1) >> (31 - (off & 31)), into the next; the bit
    ranges are disjoint, so the ORs are sums (scatter_add_ in int64)."""
    ns = streams.shape[0]
    dev = streams.device
    acc = torch.gather(luts.long(), 1, streams.flip(1).long())
    lens = acc >> 11
    code = acc & 2047
    incl = torch.cumsum(lens, 1)
    total = incl[:, -1]
    off = incl - lens
    sh = off & 31
    words = torch.zeros((ns, WOUT_WORDS + 1), dtype=torch.int64, device=dev)
    words.scatter_add_(1, off >> 5, (code << sh) & 0xFFFFFFFF)
    words.scatter_add_(1, (off >> 5) + 1, (code >> 1) >> (31 - sh))
    words.scatter_add_(1, (total >> 5)[:, None], (1 << (total & 31))[:, None])
    words = words[:, :WOUT_WORDS]
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    out = (words.to(torch.int32), ((total + 8) >> 3).to(torch.int32))
    if with_anchors:
        out += (incl[:, SEG - 1::SEG].flip(1).to(torch.int32),)
    return out


def _check(name, t, dtype, width):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype != dtype or t.dim() != 2 or t.shape[1] != width \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: need contiguous, 16-byte aligned "
                         f"(n, {width}) {dtype}, got {tuple(t.shape)} "
                         f"{t.dtype}")


def histogram(blocks):
    """The wrapper: the CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor (see the module docstring)."""
    global launches_histogram
    if blocks.device.type == "cpu":
        return histogram_plain(blocks)
    _check("histogram", blocks, torch.uint8, BLOCK)
    lib = _cuda.load("huff_encode", _SIGNATURES)
    hist = torch.empty((blocks.shape[0], 256), dtype=torch.int32,
                       device=blocks.device)
    if blocks.shape[0]:
        _cuda.check(lib.stenos_huff_histogram(
            blocks.data_ptr(), blocks.shape[0], hist.data_ptr(),
            torch.cuda.current_stream(blocks.device).cuda_stream),
            "huff_histogram")
        launches_histogram += 1
    return hist


def encode_streams(streams, luts, with_anchors: bool = False):
    """The wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors (see the module docstring)."""
    global launches_encode
    if streams.device.type == "cpu":
        return encode_streams_plain(streams, luts, with_anchors)
    _check("encode_streams", streams, torch.uint8, STREAM)
    _check("encode_streams", luts, torch.int32, 256)
    if luts.shape[0] != streams.shape[0] or luts.device != streams.device:
        raise ValueError("encode_streams: one LUT per stream, on its device")
    lib = _cuda.load("huff_encode", _SIGNATURES)
    ns = streams.shape[0]
    dev = streams.device
    words = torch.empty((ns, WOUT_WORDS), dtype=torch.int32, device=dev)
    sizes = torch.empty(ns, dtype=torch.int32, device=dev)
    anchors = torch.empty((ns, SEGS), dtype=torch.int32, device=dev)
    if ns:
        _cuda.check(lib.stenos_huff_encode(
            streams.data_ptr(), luts.data_ptr(), ns, words.data_ptr(),
            sizes.data_ptr(), anchors.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "huff_encode")
        launches_encode += 1
    return (words, sizes, anchors) if with_anchors else (words, sizes)
