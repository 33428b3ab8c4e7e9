"""The device container's entropy stage: Huffman tables on the host
(huffman.py), the histogram and stream-encode kernels (huff_kernel.py) and
the anchored decode kernel (huff_decode_kernel.py)."""
