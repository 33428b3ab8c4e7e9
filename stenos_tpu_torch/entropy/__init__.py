"""The entropy stages. The device container's Huffman stage: tables on the
host (huffman.py), the histogram and stream-encode kernels (huff_kernel.py)
and the anchored decode kernel (huff_decode_kernel.py). The zstd stage:
frames encoded with the card's help (zstd_frame.py, with match_device.py,
sidecar.py and the native block encoder), zstd payloads decoded on the card
(device_decode.py: the sequence decode kernel in seqdec_kernel.py and the
sequence executor in seq_exec.py), and the sequence-section encode kernel
(fse_kernel.py, with fse.py and sequences.py), an entry point of its own."""

from .zstd_frame import encode_frame_host  # noqa: F401
