"""stenos-tpu-torch: the stenos block codec on PyTorch and hand-written CUDA
kernels for NVIDIA Hopper, format-compatible with the C++ `stenos` library
and byte-identical to the `stenos_tpu` package it is ported from.

`compress` / `decompress` run on the CUDA card by default (a TorchEngine on
"cuda"; they raise when there is none). `compress(..., entropy="device")`
runs the zstd stage's entropy coder on the card, and `decompress` decodes
zstd payloads there, libzstd's included. `device="cpu"` runs the same engine
on the CPU through the kernels' plain torch versions; `engine=None` takes
the numpy host path, the parity oracle.

`DeviceCompressedArray` keeps an array compressed in device memory, with an
optional Huffman entropy stage (entropy=True), and decodes slabs on demand; `engine.roundtrip_device` and
`engine.compress_frame_device` are the device-resident round trip and frame
compress.
"""

from .constants import compress_bound, super_block_size
from .device_container import DeviceCompressedArray
from .frame import StenosError, get_info
from . import frame as _frame

__version__ = "0.1.0"

_DEFAULT = object()


def default_engine(device=None):
    """The engine the entry points use: a TorchEngine on `device`
    ("cuda" unless given). Raises when CUDA is asked for and absent."""
    from .engine import TorchEngine

    return TorchEngine("cuda" if device is None else device)


def _engine(engine, device):
    if engine is _DEFAULT:
        return default_engine(device)
    if device is not None:
        raise ValueError("pass either engine= or device=, not both")
    return engine


def compress(data, bytesoftype: int, level: int = 1, dst_size=None,
             engine=_DEFAULT, device=None, custom_shift=None,
             entropy=None) -> bytes:
    """stenos_compress: data (bytes or 1-D uint8 array) -> frame bytes.
    entropy="device" runs the zstd stage's entropy coder on the engine's
    device instead of host libzstd."""
    return _frame.compress(data, bytesoftype, level, dst_size,
                           engine=_engine(engine, device),
                           custom_shift=custom_shift, entropy=entropy)


def decompress(frame, bytesoftype: int, dst_size=None, engine=_DEFAULT,
               device=None):
    """stenos_decompress: frame bytes -> uint8 numpy array."""
    return _frame.decompress(frame, bytesoftype, dst_size,
                             engine=_engine(engine, device))


def has_error(code) -> bool:
    """stenos_has_error parity: negative size results are error codes."""
    try:
        return int(code) < 0
    except (TypeError, ValueError):
        return isinstance(code, StenosError)


__all__ = [
    "compress",
    "decompress",
    "DeviceCompressedArray",
    "default_engine",
    "get_info",
    "has_error",
    "compress_bound",
    "super_block_size",
    "StenosError",
    "__version__",
]
