"""stenos-tpu-torch: the stenos block codec on PyTorch and hand-written CUDA
kernels for NVIDIA Hopper, format-compatible with the C++ `stenos` library
and byte-identical to the `stenos_tpu` package it is ported from.

`compress` / `decompress` run on the CUDA card by default (a TorchEngine on
"cuda"; they raise when there is none), and so do `Context` and
`CompressedArray`. `compress(..., entropy="device")` runs the zstd stage's
entropy coder on the card, and `decompress` decodes zstd payloads there,
libzstd's included. `device="cpu"` runs the same engine on the CPU through
the kernels' plain torch versions; `engine=None` takes the numpy host path,
the parity oracle; `engine="auto"` takes the card for inputs of 4 MiB (a
frame of 1 MiB) and more and the host path below. `compress(...,
threads=n)` compresses superblocks on n host threads.

`Context` drives `compress_generic` / `decompress_generic`, the
time-limited mode (`max_nanoseconds`) included; `CompressedArray` is the
cvector equivalent, one superblock record a chunk; `Timer` is stenos_timer.

`compress_sharded` / `decompress_sharded` (and `mesh=` on `compress` and
`decompress`) split the work over the ranks of a torch.distributed mesh,
NCCL between cards or gloo between CPU processes (parallel/); every rank
gets the single-device frame or array.

`DeviceCompressedArray` keeps an array compressed in device memory, with an
optional Huffman entropy stage (entropy=True), and decodes slabs on demand; `engine.roundtrip_device` and
`engine.compress_frame_device` are the device-resident round trip and frame
compress, and `engine.compress_frames_device` compresses a batch of images
on the card, a frame each, in one launch.
"""

from .constants import compress_bound, super_block_size
from .container import CompressedArray
from .context import Context
from .device_container import DeviceCompressedArray
from .engine import DEFAULT as _DEFAULT
from .engine import resolve as _engine
from .frame import StenosError, compress_generic, decompress_generic, get_info
from .utils import trace as _trace
from .utils.timer import Timer
from . import frame as _frame

__version__ = "0.1.0"


def default_engine(device=None):
    """The engine the entry points use: a TorchEngine on `device`
    ("cuda" unless given). Raises when CUDA is asked for and absent."""
    return _engine(_DEFAULT, device)


def compress(data, bytesoftype: int, level: int = 1, dst_size=None,
             engine=_DEFAULT, device=None, custom_shift=None,
             entropy=None, threads: int = 1, mesh=None) -> bytes:
    """stenos_compress: data (bytes or 1-D uint8 array) -> frame bytes.
    entropy="device" runs the zstd stage's entropy coder on the engine's
    device instead of host libzstd; threads > 1 compresses superblocks on
    that many host threads (a valid frame that may differ from the 1-thread
    one, as in the reference). mesh= (a torch.distributed DeviceMesh or
    ProcessGroup) compresses collectively over its ranks, each on its
    `device` (the current CUDA device unless given): compress_sharded."""
    if mesh is not None:
        return _frame.compress(data, bytesoftype, level, entropy=entropy,
                               device=device, mesh=mesh)
    with _trace.span("stn.compress", nbytes=len(data)):
        return _frame.compress(data, bytesoftype, level, dst_size,
                               engine=_engine(engine, device),
                               custom_shift=custom_shift, entropy=entropy,
                               threads=threads)


def decompress(frame, bytesoftype: int, dst_size=None, engine=_DEFAULT,
               device=None, mesh=None):
    """stenos_decompress: frame bytes -> uint8 numpy array. mesh= decodes
    collectively over its ranks, each on its `device` (the current CUDA
    device unless given): decompress_sharded."""
    if mesh is not None:
        return _frame.decompress(frame, bytesoftype, dst_size, mesh=mesh,
                                 device=device)
    with _trace.span("stn.decompress", nbytes=len(frame)):
        return _frame.decompress(frame, bytesoftype, dst_size,
                                 engine=_engine(engine, device))


def compress_sharded(data, bytesoftype: int, level: int = 1, mesh=None,
                     entropy=None, device=None) -> bytes:
    """Multi-device frame compression over a torch.distributed mesh (see
    parallel/api.py); also reachable as compress(..., mesh=mesh)."""
    from .parallel.api import compress_sharded as _cs

    return _cs(data, bytesoftype, level, mesh, entropy=entropy,
               device=device)


def decompress_sharded(frame, bytesoftype: int, mesh=None, device=None):
    """Multi-device frame decompression over a torch.distributed mesh (see
    parallel/api.py); also reachable as decompress(..., mesh=mesh)."""
    from .parallel.api import decompress_sharded as _ds

    return _ds(frame, bytesoftype, mesh, device=device)


def has_error(code) -> bool:
    """stenos_has_error parity: negative size results are error codes."""
    try:
        return int(code) < 0
    except (TypeError, ValueError):
        return isinstance(code, StenosError)


__all__ = [
    "CompressedArray",
    "Context",
    "compress",
    "compress_generic",
    "compress_sharded",
    "decompress",
    "decompress_generic",
    "decompress_sharded",
    "DeviceCompressedArray",
    "default_engine",
    "get_info",
    "has_error",
    "compress_bound",
    "super_block_size",
    "StenosError",
    "Timer",
    "__version__",
]
