"""Chunk-data-parallel compression over a group of ranks (torch.distributed).

The reference's only parallelism is a host thread pool over independent
superblocks (tiny_pool.h, stenos.cpp:909-1016). Here superblocks are split
over the ranks of a process group, one rank a device: each rank encodes
its own contiguous share of superblocks with the block-codec kernel (K1),
and the variable-length results are combined with collectives: an
all-gather of the compressed sizes replaces the reference's serial offset
walk, and the bytes move once, with all_gather or all_to_all_single.

SPMD: every rank calls each function here with its own share (a tensor on
its own device) and the same other arguments, in the same order. A `mesh`
is a 1-D DeviceMesh (make_mesh) or a ProcessGroup; None is the default
group. The collective buffers live on the group's device: the rank's card
under NCCL, the host under gloo (which takes no CUDA tensor for
all_gather or all_to_all), so two gloo ranks may still launch their
kernels on a card. Results come back on the input's device.

Counterpart of stenos_tpu/parallel/sharding.py. The ragged frame pipeline
(encode_segments_sharded, assemble_frame_sharded) writes each rank's
segment with two kernel launches instead of a per-superblock copy loop,
and moves each frame byte at most once with all_to_all_single instead of
a reduce-scatter of zero-filled, bucketed contributions.
"""

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.decode_kernel import decode_rows
from ..ops.encode_kernel import (encode_superblocks,
                                 encode_superblocks_frame,
                                 encode_superblocks_records)


def make_mesh(n_devices: int | None = None, axis: str = "chunks"):
    """A 1-D DeviceMesh over the first n_devices ranks of the initialized
    default group (all of them when None). Collective: every rank of the
    default group calls it. Its device type follows the group's backend:
    "cuda" under NCCL, "cpu" under gloo. Raises when no process group is
    initialized."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialized "
                           "(call init_process_group first)")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh: {n} devices of a world of {world}")
    return DeviceMesh(_device_type(dist.get_backend()), list(range(n)),
                      mesh_dim_names=(axis,))


def _device_type(backend: str) -> str:
    if backend == "nccl":
        return "cuda"
    if backend == "gloo":
        return "cpu"
    raise ValueError(f"unsupported torch.distributed backend {backend!r} "
                     "(nccl or gloo)")


def group_of(mesh):
    """The ProcessGroup of a mesh argument: a 1-D DeviceMesh's group, a
    ProcessGroup itself, or the default group for None."""
    if mesh is None:
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized (call "
                               "init_process_group first, or pass a mesh)")
        return dist.group.WORLD
    if isinstance(mesh, DeviceMesh):
        if mesh.ndim != 1:
            raise ValueError(f"need a 1-D mesh, not {mesh.ndim}-D")
        return mesh.get_group()
    if isinstance(mesh, dist.ProcessGroup):
        return mesh
    raise TypeError(f"mesh: a DeviceMesh or a ProcessGroup, not "
                    f"{type(mesh).__name__}")


def rank_device(device=None) -> torch.device:
    """This rank's device: `device` when given, else the current CUDA
    device (set by the caller with torch.cuda.set_device). Raises when
    CUDA is asked for and absent."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available (pass device='cpu' to run "
                           "the plain versions on the CPU)")
    return torch.device("cuda", torch.cuda.current_device())


def coll_device(group, device) -> torch.device:
    """Where the group's collective buffers live: the host under gloo,
    `device` (the rank's card) under NCCL."""
    if _device_type(dist.get_backend(group)) == "cpu":
        return torch.device("cpu")
    return torch.device(device)


def stage(t: torch.Tensor, group) -> torch.Tensor:
    """t on the group's collective device (coll_device)."""
    return t.to(coll_device(group, t.device))


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' equal-shape tensors t stacked along dim 0, in rank order,
    on the group's device (one all_gather_into_tensor)."""
    t = stage(t, group).contiguous()
    out = torch.empty((group.size() * t.shape[0], *t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def gather_ints(values, group, device) -> np.ndarray:
    """(nd, len(values)) int64 on the host: every rank's values (Python
    ints or 0-d tensors on `device`), one all-gather."""
    t = torch.stack([torch.as_tensor(v, dtype=torch.int64, device=device)
                     for v in values])
    return all_gather(t[None], group).cpu().numpy()


def check_shares(group, n_local: int, device) -> None:
    """Raise ValueError on every rank unless all ranks hold n_local
    superblocks (a tensor sharded over the mesh has equal shards: the JAX
    package's n_sb must be a multiple of the mesh size)."""
    _check_equal(gather_ints([n_local], group, device)[:, 0], group.size())


def _check_equal(shares, nd: int) -> None:
    if len(set(shares.tolist())) > 1:
        raise ValueError(f"n_sb={int(shares.sum())} not a multiple of mesh "
                         f"size {nd} split evenly (shares {shares.tolist()})")


def encode_superblocks_sharded(mesh, local, bpp: int, block_level: int = 2):
    """This rank's share (n_local, sb) encoded by K1's streams mode
    (encode_superblocks_body's outputs): (streams, totals, bsizes, fsizes)
    of its superblocks, on its device. Every rank holds n_local
    superblocks."""
    check_shares(group_of(mesh), local.shape[0], local.device)
    return encode_superblocks(local, bpp, block_level)


def encode_slabs_sharded(mesh, local, bpp: int, block_level: int = 2):
    """This rank's share encoded into records [1, csize u24, stream] by
    K1's records mode (encode_slabs_body's outputs): (rows, totals, bsizes,
    fsizes), totals counting the 4 header bytes."""
    check_shares(group_of(mesh), local.shape[0], local.device)
    return encode_superblocks_records(local, bpp, block_level)


def decode_slabs_sharded(mesh, vbufs, plane_off, rowtab, bpp: int, nb: int):
    """K2 on this rank's parsed rows (the native row parse's vbufs,
    plane_off, rowtab, on its device): its (n_local, nb*256*bpp) decoded
    bytes. Every rank holds n_local rows."""
    check_shares(group_of(mesh), vbufs.shape[0], vbufs.device)
    return decode_rows(vbufs, plane_off, rowtab, bpp, nb)


def gather_encoded(group, streams, totals, bsizes, fsizes):
    """Every rank's encode outputs gathered in rank order, on the host as
    numpy arrays: (streams (nd*n, W), totals (nd*n,), bsizes, fsizes
    (nd*n, nb)), W the longest stream of any rank. Two collectives: the
    width (an all-reduce of one int64), then one all_gather_into_tensor of
    each rank's streams padded to W with its sizes behind them."""
    n, nb = bsizes.shape
    dev = streams.device
    w = torch.tensor([streams.shape[1]], device=coll_device(group, dev))
    dist.all_reduce(w, op=dist.ReduceOp.MAX, group=group)
    W = int(w)
    sizes = torch.cat([totals[:, None], bsizes, fsizes], 1).to(torch.int32)
    packed = torch.zeros((n, W + 4 * (1 + 2 * nb)), dtype=torch.uint8,
                         device=dev)
    packed[:, :streams.shape[1]] = streams
    packed[:, W:] = sizes.contiguous().view(torch.uint8)
    g = all_gather(packed, group).cpu()
    sz = g[:, W:].contiguous().view(torch.int32).numpy()
    return g[:, :W].numpy(), sz[:, 0], sz[:, 1:1 + nb], sz[:, 1 + nb:]


def sharded_compress_step(mesh, local, bpp: int):
    """One sharded compress step (the GATHERED variant): this rank's share
    encoded at block level 2, then every rank's streams and sizes gathered
    to every rank (gather_encoded). Returns (streams, totals, offsets) on
    the host, the same on every rank: offsets are each record's place in a
    frame with an 8-byte header, the exclusive prefix sum of totals + 4."""
    group = group_of(mesh)
    check_shares(group, local.shape[0], local.device)
    streams, totals, _, _ = gather_encoded(
        group, *encode_superblocks(local, bpp, 2))
    sizes = totals.astype(np.int64) + 4
    return streams, totals, 8 + np.cumsum(sizes) - sizes


def encode_segments_sharded(mesh, local, bpp: int, block_level: int = 2,
                            header: bytes = b""):
    """Phase 1 of the ragged pipeline: this rank's contiguous frame
    segment, its records back to back (one K1 launch), rank 0's behind
    `header` (the frame header; every other
    rank's header is empty). The only collective is an all-gather of the
    nd segment lengths (with each rank's share, checked equal).

    Returns (seg, seg_lens): seg the rank's (capacity,) uint8 segment on its
    device, zeros past its length; seg_lens (nd,) int64 numpy, the same on
    every rank."""
    group = group_of(mesh)
    seg, length = encode_superblocks_frame(
        local, bpp, block_level, header if group.rank() == 0 else b"")
    got = gather_ints([length, local.shape[0]], group, local.device)
    _check_equal(got[:, 1], group.size())
    return seg, got[:, 0]


def _overlap(a, b):
    return max(0, min(a[1], b[1]) - max(a[0], b[0]))


def assemble_frame_sharded(mesh, seg, seg_lens):
    """Phase 2 of the ragged pipeline: rank t ends up holding frame bytes
    [t*S, min((t+1)*S, total)), S = ceil(total / nd), total =
    sum(seg_lens). Each rank works out from the gathered lengths which
    bytes of its segment land in which rank's shard and sends them with
    one all_to_all_single: each frame byte crosses the wire at most once,
    and no zero padding does. Returns this rank's shard on seg's device."""
    group = group_of(mesh)
    nd, r = group.size(), group.rank()
    lens = [int(x) for x in seg_lens]
    offs = np.cumsum([0] + lens)
    total = int(offs[-1])
    S = -(-total // nd)
    shards = [(min(t * S, total), min((t + 1) * S, total)) for t in range(nd)]
    mine = (int(offs[r]), int(offs[r + 1]))
    send = [_overlap(mine, s) for s in shards]
    recv = [_overlap((int(offs[s]), int(offs[s + 1])), shards[r])
            for s in range(nd)]
    src = stage(seg[:lens[r]], group)
    out = torch.empty(sum(recv), dtype=torch.uint8, device=src.device)
    dist.all_to_all_single(out, src, output_split_sizes=recv,
                           input_split_sizes=send, group=group)
    return out.to(seg.device)


def ragged_traffic_model(n_sb: int, w: int, nd: int, S: int,
                         C_loc: int) -> dict:
    """Bytes each rank moves through the collectives of each path (an
    all-gather of a B-byte buffer brings (nd-1)/nd * B to each rank). The
    gathered path gathers padded rows of w bytes; the ragged path's
    all_to_all_single brings each rank its shard of S frame bytes, of which
    on average (nd-1)/nd come from other ranks, and its lengths gather 16
    bytes from each other rank (the int64 length and share). C_loc, the
    rank's segment, is the most a rank sends."""
    gathered = (nd - 1) / nd * (n_sb * w)
    ragged = (nd - 1) / nd * S + 16 * (nd - 1)
    return {
        "gathered_per_chip_bytes": int(gathered),
        "ragged_per_chip_bytes": int(ragged),
        "ratio": round(gathered / max(ragged, 1), 3),
        "padded_rows_bytes": n_sb * w,
        "frame_shards_bytes": nd * S,
        "local_segment_bytes": C_loc,
    }
