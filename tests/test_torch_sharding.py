"""The port's sharding layer (stenos_tpu_torch.parallel, CPU) against the
JAX package: gloo worlds of 2 and 3 ranks, each rank a subprocess on the
CPU (device="cpu", the kernels' plain versions), must give on every rank
the bytes stenos_tpu gives on one device: compress(..., mesh=) frames,
the device frame of compress_device_sharded (its shards concatenated) and
of the gathered variant, the sharded encode's records and sizes, and
exact decompress(..., mesh=) output.

A world of 3 ranks splits shares that do not divide. Each world runs once
for the module (the `worlds` fixture): its ranks run every case and write
what each gives to files, which each test reads, so a process group never
lives in a test worker and the start-up is paid once a world. The world of
2 passes make_mesh()'s DeviceMesh, the world of 3 the default
ProcessGroup."""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from stenos_tpu import frame as ref_frame
from stenos_tpu.engine_jax import (compress_frame_device_jit,
                                   encode_superblocks_jit)
from stenos_tpu_torch import frame as port_frame
from stenos_tpu_torch.engine import TorchEngine
from stenos_tpu_torch.parallel import ragged_traffic_model

from conftest import gen_elements

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 3)
LEVELS = (1, 2, 5)
KINDS = ("sorted", "random", "rle")
BPP = 4
DEV_SB = 256 * BPP * 2  # the device-frame cases' superblock: 2 KiB
DEV_NSB = 16
DEC_BYTES = 6 * 131072 + 7000  # six superblocks and a partial tail
TIMEOUT_S = 240

_WORKER = r"""
import os, sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

rank, nd, port, work = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                        sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=nd, rank=rank,
                        timeout=timedelta(seconds=120))

import stenos_tpu_torch as stt
from stenos_tpu_torch import native, parallel as par
from stenos_tpu_torch.frame import StenosError
from stenos_tpu_torch.parallel.api import _decode_frame_sharded

mesh = par.make_mesh() if nd == 2 else dist.group.WORLD
inp = np.load(os.path.join(work, "inputs.npz"))
bpp = 4


def save(case, **out):
    np.savez(os.path.join(work, f"{case}.n{nd}.r{rank}.npz"), **out)


def expect_error(case, fn):
    # the expected errors are raised on every rank alike
    try:
        fn()
        save(case, error=np.array("none"))
    except (ValueError, StenosError) as e:
        save(case, error=np.array(type(e).__name__), msg=np.array(str(e)),
             code=np.array(getattr(e, "code", 0)))


def share(a, n):
    per = n // nd
    return torch.from_numpy(np.ascontiguousarray(a[rank * per:(rank + 1) * per]))


t = lambda x: x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

for level in (1, 2, 5):
    for kind in ("sorted", "random", "rle"):
        frame = stt.compress(inp[f"c{level}_{kind}"], bpp, level, mesh=mesh,
                             device="cpu")
        save(f"compress-{level}-{kind}",
             frame=np.frombuffer(frame, np.uint8))

batch = inp["dev_batch"]
n_use = len(batch) - len(batch) % nd
local = share(batch, n_use)
shard, total = par.compress_device_sharded(local, bpp, 1, mesh)
save("ragged", shard=t(shard), total=np.array(total))
frame, length = par.compress_device_sharded_gathered(local, bpp, 1, mesh)
save("gathered", frame=t(frame)[:length])
rows, totals, bsizes, fsizes = par.encode_slabs_sharded(mesh, local, bpp)
save("slabs", rows=t(rows), totals=t(totals), bsizes=t(bsizes),
     fsizes=t(fsizes))
streams, totals, bsizes, fsizes = par.encode_superblocks_sharded(
    mesh, local, bpp)
save("streams", streams=t(streams), totals=t(totals), bsizes=t(bsizes),
     fsizes=t(fsizes))
streams, totals, offsets = par.sharded_compress_step(mesh, local, bpp)
save("step", streams=streams, totals=totals, offsets=offsets)
seg, lens = par.encode_segments_sharded(mesh, local, bpp, 2,
                                        b"h" * 8 if rank == 0 else b"")
save("segments", seg=t(seg)[:lens[rank]], lens=lens)
m = par.ragged_traffic_model(n_use, rows.shape[1], nd, -(-total // nd),
                             int(lens[rank]))
save("traffic", ragged=np.array(m["ragged_per_chip_bytes"]),
     gathered=np.array(m["gathered_per_chip_bytes"]))

uneven = torch.from_numpy(batch[: 6 if rank == 0 else 5].copy())
expect_error("uneven", lambda: par.compress_device_sharded(uneven, bpp, 1,
                                                           mesh))
expect_error("uneven-gathered", lambda: par.compress_device_sharded_gathered(
    uneven, bpp, 1, mesh))

for level in (1, 2):
    frame = inp[f"d{level}"]
    save(f"decompress-{level}",
         out=stt.decompress(frame.tobytes(), bpp, mesh=mesh, device="cpu"),
         on_mesh=np.array(_decode_frame_sharded(
             frame, bpp, par.sharding.group_of(mesh), torch.device("cpu"))
             is not None))
save("decompress-mixed",
     out=stt.decompress(inp["mixed"].tobytes(), bpp, mesh=mesh, device="cpu"),
     on_mesh=np.array(_decode_frame_sharded(
         inp["mixed"], bpp, par.sharding.group_of(mesh), torch.device("cpu"))
         is not None))
for case in ("truncated", "corrupt"):
    expect_error(case, lambda: save(case + "-out", out=stt.decompress(
        inp[case].tobytes(), bpp, mesh=mesh, device="cpu")))
expect_error("overflow", lambda: stt.decompress(
    inp["d1"].tobytes(), bpp, dst_size=len(inp["dec_data"]) - 1, mesh=mesh,
    device="cpu"))

# the sharded K2 on this rank's share of the level-1 frame's parsed rows
sb = 131072
parsed = native.load().parse_rows_batch(
    inp["d1"].tobytes(), bpp, sb, inp["d1_offs"].tolist(),
    inp["d1_csizes"].tolist(), 65536)
n_full = len(inp["d1_offs"]) - len(inp["d1_offs"]) % nd
words = par.decode_slabs_sharded(
    mesh, *(share(a, n_full) for a in parsed[:3]), bpp, sb // (256 * bpp))
save("decode-slabs", words=t(words))
dist.destroy_process_group()
print(f"rank {rank} of {nd}: done", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _block_records(frame: bytes, bpp: int):
    """(offsets, csizes) of the payloads of a frame's full superblocks."""
    dsize, sb, pos = ref_frame.get_info(frame, bpp)
    offs, csizes = [], []
    for _ in range(dsize // sb):
        csize = int.from_bytes(frame[pos + 1 : pos + 4], "little")
        offs.append(pos + 4)
        csizes.append(csize)
        pos += 4 + csize
    return np.array(offs), np.array(csizes)


def _inputs():
    """Every case's input, from fixed seeds."""
    out = {}
    for i, (level, kind) in enumerate(
            (lv, k) for lv in LEVELS for k in KINDS):
        sb, _ = ref_frame._superblock_params(BPP, 1 << 22, level)
        out[f"c{level}_{kind}"] = np.frombuffer(gen_elements(
            np.random.default_rng(100 + i), BPP, (3 * sb + sb // 4) // BPP,
            kind), np.uint8)
    out["dev_batch"] = np.frombuffer(gen_elements(
        np.random.default_rng(7), BPP, DEV_NSB * DEV_SB // BPP, "sorted"),
        np.uint8).reshape(DEV_NSB, DEV_SB)
    data = gen_elements(np.random.default_rng(8), BPP, DEC_BYTES // BPP,
                        "sorted")
    out["dec_data"] = np.frombuffer(data, np.uint8)
    for level in (1, 2):
        out[f"d{level}"] = np.frombuffer(ref_frame.compress(data, BPP, level),
                                         np.uint8)
    out["d1_offs"], out["d1_csizes"] = _block_records(out["d1"].tobytes(),
                                                      BPP)
    # superblocks 3-5 random: a level-2 frame of several methods
    mixed = out["dec_data"].copy()
    mixed[3 * 131072 : 6 * 131072] = np.frombuffer(gen_elements(
        np.random.default_rng(9), BPP, 3 * 131072 // BPP, "random"), np.uint8)
    out["mixed_data"] = mixed
    out["mixed"] = np.frombuffer(ref_frame.compress(mixed.tobytes(), BPP, 2),
                                 np.uint8)
    out["truncated"] = out["d1"][: len(out["d1"]) * 2 // 3]
    corrupt = out["d1"].copy()
    p = int(out["d1_offs"][4])
    corrupt[p + 10 : p + 60] ^= 0x5A  # inside superblock 4's block stream
    out["corrupt"] = corrupt
    return out


class _World:
    """A gloo world of nd rank processes running _WORKER."""

    def __init__(self, nd, work):
        self.nd, self.work = nd, work
        port = _free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        self.logs = [os.path.join(work, f"log.n{nd}.r{r}") for r in range(nd)]
        self.procs = []
        for r, log in enumerate(self.logs):
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", _WORKER, str(r), str(nd),
                     str(port), work], cwd=ROOT, env=env, stdout=f,
                    stderr=subprocess.STDOUT))
        self.failed = None  # the first failing rank's log, once known

    def wait(self, deadline):
        """Wait for every rank (killing them at the deadline); every call
        fails while a rank failed, with its log."""
        if self.failed is None:
            try:
                for p in self.procs:
                    p.wait(timeout=max(1.0, deadline - time.monotonic()))
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            self.failed = ""
            for p, log in zip(self.procs, self.logs):
                if p.returncode and not self.failed:
                    with open(log) as f:
                        self.failed = f"{log}: rc {p.returncode}\n" + (
                            f.read()[-4000:])
        assert not self.failed, self.failed

    def out(self, case, rank):
        path = os.path.join(self.work, f"{case}.n{self.nd}.r{rank}.npz")
        return dict(np.load(path))


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, inputs):
    """Both worlds, started together; a test waits for its world."""
    work = str(tmp_path_factory.mktemp("sharding"))
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    ws = {nd: _World(nd, work) for nd in WORLDS}
    deadline = time.monotonic() + TIMEOUT_S

    def get(nd):
        ws[nd].wait(deadline)
        return ws[nd]

    yield get
    for w in ws.values():
        for p in w.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _each_rank(world, case):
    return [world.out(case, r) for r in range(world.nd)]


@pytest.mark.parametrize("nd", WORLDS)
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("kind", KINDS)
def test_mesh_compress_bytes_equal_single(worlds, inputs, nd, level, kind):
    """compress(..., mesh=) on every rank == stenos_tpu's frame at 3.25
    superblocks (the shares, their padding and the partial tail)."""
    data = inputs[f"c{level}_{kind}"]
    want = ref_frame.compress(data.tobytes(), BPP, level)
    for r, o in enumerate(_each_rank(worlds(nd), f"compress-{level}-{kind}")):
        assert o["frame"].tobytes() == want, (nd, r)


def _device_ref(inputs, nd):
    n = DEV_NSB - DEV_NSB % nd
    frame, length = compress_frame_device_jit(inputs["dev_batch"][:n], BPP, 1)
    return np.asarray(frame)[: int(length)]


@pytest.mark.parametrize("nd", WORLDS)
def test_device_sharded_ragged(worlds, inputs, nd):
    """The shards of compress_device_sharded, concatenated in rank order,
    are compress_frame_device_jit's frame; rank t holds [t*S, (t+1)*S)."""
    want = _device_ref(inputs, nd)
    outs = _each_rank(worlds(nd), "ragged")
    S = -(-len(want) // nd)
    for r, o in enumerate(outs):
        assert int(o["total"]) == len(want)
        assert o["shard"].tobytes() == want[r * S : (r + 1) * S].tobytes()
    assert b"".join(o["shard"].tobytes() for o in outs) == want.tobytes()


@pytest.mark.parametrize("nd", WORLDS)
def test_device_sharded_gathered(worlds, inputs, nd):
    """The gathered variant's frame on every rank ==
    compress_frame_device_jit's."""
    want = _device_ref(inputs, nd).tobytes()
    for r, o in enumerate(_each_rank(worlds(nd), "gathered")):
        assert o["frame"].tobytes() == want, r


def _share(a, nd, r):
    n = len(a) - len(a) % nd
    per = n // nd
    return a[r * per : (r + 1) * per]


@pytest.mark.parametrize("nd", WORLDS)
def test_encode_slabs_sharded(worlds, inputs, nd):
    """Each rank's records [1, csize u24, stream], bsizes and fsizes ==
    encode_superblocks_jit's for its superblocks."""
    out, tot, bs, fs = (np.asarray(t) for t in encode_superblocks_jit(
        inputs["dev_batch"], BPP, 2))
    for r, o in enumerate(_each_rank(worlds(nd), "slabs")):
        idx = _share(np.arange(DEV_NSB), nd, r)
        assert (o["totals"] == tot[idx] + 4).all()
        assert (o["bsizes"] == bs[idx]).all() and (o["fsizes"] == fs[idx]).all()
        for j, i in enumerate(idx):
            want = (bytes([1]) + int(tot[i]).to_bytes(3, "little")
                    + out[i][: tot[i]].tobytes())
            assert o["rows"][j][: o["totals"][j]].tobytes() == want, (r, i)


@pytest.mark.parametrize("nd", WORLDS)
def test_encode_superblocks_sharded(worlds, inputs, nd):
    """Each rank's streams and sizes == encode_superblocks_jit's."""
    out, tot, bs, fs = (np.asarray(t) for t in encode_superblocks_jit(
        inputs["dev_batch"], BPP, 2))
    for r, o in enumerate(_each_rank(worlds(nd), "streams")):
        idx = _share(np.arange(DEV_NSB), nd, r)
        assert (o["totals"] == tot[idx]).all()
        assert (o["bsizes"] == bs[idx]).all() and (o["fsizes"] == fs[idx]).all()
        for j, i in enumerate(idx):
            assert (o["streams"][j][: tot[i]] == out[i][: tot[i]]).all()


@pytest.mark.parametrize("nd", WORLDS)
def test_sharded_compress_step(worlds, inputs, nd):
    """Every rank gets every superblock's stream and the records' offsets
    in an 8-byte-header frame (the exclusive prefix of totals + 4)."""
    n = DEV_NSB - DEV_NSB % nd
    out, tot, _, _ = (np.asarray(t) for t in encode_superblocks_jit(
        inputs["dev_batch"][:n], BPP, 2))
    sizes = tot.astype(np.int64) + 4
    for o in _each_rank(worlds(nd), "step"):
        assert (o["totals"] == tot).all()
        assert (o["offsets"] == 8 + np.cumsum(sizes) - sizes).all()
        for i in range(n):
            assert (o["streams"][i][: tot[i]] == out[i][: tot[i]]).all()


@pytest.mark.parametrize("nd", WORLDS)
def test_encode_segments_sharded(worlds, inputs, nd):
    """Phase 1: rank 0's segment starts with the header; the segments in
    rank order are the header and the records, their lengths gathered to
    every rank."""
    want = _device_ref(inputs, nd).tobytes()
    hlen = ref_frame.get_info(want, BPP)[2]
    outs = _each_rank(worlds(nd), "segments")
    segs = b"".join(o["seg"].tobytes() for o in outs)
    assert segs == b"h" * 8 + want[hlen:]
    for o in outs:
        assert o["lens"].tolist() == [len(x["seg"]) for x in outs]


@pytest.mark.parametrize("nd", WORLDS)
def test_traffic_ragged_below_gathered(worlds, nd):
    """The traffic model on each rank's own numbers: the ragged path moves
    fewer bytes a rank than the gathered one."""
    for o in _each_rank(worlds(nd), "traffic"):
        assert 0 < int(o["ragged"]) < int(o["gathered"])


def test_traffic_model_counts():
    """The model's arithmetic: gathered rows (nd-1)/nd * n_sb*w a rank, the
    ragged path (nd-1)/nd of a shard plus 16 bytes from each other rank."""
    m = ragged_traffic_model(n_sb=16, w=2052, nd=4, S=1000, C_loc=4000)
    assert m["gathered_per_chip_bytes"] == 3 * 16 * 2052 // 4
    assert m["ragged_per_chip_bytes"] == 750 + 48
    assert m["frame_shards_bytes"] == 4000
    assert m["ratio"] == round(m["gathered_per_chip_bytes"] / 798, 3)


def _methods(frame: bytes):
    dsize, sb, pos = ref_frame.get_info(frame, BPP)
    methods = []
    for _ in range(dsize // sb):
        methods.append(frame[pos])
        pos += 4 + int.from_bytes(frame[pos + 1 : pos + 4], "little")
    return set(methods)


@pytest.mark.parametrize("nd", WORLDS)
@pytest.mark.parametrize("level", (1, 2))
def test_mesh_decompress(worlds, inputs, nd, level):
    """decompress(..., mesh=) is exact with a partial tail on every rank,
    and the frame (sorted int32: METHOD_BLOCK at both levels) decodes on
    the mesh."""
    assert _methods(inputs[f"d{level}"].tobytes()) == {1}
    for o in _each_rank(worlds(nd), f"decompress-{level}"):
        assert (o["out"] == inputs["dec_data"]).all()
        assert bool(o["on_mesh"])


@pytest.mark.parametrize("nd", WORLDS)
def test_mesh_decompress_mixed_methods(worlds, inputs, nd):
    """A level-2 frame holding methods other than METHOD_BLOCK takes the
    single-device path on every rank, exactly."""
    assert _methods(inputs["mixed"].tobytes()) != {1}
    for o in _each_rank(worlds(nd), "decompress-mixed"):
        assert (o["out"] == inputs["mixed_data"]).all()
        assert not bool(o["on_mesh"])


@pytest.mark.parametrize("nd", WORLDS)
@pytest.mark.parametrize("case", ("truncated", "corrupt"))
def test_mesh_decompress_bad_frame(worlds, inputs, nd, case):
    """A truncated frame, and one with a block stream overwritten on a
    later rank's share, give every rank what the port's single-device
    engine gives: its error code, or its bytes."""
    try:
        want = port_frame.decompress(inputs[case].tobytes(), BPP,
                                     engine=TorchEngine("cpu"))
        err = None
    except port_frame.StenosError as e:
        want, err = None, e.code
    world = worlds(nd)
    for r, o in enumerate(_each_rank(world, case)):
        if err is None:
            assert str(o["error"]) == "none", r
            assert (world.out(case + "-out", r)["out"] == want).all()
        else:
            assert str(o["error"]) == "StenosError" and int(o["code"]) == err


@pytest.mark.parametrize("nd", WORLDS)
def test_mesh_decompress_dst_overflow(worlds, nd):
    """A dst_size one byte short raises ERROR_DST_OVERFLOW on every rank."""
    for o in _each_rank(worlds(nd), "overflow"):
        assert str(o["error"]) == "StenosError" and int(o["code"]) == -6


@pytest.mark.parametrize("nd", WORLDS)
@pytest.mark.parametrize("case", ("uneven", "uneven-gathered"))
def test_uneven_shares_raise(worlds, nd, case):
    """Shares of 6 and 5 superblocks (n_sb not split evenly over the mesh)
    raise the JAX package's ValueError on every rank."""
    for o in _each_rank(worlds(nd), case):
        assert str(o["error"]) == "ValueError"
        assert "not a multiple of mesh size" in str(o["msg"])


@pytest.mark.parametrize("nd", WORLDS)
def test_decode_slabs_sharded(worlds, inputs, nd):
    """K2's plain version on each rank's parsed rows decodes its share of
    the level-1 frame's full superblocks."""
    sb = 131072
    data = inputs["dec_data"][: 6 * sb].reshape(6, sb)
    for r, o in enumerate(_each_rank(worlds(nd), "decode-slabs")):
        assert (o["words"] == _share(data, nd, r)).all(), r


def test_parallel_imports_without_jax():
    """A fresh interpreter: stenos_tpu_torch.parallel pulls in neither jax
    nor stenos_tpu, and exports the JAX package's names."""
    code = ("import sys, stenos_tpu_torch.parallel as p; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'stenos_tpu')]; print(bad, p.__all__); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    import stenos_tpu.parallel as ref
    import stenos_tpu_torch.parallel as port

    assert sorted(port.__all__) == sorted(ref.__all__)
    assert all(hasattr(port, n) for n in ref.__all__)


def test_make_mesh_needs_a_process_group():
    """Without an initialized process group make_mesh and the sharded
    entry points raise; they build no world of one."""
    import stenos_tpu_torch as stt
    from stenos_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="not initialized"):
        make_mesh()
    with pytest.raises(RuntimeError, match="not initialized"):
        stt.compress_sharded(b"\0" * 4096, 4, 1, device="cpu")
