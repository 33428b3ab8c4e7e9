"""The port's last entry points and its tools (stenos_tpu_torch on the CPU)
against the JAX package: engine.decompress_frame_batched in both modes and
every case where it gives None, entropy.encode_frame_host,
encode_frame_device(sidecar=False) and STENOS_SEQ_ANCHORS=0, the fuzz lane's
iteration (tools/fuzz_port.py) and the sweep's grid
(tools/validate_cuda.py). Exact bytes everywhere.

The JAX batched decode runs its XLA route here (one compile a frame shape),
so the frames are small: superblocks of 128 KiB (level 1, sorted int32) and
512 KiB (level 5, a device frame at bytesoftype 1)."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import zstandard

from stenos_tpu import frame as ref_frame
from stenos_tpu.engine_jax import \
    decompress_frame_batched as ref_batched
from stenos_tpu.entropy import zstd_frame as ref_zstd_frame
from stenos_tpu_torch import engine, frame
from stenos_tpu_torch.constants import (METHOD_BLOCK, METHOD_BLOCK_ZSTD)
from stenos_tpu_torch.entropy import encode_frame_host, zstd_frame
from stenos_tpu_torch.entropy.device_decode import decode_payload_device
from stenos_tpu_torch.host import zstd as zstd_host

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
sys.path.insert(0, TOOLS)

import fuzz_port  # noqa: E402
import stenos_tpu  # noqa: E402
import validate_cuda  # noqa: E402

BLOCK = 131072
SB = 131072  # the level-1 superblock at bytesoftype 4
TEXT = open(os.path.join(ROOT, "benchs", "data", "code_text.txt"),
            "rb").read()


def _methods(f, bpp):
    _, _, pos = frame.get_info(f, bpp)
    out = []
    while pos < len(f):
        out.append(f[pos])
        pos += 4 + int.from_bytes(f[pos + 1 : pos + 4], "little")
    return out


def _sorted_int32(rng, n, hi):
    return np.sort(rng.integers(0, hi, n // 4)).astype("<u4").view(np.uint8)


@pytest.fixture(scope="module")
def batched_frames():
    """name -> (frame, bytesoftype, JAX decompress_frame_batched of it)."""
    rng = np.random.default_rng(31)
    l1 = frame.compress(_sorted_int32(rng, 4 * SB, 1 << 30), 4, 1)
    assert set(_methods(l1, 4)) == {METHOD_BLOCK}
    # superblocks of 512 KiB: a device frame (every record METHOD_BLOCK)
    x = torch.from_numpy(rng.integers(0, 16, 2 * 4 * BLOCK).astype(
        np.uint8).reshape(2, -1))
    f5, n5 = engine.compress_frame_device(x, 1, 5)
    l5 = f5[: int(n5)].numpy().tobytes()
    assert frame.get_info(l5, 1)[1] == 4 * BLOCK
    zst = frame.compress(_sorted_int32(rng, 4 * SB, 4 * SB * 2), 4, 2)
    assert METHOD_BLOCK_ZSTD in _methods(zst, 4)
    partial = frame.compress(_sorted_int32(rng, 3 * SB + SB // 2, 1 << 30),
                             4, 1)
    corrupt = bytearray(l1)
    _, _, pos = frame.get_info(l1, 4)
    pos += 4 + int.from_bytes(l1[pos + 1 : pos + 4], "little")
    corrupt[pos + 4] = 0xFF  # the second superblock's first block header
    cases = {"level1": (l1, 4), "level5": (l5, 1), "block_zstd": (zst, 4),
             "partial": (partial, 4), "corrupt": (bytes(corrupt), 4),
             "empty": (frame.compress(b"", 4, 1), 4)}
    return {k: (f, bpp, ref_batched(f, bpp)) for k, (f, bpp) in
            cases.items()}


@pytest.mark.parametrize("keep_device", [False, True])
@pytest.mark.parametrize("case", ["level1", "level5", "block_zstd",
                                  "partial", "corrupt", "empty"])
def test_decompress_frame_batched_matches_jax(batched_frames, case,
                                              keep_device, monkeypatch):
    """The bytes and the None-ness of JAX's decompress_frame_batched (its
    XLA route on the CPU), in batches of two superblocks: with keep_device
    one tensor a batch, on the engine's device."""
    f, bpp, want = batched_frames[case]
    assert (want is None) == (case in ("block_zstd", "partial", "corrupt",
                                       "empty"))
    monkeypatch.setattr(engine, "CHUNK_BYTES", 2 * SB)
    got = engine.decompress_frame_batched(f, bpp, device="cpu",
                                          keep_device=keep_device)
    if want is None:
        assert got is None
        return
    if keep_device:
        sb = frame.get_info(f, bpp)[1]
        assert len(got) == -(-len(want) // max(sb, 2 * SB))
        assert all(t.device.type == "cpu" and t.dtype == torch.uint8
                   for t in got)
        got = torch.cat(got).numpy()
    assert got.tobytes() == np.asarray(want).tobytes()
    assert got.tobytes() == frame.decompress(f, bpp).tobytes()


def test_decompress_frame_batched_engine_argument(batched_frames):
    f, bpp, want = batched_frames["level1"]
    got = engine.decompress_frame_batched(f, bpp,
                                          engine.TorchEngine("cpu"))
    assert got.tobytes() == np.asarray(want).tobytes()
    with pytest.raises(ValueError):
        engine.decompress_frame_batched(f, bpp, engine.TorchEngine("cpu"),
                                        device="cpu")


# ------------------------------------------------------- entropy entry points
def _families():
    rng = np.random.default_rng(8)
    lit = rng.integers(0, 64, BLOCK + 5000).astype(np.uint8)
    runny = np.repeat(rng.integers(0, 8, (BLOCK + 5000) // 50 + 1),
                      50)[: BLOCK + 5000].astype(np.uint8)
    pool = rng.integers(0, 40, (300, 64)).astype(np.uint8)
    records = pool[rng.integers(0, 300, (BLOCK + 5056) // 64)].reshape(-1)
    return {"literals": lit, "runny": runny, "records": records}


@pytest.mark.parametrize("family", ["literals", "runny", "records"])
def test_encode_frame_host_matches_jax(family):
    data = _families()[family]
    got = encode_frame_host(data)
    assert got == ref_zstd_frame.encode_frame_host(data)
    assert zstandard.ZstdDecompressor().decompress(
        got, max_output_size=len(data)) == data.tobytes()


@pytest.fixture(scope="module")
def option_frames():
    """A literal block and a text tail (sequences with Huffman literals):
    JAX's encode_frame_device (interpret mode) with sidecar=False, and with
    STENOS_SEQ_ANCHORS=0, STENOS_DEVICE_MATCH=1 on both sides."""
    rng = np.random.default_rng(4)
    data = np.concatenate([rng.integers(0, 64, BLOCK).astype(np.uint8),
                           np.frombuffer(TEXT[:12_000], np.uint8)])
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STENOS_DEVICE_MATCH", "1")
        out["sidecar_false"] = ref_zstd_frame.encode_frame_device(
            data, interpret=True, sidecar=False)
        mp.setenv("STENOS_SEQ_ANCHORS", "0")
        out["seq_anchors_0"] = ref_zstd_frame.encode_frame_device(
            data, interpret=True)
    return data, out


@pytest.mark.parametrize("variant", ["sidecar_false", "seq_anchors_0"])
def test_encode_frame_device_options_match_jax(option_frames, variant,
                                               monkeypatch):
    """Each frame equals JAX's, differs from the default frame as it
    should (no sidecar; the tail block's anchors left out), and decodes
    through the port's decode_payload_device (the tail by its scan route)
    and host libzstd."""
    data, ref = option_frames
    monkeypatch.setenv("STENOS_DEVICE_MATCH", "1")
    default = zstd_frame.encode_frame_device(data, device="cpu")
    if variant == "sidecar_false":
        got = zstd_frame.encode_frame_device(data, device="cpu",
                                             sidecar=False)
        assert default.startswith(got) and len(default) > len(got)
    else:
        monkeypatch.setenv("STENOS_SEQ_ANCHORS", "0")
        got = zstd_frame.encode_frame_device(data, device="cpu")
        assert got != default and len(got) < len(default)
    assert got == ref[variant]
    out = decode_payload_device(got, len(data), "cpu")
    assert out is not None and np.array_equal(out.numpy(), data)
    assert zstd_host.decompress(got, len(data)) == data.tobytes()


# ------------------------------------------------------------------- tools
@pytest.mark.parametrize("seed", range(6))
def test_fuzz_port_iteration(seed):
    """The fuzz lane's iteration with --against stenos_tpu, every periodic
    check on (the libzstd frame through the device decode only on the
    small draws: its plain sequence walk steps once a sequence)."""
    fails = fuzz_port.iteration(seed, "cpu", stenos_tpu, 150_000,
                                entropy=seed in (2, 3, 5), custom=True,
                                batched=True)
    assert fails == []


def test_validate_grid_on_the_cpu():
    """The sweep's grid at one tiny case: the card's path (here the plain
    versions) against the host path, both decodes, and
    decompress_frame_batched on the frame (None: a partial superblock) and
    on its first superblock (decoded)."""
    res = validate_cuda.grid(torch.device("cpu"), (4,), ("sorted",),
                             (140_000,), (1,), custom=None,
                             log=lambda m: None)
    assert (res["cases"], res["fails"], res["batched"]) == (1, 0, [1, 1])
    data = validate_cuda.grid_data(4, "sorted", 140_000)
    f = frame.compress(data, 4, 1)
    assert f == ref_frame.compress(data, 4, 1, engine=None)


@pytest.mark.parametrize("tool", [fuzz_port, validate_cuda])
def test_tools_refuse_an_absent_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tool.main(["--device", "cuda"])
    if tool is fuzz_port:
        fuzz_port.check_device("cpu", "stenos_tpu")


def test_tools_import_no_jax():
    """validate_cuda.py imports neither jax nor stenos_tpu, and a fresh
    interpreter that loads both tools (fuzz_port without --against) pulls
    in neither."""
    pattern = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|stenos_tpu)\b",
                         re.M)
    with open(os.path.join(TOOLS, "validate_cuda.py")) as f:
        assert not pattern.search(f.read())
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; "
            "import fuzz_port, validate_cuda; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'stenos_tpu')]; "
            "assert not bad, bad").format(TOOLS, ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
