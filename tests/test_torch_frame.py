"""The port's compress/decompress (stenos_tpu_torch, torch engine on the CPU)
against the JAX package's host path, frames byte for byte, plus the port's
isolation from JAX and its refusal to run on the CPU unasked."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import stenos_tpu
import stenos_tpu_torch as stt
from stenos_tpu import frame as ref_frame
from stenos_tpu_torch import native

from conftest import gen_elements
from test_engine_jax import CASES
from test_lz_adoption import lz_trigger_bytes, parse_frame_records

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("kind,bpp,ne", CASES)
def test_frames_match_host_path(rng, kind, bpp, ne):
    data = gen_elements(rng, bpp, ne, kind)
    for level in (1, 2):
        want = ref_frame.compress(data, bpp, level, engine=None)
        got = stt.compress(data, bpp, level, device="cpu")
        assert got == want, (kind, bpp, ne, level)
        assert stt.decompress(got, bpp, device="cpu").tobytes() == data
        assert stt.decompress(got, bpp, engine=None).tobytes() == data
        assert stenos_tpu.decompress(got, bpp).tobytes() == data


@pytest.mark.parametrize("bpp", [24, 300])
@pytest.mark.parametrize("dist", ["sorted", "same"])
def test_large_bytesoftype_frames(rng, bpp, dist):
    # ~1.5 superblocks plus a partial tail, as test_large_bytesoftype.py
    data = gen_elements(rng, 1, bpp * 700 + bpp // 3, dist)
    for level in (1, 2):
        got = stt.compress(data, bpp, level, device="cpu")
        assert got == ref_frame.compress(data, bpp, level, engine=None)
        assert stt.decompress(got, bpp, device="cpu").tobytes() == data


def test_level1_lz_table_is_frame_scoped(rng):
    raw = lz_trigger_bytes(rng, 2, 131072)
    want = ref_frame.compress(raw, 4, 1, engine=None)
    got = stt.compress(raw, 4, 1, device="cpu")
    assert got == want
    sb, offs, csizes = parse_frame_records(got, 4)
    r = native.load().parse_rows_batch(got, 4, sb, offs, csizes,
                                       max(csizes) + 32)
    assert (r[3] > np.asarray(csizes)).any()  # LZ blocks were emitted
    assert stt.decompress(got, 4, device="cpu").tobytes() == raw.tobytes()


def test_cross_decode(rng):
    data = gen_elements(rng, 4, 100_000, "sorted")
    ref = stenos_tpu.compress(data, 4, 2)
    port = stt.compress(data, 4, 2, device="cpu")
    assert stt.decompress(ref, 4, device="cpu").tobytes() == data
    assert stt.decompress(port, 4, device="cpu").tobytes() == data
    assert stenos_tpu.decompress(port, 4).tobytes() == data


def test_error_codes(rng):
    data = gen_elements(rng, 4, 5000, "random")
    with pytest.raises(stt.StenosError) as e:
        stt.compress(data, 0, 1, device="cpu")
    assert e.value.code == -7
    with pytest.raises(stt.StenosError) as e:
        stt.compress(data, 4, 1, dst_size=10, device="cpu")
    assert e.value.code == -6
    with pytest.raises(stt.StenosError) as e:
        stt.decompress(b"\0" * 16, 0, device="cpu")
    assert e.value.code == -7


def test_import_leaves_jax_out():
    # a fresh interpreter: this process already imported jax (conftest.py)
    code = ("import sys, stenos_tpu_torch, stenos_tpu_torch.engine, "
            "stenos_tpu_torch.frame, stenos_tpu_torch.native, "
            "stenos_tpu_torch.device_container, "
            "stenos_tpu_torch.entropy.huffman, "
            "stenos_tpu_torch.entropy.huff_kernel, "
            "stenos_tpu_torch.entropy.huff_decode_kernel; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'stenos_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_jax_imports_in_port_sources():
    pattern = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|stenos_tpu)\b",
                         re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "stenos_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def test_default_device_is_cuda(rng):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default engine runs")
    data = gen_elements(rng, 4, 5000, "sorted")
    with pytest.raises(RuntimeError, match="CUDA"):
        stt.compress(data, 4, 1)
    frame = stt.compress(data, 4, 1, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        stt.decompress(frame, 4)


def test_build_cache_keys_on_source(tmp_path, monkeypatch):
    from stenos_tpu_torch import _build
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "k.c"
    cmd = ["gcc", "-O1", "-shared", "-fPIC"]
    src.write_text("int k(void) { return 1; }\n")
    first = _build.cached_lib(cmd, str(src), "k")
    assert os.path.exists(first)
    assert _build.cached_lib(cmd, str(src), "k") == first
    src.write_text("int k(void) { return 2; }\n")
    assert _build.cached_lib(cmd, str(src), "k") != first
    src.write_text("int k(void) { return }\n")
    with pytest.raises(RuntimeError, match="failed"):
        _build.cached_lib(cmd, str(src), "k")
