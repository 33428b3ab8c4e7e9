"""The image-u16.frame-batches cell on the CPU at copy_tree's size (images
of two superblocks, three a call): a sound run is correct, the control and
every planted fault are not, a traced run reports both of the cell's span
metrics that a CPU can give (the card's events only on a card), the
generator repeats from its seed and stays in the family's range, the
reference's rows decode to their images, and no module of JAX or the JAX
package is loaded. On a card, the cell runs and its traced run reports
both new metrics."""

import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, SMALL, copy_tree, run_cell

CELL = "image-u16.frame-batches"
SPAN_METRICS = ("frames_host_ms.compress", "frame_device_ms.compress")
PER_CALL = 3


@pytest.fixture
def frames_root(tmp_path):
    """copy_tree's checkout with PER_CALL images a call."""
    root = copy_tree(tmp_path)
    p = os.path.join(root, os.path.basename(BENCH), "traffic",
                     "frame-batches.json")
    with open(p) as f:
        t = json.load(f)
    t["frames_per_call"] = PER_CALL
    with open(p, "w") as f:
        json.dump(t, f)
    return root


def _make():
    from harness import spec

    return spec.load_module(os.path.join(BENCH, "configs", "image-u16.py"),
                            "gen_image_u16").make


def test_generator_repeats_from_the_seed():
    import torch

    make, cpu = _make(), torch.device("cpu")
    a = make(2**31 + 7, 0, SMALL, cpu)
    assert a.dtype == torch.uint8 and a.numel() == SMALL
    assert torch.equal(a, make(2**31 + 7, 0, SMALL, cpu))
    assert not torch.equal(a, make(2**31 + 7, 1, SMALL, cpu))
    v = a.view(torch.int16)
    assert 200 <= int(v.min()) and int(v.max()) < 3200 + 64
    # a smooth field: neighbours differ by far less than its 3000 of range
    d = (v[1:2048].int() - v[:2047].int()).abs().float().mean()
    assert float(d) < 100
    # a frame that is no whole number of rows, and an odd one out
    assert make(5, 0, 1000, cpu).numel() == 1000


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(frames_root, capsys, trace):
    rc, r, err = run_cell(frames_root, CELL, capsys, trace=trace,
                          seed=2**31 + 19)
    assert rc == 0 and r["correct"] and r["failed"] == 0 and r["attempted"]
    assert all(v["value"] == 0 for v in r["check"].values())
    if trace:
        m = r["metrics"]
        assert m["frames_host_ms.compress"]["value"] > 0
        assert m["frames_host_ms.compress"]["unit"] == "ms"
        assert "frame_device_ms.compress" not in m  # CUDA events: a card
        assert "kernels_roofline.compress" not in m  # no device trace
    else:
        assert set(r["metrics"]) == {"compress_gbps", "compress_p95_ms",
                                     "setup_s"}


@pytest.mark.parametrize("mode", ["control", "unchanged", "half", "altered"])
def test_control_and_faults_are_not_correct(frames_root, capsys, mode):
    from harness.controls import install

    rc, r, _ = run_cell(frames_root, CELL, capsys, patch=install(mode, 5))
    assert rc == 0 and r["correct"] is False
    assert any(v["value"] > v["limit"] for v in r["check"].values())


def test_a_program_without_the_entry_point_fails_at_once(frames_root,
                                                        capsys, monkeypatch):
    """As the parent commit's program: the set-up's import fails before any
    data is made, and the run gives no result."""
    import stenos_tpu_torch.engine as eng

    monkeypatch.delattr(eng, "compress_frames_device")
    made = []
    from harness import spec

    real = spec.Cell.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        self.make = lambda *args: made.append(args)

    monkeypatch.setattr(spec.Cell, "__init__", init)
    with pytest.raises(ImportError):
        run_cell(frames_root, CELL, capsys)
    assert made == []


def test_reference_rows_decode_to_their_images():
    import torch

    import stenos_tpu_torch as st
    from reference.frame_batch import frame_batch

    make = _make()
    x = torch.stack([make(3, i, SMALL, torch.device("cpu"))
                     for i in range(2)])
    out, lengths = frame_batch(x, 2, 1)
    assert out.shape == (2, -(-(8 + 2 * (4 + 256 * 513)) // 16) * 16)
    for f in range(2):
        n = int(lengths[f])
        frame = out[f, :n].numpy().tobytes()
        assert st.decompress(frame, 2, engine=None).tobytes() \
            == x[f].numpy().tobytes()
        assert not out[f, n:].any()


def test_no_module_of_jax_or_the_jax_package_is_imported(frames_root):
    code = f"""
import sys
sys.path[:0] = [{os.path.join(ROOT, 'portbench')!r}, {ROOT!r}]
from harness.cli import main, forbidden_modules
rc = main(['--workload', {CELL!r}, '--seed', '3', '--seconds', '0.2',
           '--trace', '1'], allow_cpu=True, root={frames_root!r})
assert rc == 0, rc
print('FOUND', forbidden_modules())
"""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "FOUND []"


@pytest.mark.card
def test_cell_runs_on_the_card(card):
    for trace in (0, 1):
        r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                            CELL, "--seed", "2147483661", "--seconds", "2",
                            "--trace", str(trace)], capture_output=True,
                           text=True, cwd=ROOT, timeout=1200)
        assert r.returncode == 0, r.stderr[-4000:]
        result = json.loads(r.stdout.splitlines()[-1])
        assert result["correct"]
        if trace:
            assert set(SPAN_METRICS) <= set(result["metrics"])
