"""A CPU rehearsal of a run: a tiny cell through the harness (``run.run``
on the CPU, which only these tests do), the result line's keys, and the
timed path broken underneath in each way a cell can break, which
``correct`` has to catch.  The measured command itself refuses a machine
without a card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from slam_bench import calibrate, run, spec

ROOT = Path(spec.HERE).parent
TINY = dict(width=320, height=128, fx=300.0, fy=300.0, cx=160.0, cy=64.0)
# at this size the objects' mean motion error reads 27.6-41.2 mm on three
# seeds, and 901.4 mm with every object motion left at the identity (CPU)
LIMITS = {"frames_missing": 0, "cam_t_mm": 150.0, "cam_r_deg": 0.5,
          "fast_mismatch": 0, "obj_t_mean_mm": 150.0}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A copy of the benchmark's data with a tiny cell of the kitti
    configuration added (5 frames, 320x128, smaller caps)."""
    root = tmp_path_factory.mktemp("bench")
    base = root / "slam_bench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(Path(spec.HERE) / sub, base / sub)
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["workloads"] += [
        dict(name="tiny.track", config="tiny", traffic="track", chips=1,
             why="rehearsal")]
    for m in doc["per_layer"]:          # what kitti.track reports
        if "kitti.track" in m["workloads"]:
            m["workloads"].append("tiny.track")
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    cfg = json.loads((base / "configs" / "kitti.json").read_text())
    cfg["scene"].update(TINY)
    cfg["settings"].update(TINY, max_track_point_bg=300,
                           max_track_point_obj=200, max_static_lines=64)
    (base / "configs" / "tiny.json").write_text(
        json.dumps(dict(cfg, sequence_frames=5)))
    (base / "limits" / "tiny.track.json").write_text(json.dumps(LIMITS))
    return spec.Benchmark(root=root, base=base), root / "cache"


def _run(tiny, trace=0, seed=2 ** 31 + 5, cell="tiny.track"):
    bench, cache = tiny
    return run.run(bench, bench.cell(cell), seed, 0.0, trace, "cpu",
                   cache_dir=cache)


def test_rehearsal_line_has_the_keys_and_is_correct(tiny):
    out, numbers = _run(tiny)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"], out["checks"]
    assert out["attempted"] == 4 and out["failed"] == 0
    assert set(out["metrics"]) == {"fps", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert set(out["checks"]) == set(LIMITS)
    assert set(numbers) >= set(LIMITS) | {"obj_t_mm", "obj_label_err"}
    json.dumps(out)


def test_rehearsal_traced_line_has_the_host_readers(tiny):
    out, _ = _run(tiny, trace=1)
    assert out["correct"]
    assert {"chained.host_ms", "chained.wait_ms"} <= set(out["metrics"])
    assert "fps" not in out["metrics"]


def _unchanged_state(mp):
    """The chained step returns the state it was given."""
    from sdpl_slam_torch.models.chained import ChainedProgram

    orig = ChainedProgram.__call__

    def call(prog):
        keep = [t.clone() for t in prog.held()]
        out = orig(prog)
        for t, k in zip(prog.held(), keep):
            t.copy_(k)
        return out
    mp.setattr(ChainedProgram, "__call__", call, raising=False)


def _half_the_frames(mp):
    """Every other frame is left out."""
    from sdpl_slam_torch.models.system import System

    orig = System.track_rgbd

    def track(self, im, *a, **kw):
        self._n = getattr(self, "_n", -1) + 1
        if self._n % 2:
            return None
        return orig(self, im, *a, **kw)
    mp.setattr(System, "track_rgbd", track)


def _altered_pose(mp):
    """One frame's pose is moved 50 cm where the tracker produces it."""
    from sdpl_slam_torch.models.tracking import Tracking

    orig = Tracking._push_map

    def push(self, st, pose_np, *a, **kw):
        if len(self.map.camera_poses) == 2:
            pose_np = pose_np.copy()
            pose_np[0, 3] += 0.5
        return orig(self, st, pose_np, *a, **kw)
    mp.setattr(Tracking, "_push_map", push)


def _altered_keypoint(mp):
    """One keypoint of each detection moves a pixel where the detector
    produces it."""
    from sdpl_slam_torch.ops import fast

    orig = fast._detect_frames

    def detect(imgs, cfg):
        out = []
        for uv, sc, va in orig(imgs, cfg):
            uv = uv.clone()
            uv[int(np.flatnonzero(va.numpy())[0])] += 1
            out.append((uv, sc, va))
        return out
    mp.setattr(fast, "_detect_frames", detect)


def _identity_object_motions(mp):
    """Every object's motion reaches the map as the identity."""
    calibrate.identity_object_motions(mp.setattr)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_the_frames,
                                   _altered_pose, _altered_keypoint,
                                   _identity_object_motions])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, fault):
    fault(monkeypatch)
    out, _ = _run(tiny)
    assert not out["correct"], out["checks"]


def test_the_measured_command_refuses_a_machine_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "slam_bench.run", "--workload",
                        "kitti.track", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA card" in r.stderr
