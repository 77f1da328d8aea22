"""sdpl_slam_torch stands alone: no JAX at import, explicit devices, and
unsupported settings refused rather than run differently."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sdpl_slam_torch.models.system import System
from sdpl_slam_torch.utils.synthetic import SynthConfig, slice_settings

ROOT = Path(__file__).resolve().parents[1]

SLICE_MODULES = (
    "sdpl_slam_torch",
    "sdpl_slam_torch.ops.lie", "sdpl_slam_torch.ops.geometry",
    "sdpl_slam_torch.ops.fast", "sdpl_slam_torch.ops.ransac",
    "sdpl_slam_torch.solvers.frame_solvers",
    "sdpl_slam_torch.models.frame", "sdpl_slam_torch.models.frame_host",
    "sdpl_slam_torch.models.map_state", "sdpl_slam_torch.models.tracklets",
    "sdpl_slam_torch.models.tracking", "sdpl_slam_torch.models.system",
    "sdpl_slam_torch.io.native", "sdpl_slam_torch.io.writers",
    "sdpl_slam_torch.utils.config", "sdpl_slam_torch.utils.metrics",
    "sdpl_slam_torch.utils.plotting", "sdpl_slam_torch.utils.traj_canvas",
    "sdpl_slam_torch.utils.synthetic", "sdpl_slam_torch.utils.convert",
    "sdpl_slam_torch.utils.cuda_build",
)


def test_port_imports_without_jax():
    body = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'sdpl_slam_tpu', 'yaml')))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('IMPORT-OK')\n"
    )
    r = subprocess.run([sys.executable, "-c", body], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert r.returncode == 0 and "IMPORT-OK" in r.stdout, r.stdout + r.stderr


def _settings():
    return slice_settings(SynthConfig(n_frames=2))


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        System(_settings(), verbose=False, device="cuda")


def test_cpu_device_is_explicit():
    s = System(_settings(), verbose=False, device="cpu")
    assert s.device == torch.device("cpu")


@pytest.mark.parametrize("field,value,item", [
    ("resident_tracking", True, "A10"),
    ("chained_tracking", True, "A14"),
    ("pipelined_tracking", True, "A5"),
    ("run_local_ba", True, "A8"),
    ("run_global_ba", True, "A8"),
    ("run_global_ba", None, "A8"),        # None fires on KITTI
    ("use_joint_optimization", False, "A3"),
])
def test_unsupported_settings_raise(field, value, item):
    s = _settings()
    setattr(s, field, value)
    if field == "run_global_ba" and value is None:
        s.choose_data = 2                  # KITTI
    with pytest.raises(NotImplementedError, match=item):
        System(s, verbose=False, device="cpu")


def test_lines_without_detections_raise():
    from sdpl_slam_torch.utils.synthetic import SynthSequence

    cfg = SynthConfig(n_frames=1, width=160, height=64, fx=90.0, fy=90.0,
                      cx=80.0, cy=32.0)
    f = SynthSequence(cfg).frame(0)
    s = System(slice_settings(cfg), verbose=False, device="cpu")
    with pytest.raises(NotImplementedError, match="A7"):
        s.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose, f.obj_rows,
                     0.0, 1)
