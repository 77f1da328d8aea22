"""sdpl_slam_torch stands alone: no JAX at import, explicit devices, and
unsupported settings refused rather than run differently."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sdpl_slam_torch.models.map_state import MapState
from sdpl_slam_torch.models.system import System
from sdpl_slam_torch.models.tracking import Tracking, check_supported
from sdpl_slam_torch.ops.geometry import Intrinsics
from sdpl_slam_torch.solvers import ba_builder
from sdpl_slam_torch.utils.synthetic import (SynthConfig, lba_settings,
                                             slice_settings)

ROOT = Path(__file__).resolve().parents[1]

SLICE_MODULES = (
    "sdpl_slam_torch",
    "sdpl_slam_torch.ops.lie", "sdpl_slam_torch.ops.geometry",
    "sdpl_slam_torch.ops.fast", "sdpl_slam_torch.ops.ransac",
    "sdpl_slam_torch.ops.lines", "sdpl_slam_torch.ops.lsd_oracle",
    "sdpl_slam_torch.solvers.frame_solvers",
    "sdpl_slam_torch.solvers.batch_ba", "sdpl_slam_torch.solvers.ba_builder",
    "sdpl_slam_torch.models.frame", "sdpl_slam_torch.models.frame_host",
    "sdpl_slam_torch.models.map_state", "sdpl_slam_torch.models.tracklets",
    "sdpl_slam_torch.models.tracking", "sdpl_slam_torch.models.system",
    "sdpl_slam_torch.models.resident",
    "sdpl_slam_torch.io.native", "sdpl_slam_torch.io.writers",
    "sdpl_slam_torch.io.png", "sdpl_slam_torch.io.dataset",
    "sdpl_slam_torch.io.prefetch",
    "sdpl_slam_torch.utils.config", "sdpl_slam_torch.utils.metrics",
    "sdpl_slam_torch.utils.plotting", "sdpl_slam_torch.utils.traj_canvas",
    "sdpl_slam_torch.utils.synthetic", "sdpl_slam_torch.utils.convert",
    "sdpl_slam_torch.utils.cuda_build", "sdpl_slam_torch.utils.device",
    "sdpl_slam_torch.bench",
)


SCRIPTS = ("chip_smoke.py", "examples/run_sequence_torch.py",
           "examples/make_demo_sequence_torch.py")


def test_port_imports_without_jax():
    """Every module of the package (walked, so a new module is held too;
    SLICE_MODULES must be among them) and the three scripts that drive it
    import without JAX, the JAX package, OpenCV or PyYAML."""
    body = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import sdpl_slam_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    sdpl_slam_torch.__path__, 'sdpl_slam_torch.')]\n"
        f"assert set({SLICE_MODULES!r}) - {{'sdpl_slam_torch'}} <= set(mods)\n"
        "assert len(mods) >= 45, mods\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        f"for i, path in enumerate({SCRIPTS!r}):\n"
        "    spec = importlib.util.spec_from_file_location('script%d' % i, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'sdpl_slam_tpu',\n"
        "                                    'yaml', 'cv2'))\n"
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


def test_tracking_and_ba_default_to_the_card():
    """``Tracking`` and both BA entry points run on the card unless the
    caller asks for the CPU, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    s = _settings()
    K = Intrinsics.from_config(s)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Tracking(s)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ba_builder.full_batch_optimization(MapState(), K, s)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ba_builder.partial_batch_optimization(MapState(), K, 20, s)
    assert Tracking(s, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("global_ba", [False, True, None])
def test_batch_ba_settings_accepted(global_ba):
    """The bench's window BA (``lba_settings``) and the global BA, set or
    by default on KITTI, run rather than raise."""
    s = lba_settings(SynthConfig(n_frames=2))
    s.run_global_ba = global_ba
    s.choose_data = 2                      # KITTI: None fires the global BA
    assert System(s, verbose=False, device="cpu").settings.run_local_ba


@pytest.mark.parametrize("field,value,item", [
    ("resident_tracking", True, "A10"),
    ("chained_tracking", True, "A14"),
    ("chained_depth", 3, "A14"),          # with chained_tracking = True
    ("pipelined_tracking", True, "A5"),
    ("run_local_ba", True, "A12"),        # with ba_schur = True
    ("run_global_ba", True, "A12"),
    ("run_global_ba", None, "A12"),       # None fires on KITTI
])
def test_formerly_refused_settings_run(field, value, item):
    """Every setting ``check_supported`` once refused builds a CPU
    ``System`` and keeps its value: ``resident_tracking`` without the joint
    optimiser takes the host path, as in the JAX package (ROADMAP C1);
    ``ba_schur`` with a batch BA on takes the dense-Schur step (A12); the
    chained loop at depths 2 and 3 (A14) and the pipelined host path (A5)
    run."""
    s = _settings()
    setattr(s, field, value)
    if field == "run_global_ba" and value is None:
        s.choose_data = 2                  # KITTI
    if item == "A12":
        s.ba_schur = True                  # the dense-Schur BA step
    if item == "A10":
        s.use_joint_optimization = False
    if field == "chained_depth":
        s.chained_tracking = True
    check_supported(s)
    system = System(s, verbose=False, device="cpu")
    assert getattr(system.settings, field) == value


def test_schur_without_batch_ba_runs():
    """``ba_schur`` only matters where a batch BA fires."""
    s = _settings()
    s.ba_schur = True
    System(s, verbose=False, device="cpu")


def _tiny_run(**over):
    """Two 160x64 frames through a CPU ``System`` with nothing injected."""
    from sdpl_slam_torch.utils.synthetic import SynthSequence

    cfg = SynthConfig(n_frames=2, width=160, height=64, fx=90.0, fy=90.0,
                      cx=80.0, cy=32.0)
    seq = SynthSequence(cfg)
    settings = slice_settings(cfg)
    for k, v in over.items():
        setattr(settings, k, v)
    s = System(settings, verbose=False, device="cpu")
    for t in range(2):
        f = seq.frame(t)
        pose = s.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                            f.obj_rows, 0.1 * t, 2)
    return s, pose


def test_lines_without_detections_run_the_detector():
    """``use_lines`` on and no ``line_detections=``: the line detector
    runs in the loop, once a frame, on the tracker's device."""
    from sdpl_slam_torch.utils import trace

    lines = []
    with trace.enabled():
        for use_lines in (True, False):
            runs = _tiny_run(use_lines=use_lines)
            lines.append([x for x in trace.collect()["spans"]
                          if x.name == "detector.lines"])
            if use_lines:
                s, pose = runs
    assert s.settings.use_lines and len(lines[0]) == 2
    assert pose.shape == (4, 4) and torch.isfinite(torch.from_numpy(pose)).all()
    assert lines[1] == []


def test_nonjoint_setting_runs():
    """``use_joint_optimization = False`` takes the pose-only solver
    rather than raising."""
    s, pose = _tiny_run(use_joint_optimization=False)
    assert not s.settings.use_joint_optimization
    assert pose.shape == (4, 4) and torch.isfinite(torch.from_numpy(pose)).all()


def test_pipelined_default_is_off():
    """(Named for the port's old default.)  The port's ``Settings`` default
    to the pipelined host path, as the JAX package's do, and a yaml that
    does not name the key builds a ``System`` with it."""
    from sdpl_slam_torch.utils.config import Settings, load_settings

    assert Settings().pipelined_tracking is True
    s = load_settings(ROOT / "examples" / "kitti.yaml")
    assert s.pipelined_tracking is True
    system = System(ROOT / "examples" / "kitti.yaml", verbose=False,
                    device="cpu")
    assert system.settings.pipelined_tracking is True
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            System(ROOT / "examples" / "kitti.yaml", verbose=False)
