"""``System.start_profiler_trace`` / ``stop_profiler_trace`` of
sdpl_slam_torch (twin of tests/test_profiler_trace.py): a torch.profiler
trace around the tracking loop is written under ``log_dir`` as a Chrome
trace holding the frames' ranges, on the host, resident and chained paths
(the span recorder's spans enter the profiler's ranges, recorder off)."""

import json

import pytest
import torch

from sdpl_slam_torch.models.system import System
from sdpl_slam_torch.utils.synthetic import (SynthConfig, SynthSequence,
                                             synth_settings)

torch.set_num_threads(2)


CHAINED = ["chained." + k for k in (
    "dispatch_det", "drain", "planes", "families", "selection",
    "families_pack", "dispatch_step")]


@pytest.mark.parametrize("mode", [False, True, "chained"],
                         ids=["False", "True", "chained"])
def test_profiler_trace_written(tmp_path, mode):
    """``mode``: False the host path, True the resident loop, "chained"
    the chained loop."""
    cfg = SynthConfig(n_frames=4, n_objects=1)
    seq = SynthSequence(cfg)
    settings = synth_settings(cfg)
    settings.run_local_ba = False
    settings.resident_tracking = mode is True
    settings.chained_tracking = mode == "chained"
    sys_ = System(settings, verbose=False, device="cpu")
    n = seq.n_frames - 1
    log_dir = tmp_path / "trace"
    sys_.start_profiler_trace(log_dir)
    for t in range(n):
        f = seq.frame(t)
        sys_.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                        f.obj_rows, float(t) * 0.1, n,
                        line_detections=f.lines)
    path = sys_.stop_profiler_trace()
    traces = list(log_dir.rglob("*.pt.trace.json"))
    assert traces == [path], list(log_dir.rglob("*"))
    events = json.loads(path.read_text())["traceEvents"]
    names = [e.get("name") for e in events]
    assert names.count("frame") == n
    if mode is True:
        assert "resident_step" in names
    if mode == "chained":
        assert names.count("chained_step") == n - 1       # frames 1, 2
        for name in CHAINED:
            assert names.count(name) == n - 1, name
    # the resident map stream was drained before the trace stopped
    assert sys_.tracker.map.n_frames == n
