"""System facade: the reference's public API surface
(reference include/System.h:41-52, src/System.cc:22-64), as in
the JAX package's ``models.system``.

``System(settings, device=...).track_rgbd(...)`` + ``save_results(dir)``,
``save_checkpoint`` / ``load_checkpoint`` and ``start_profiler_trace`` /
``stop_profiler_trace``.
"""

from __future__ import annotations

import dataclasses
import pickle
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..io import writers
from ..utils import convert, metrics
from ..utils.config import KITTI, RGBD, Settings, load_settings
from ..utils.device import checked_device
from .tracking import Tracking, check_supported

BANNER = (
    " ----------------------------------------------------------------------------\n"
    "| SDPL-SLAM (PyTorch): dynamic point-line RGB-D SLAM on PyTorch + CUDA.      |\n"
    " ----------------------------------------------------------------------------"
)


class System:
    """``device`` names where the per-frame tensors live ("cuda" by
    default).  With ``device="cuda"`` and no CUDA device it raises: there
    is no silent fallback to the CPU."""

    def __init__(self, settings: str | Path | Settings, sensor: int = RGBD,
                 verbose: bool = True, device="cuda"):
        if isinstance(settings, (str, Path)):
            settings = load_settings(settings)
        if sensor != RGBD:
            raise ValueError("only the RGBD sensor mode is implemented "
                             "(reference guards identically, System.cc:55)")
        dev = checked_device(device, "System")
        check_supported(settings)
        if verbose:
            print(BANNER)
        self.settings = settings
        self.sensor = sensor
        self.tracker = Tracking(settings, device=dev)

    @property
    def device(self) -> torch.device:
        return self.tracker.device

    @property
    def map(self):
        # the resident mode's map stream lags: drain it for every reader
        self.tracker.flush()
        return self.tracker.map

    def track_rgbd(
        self,
        im: np.ndarray,
        depthmap: np.ndarray,
        flowmap: np.ndarray,
        masksem: np.ndarray,
        gt_pose: np.ndarray,
        obj_poses_gt: List[np.ndarray],
        timestamp: float,
        n_images: int,
        line_detections: Optional[np.ndarray] = None,
        point_detections: Optional[np.ndarray] = None,
        traj: Optional[np.ndarray] = None,
        next_image: Optional[np.ndarray] = None,
        next_image2: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Track one RGB-D frame; returns the estimated T_cw
        (``System::TrackRGBD``, System.cc:51-64).  ``traj``: optional
        caller-owned (H, W, 3) uint8 BGR canvas on which, for KITTI data,
        the bird's-eye camera square and object centres are drawn in place
        (Tracking.cc:836-907).  ``next_image`` / ``next_image2``: the
        images of frames t+1 and t+2, where the caller has them (a
        prefetching loader does): with ``pipelined_tracking`` frame t+1's
        detectors run during frame t, and the chained mode runs both
        frames' detectors ahead.  They change no result."""

        def to_gray(img):
            if img.ndim != 3:
                return img
            # cvtColor luma weights with the Camera.RGB channel-order flag
            # (Tracking::GrabImageRGBD, Tracking.cc:224-237)
            wts = np.array([0.299, 0.587, 0.114], np.float32)
            if not self.settings.rgb:
                wts = wts[::-1]
            return (img.astype(np.float32) @ wts).round().astype(np.uint8)

        with torch.profiler.record_function("frame"):
            pose = self.tracker.grab_rgbd(
                to_gray(im), depthmap, flowmap, masksem, gt_pose,
                obj_poses_gt, timestamp, n_images,
                line_detections=line_detections,
                point_detections=point_detections,
                next_gray=None if next_image is None else to_gray(next_image),
                next_gray2=(None if next_image2 is None
                            else to_gray(next_image2)),
            )
        if (traj is not None and self.settings.choose_data == KITTI
                and self.map.n_frames > 0):
            from ..utils import traj_canvas

            centres, labels = [], []
            if self.map.rigid_centres:       # one entry per frame PAIR
                centres = self.map.rigid_centres[-1][1:]
                labels = self.map.rm_labels[-1][1:]
            traj_canvas.draw_frame(
                traj, self.map.camera_poses[-1], centres, labels
            )
        return pose

    def save_checkpoint(self, path: str | Path) -> None:
        """Write the whole mid-run state (the map's history and the
        tracker's per-sequence state) so a long sequence can resume in a
        fresh ``System``.  The reference has none (SURVEY.md section 5).
        The file is a pickle of builtins and numpy arrays only, so it names
        no class of this package or the JAX one.  In the resident mode the
        map stream is drained and the device state written back first; the
        resumed run enters the driver again from that host state."""
        t = self.tracker
        t.flush()
        t.sync_host_state()
        tracker = convert.tracker_state(t)
        m = tracker.pop("map")
        blob = dict(tracker=tracker, map={f.name: getattr(m, f.name)
                                          for f in dataclasses.fields(m)})
        with open(path, "wb") as fh:
            pickle.dump(convert.to_plain(blob), fh,
                        protocol=pickle.HIGHEST_PROTOCOL)

    def load_checkpoint(self, path: str | Path) -> None:
        """Resume from a :meth:`save_checkpoint` file: the next
        ``track_rgbd`` continues the sequence where it was written."""
        with open(path, "rb") as fh:
            blob = pickle.load(fh)
        self.tracker.flush()
        self.tracker.sync_host_state()
        convert.tracker_state_from_jax(self.tracker,
                                       dict(blob["tracker"], map=blob["map"]))

    # --- device-level tracing (SURVEY.md section 5, tracing row): the
    # reference has only the wall-clock slots (kept in Map.frame_times);
    # this adds a torch.profiler trace of host ops and device kernels ---
    def start_profiler_trace(self, log_dir: str | Path) -> None:
        """Begin a ``torch.profiler`` trace (host ops, and the card's
        kernels when the tracker is on the card) to be written under
        ``log_dir`` by :meth:`stop_profiler_trace`."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._trace_dir = Path(log_dir)
        self._profiler = torch.profiler.profile(activities=acts)
        self._profiler.start()

    def stop_profiler_trace(self) -> Path:
        """Finish the tracked frames (the resident map stream drains), stop
        the trace and write it as a Chrome trace (Perfetto, TensorBoard)
        under the ``log_dir`` of :meth:`start_profiler_trace`; returns its
        path."""
        self.tracker.flush()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._profiler = self._profiler, None
        prof.stop()
        self._trace_dir.mkdir(parents=True, exist_ok=True)
        path = self._trace_dir / ("sdpl_slam_torch.%d.pt.trace.json"
                                  % time.time_ns())
        prof.export_chrome_trace(str(path))
        return path

    def save_results(self, out_dir: str | Path, plots: bool = False) -> None:
        """Write the 7 result txt files + timing summary
        (System::SaveResults, System.cc:66-244), the Metrix_error.txt
        appends, tracklet histograms, and (optionally) the error plots."""
        from ..utils import plotting

        print("Saving Results into TXT File...")
        writers.save_results(out_dir, self.map)
        print(writers.format_timing_summary(self.map))
        out = Path(out_dir)
        metrics.write_metric_error(self.map, out / "Metrix_error.txt")
        metrics.write_metric_error(
            self.map, out / "Metrix_error.txt", refined=True
        )
        plotting.write_tracklet_histograms(self.map, out)
        if plots:
            plotting.plot_metric_error(self.map, out)

    def metric_error(self, refined: bool = False) -> str:
        return metrics.metric_error_report(self.map, refined=refined)

    def velocity_error(self):
        return metrics.velocity_error(self.map)
