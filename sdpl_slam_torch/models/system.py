"""System facade: the reference's public API surface
(reference include/System.h:41-52, src/System.cc:22-64), as in
``sdpl_slam_tpu.models.system``.

``System(settings, device=...).track_rgbd(...)`` + ``save_results(dir)``.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..io import writers
from ..utils import metrics
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
        (Tracking.cc:836-907).  ``next_image`` / ``next_image2``: the JAX
        package's prefetch hints (frames t+1 and t+2, from which it
        dispatches their detectors early); accepted so the same calling
        loop runs here, and unused, because this package runs each frame's
        detectors synchronously.  In the JAX package they change no
        result either."""

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
