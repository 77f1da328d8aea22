"""MapState: the whole-history store (reference ``Map``,
reference include/Map.h:21-114 -- ~40 parallel vectors, no logic).

Host-side, append-only.  Per-frame entries are numpy arrays (fixed-capacity
feature rows with their validity masks); the batch-BA back-end stacks them
into device tensors when invoked.  Ragged per-frame object lists (motions,
labels) stay python lists exactly like the reference.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class MapState:
    # static features per frame (renewed sets; Map.h vpFeatSta/vfDepSta/...)
    stat_uv: List[np.ndarray] = dataclasses.field(default_factory=list)
    stat_depth: List[np.ndarray] = dataclasses.field(default_factory=list)
    stat_3d: List[np.ndarray] = dataclasses.field(default_factory=list)
    stat_valid: List[np.ndarray] = dataclasses.field(default_factory=list)
    stat_asso: List[np.ndarray] = dataclasses.field(default_factory=list)   # vnAssoSta

    # static lines per frame
    line_uv: List[np.ndarray] = dataclasses.field(default_factory=list)
    line_depth: List[np.ndarray] = dataclasses.field(default_factory=list)
    line_3d: List[np.ndarray] = dataclasses.field(default_factory=list)     # endpoints (6,)
    line_plucker: List[np.ndarray] = dataclasses.field(default_factory=list)
    line_valid: List[np.ndarray] = dataclasses.field(default_factory=list)
    line_asso: List[np.ndarray] = dataclasses.field(default_factory=list)

    # dynamic features per frame
    dyn_uv: List[np.ndarray] = dataclasses.field(default_factory=list)
    dyn_depth: List[np.ndarray] = dataclasses.field(default_factory=list)
    dyn_3d: List[np.ndarray] = dataclasses.field(default_factory=list)
    dyn_valid: List[np.ndarray] = dataclasses.field(default_factory=list)
    dyn_asso: List[np.ndarray] = dataclasses.field(default_factory=list)    # vnAssoDyn
    dyn_label: List[np.ndarray] = dataclasses.field(default_factory=list)   # vnFeatLabel

    # dynamic lines per frame
    dline_uv: List[np.ndarray] = dataclasses.field(default_factory=list)
    dline_depth: List[np.ndarray] = dataclasses.field(default_factory=list)
    dline_3d: List[np.ndarray] = dataclasses.field(default_factory=list)
    dline_plucker: List[np.ndarray] = dataclasses.field(default_factory=list)
    dline_valid: List[np.ndarray] = dataclasses.field(default_factory=list)
    dline_asso: List[np.ndarray] = dataclasses.field(default_factory=list)
    dline_label: List[np.ndarray] = dataclasses.field(default_factory=list)

    # camera trajectory: T_wc (camera-to-world; Map stores inv(mTcw),
    # Tracking.cc:1704-1706)
    camera_poses: List[np.ndarray] = dataclasses.field(default_factory=list)
    camera_poses_rf: List[np.ndarray] = dataclasses.field(default_factory=list)
    camera_poses_gt: List[np.ndarray] = dataclasses.field(default_factory=list)

    # rigid motions per frame: index 0 = camera motion, then one per live
    # object (vmRigidMotion / _RF / _GT, vmObjPosePre, vnRMLabel, vnSMLabel)
    rigid_motions: List[List[np.ndarray]] = dataclasses.field(default_factory=list)
    rigid_motions_rf: List[List[np.ndarray]] = dataclasses.field(default_factory=list)
    rigid_motions_gt: List[List[np.ndarray]] = dataclasses.field(default_factory=list)
    obj_pose_pre: List[List[np.ndarray]] = dataclasses.field(default_factory=list)
    rigid_centres: List[List[np.ndarray]] = dataclasses.field(default_factory=list)
    rm_labels: List[List[int]] = dataclasses.field(default_factory=list)
    sm_labels: List[List[int]] = dataclasses.field(default_factory=list)
    sm_labels_gt: List[List[int]] = dataclasses.field(default_factory=list)
    obj_stat: List[List[bool]] = dataclasses.field(default_factory=list)
    speeds_gt: List[List[float]] = dataclasses.field(default_factory=list)

    # tracklets (built on BA frames): list of tracks, each a list of
    # (frame_id, feature_id) pairs
    tracklet_sta: List[List[tuple]] = dataclasses.field(default_factory=list)
    tracklet_sta_line: List[List[tuple]] = dataclasses.field(default_factory=list)
    tracklet_dyn: List[List[tuple]] = dataclasses.field(default_factory=list)
    tracklet_dyn_line: List[List[tuple]] = dataclasses.field(default_factory=list)
    tracklet_dyn_obj_id: List[int] = dataclasses.field(default_factory=list)   # nObjID
    tracklet_dyn_line_obj_id: List[int] = dataclasses.field(default_factory=list)

    # timing (the five-slot contract + LBA; Map.h fLBA_time / vfAll_time)
    frame_times: List[np.ndarray] = dataclasses.field(default_factory=list)
    lba_times: List[float] = dataclasses.field(default_factory=list)

    # object tracking-time bookkeeping (vnObjTraTime)
    obj_track_time: List[int] = dataclasses.field(default_factory=list)

    @property
    def n_frames(self) -> int:
        return len(self.camera_poses)

    # ------------------------------------------------------------------
    # checkpoint / resume (SURVEY.md section 5: the reference has none --
    # state lives in RAM until SaveResults; here the whole history store
    # serializes to a single npz so long sequences can resume mid-run)
    # ------------------------------------------------------------------
    def save(self, path) -> None:
        import io as _io
        import pickle

        blob = {}
        for f in dataclasses.fields(self):
            blob[f.name] = getattr(self, f.name)
        buf = _io.BytesIO()
        pickle.dump(blob, buf, protocol=pickle.HIGHEST_PROTOCOL)
        with open(path, "wb") as fh:
            fh.write(buf.getvalue())

    @classmethod
    def load(cls, path) -> "MapState":
        import pickle

        with open(path, "rb") as fh:
            blob = pickle.load(fh)
        out = cls()
        for k, v in blob.items():
            setattr(out, k, v)
        return out
