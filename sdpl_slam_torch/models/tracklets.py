"""Tracklet construction from per-frame association arrays.

Replicates ``GetStaticTrack`` / ``GetDynamicTrackNew``
(reference src/Tracking.cc:3325-3510 / :3512-3720): association array
``asso[f][j]`` gives feature j of frame f its index in frame f-1 (or -1).
A chain of associations is a tracklet: a list of (frame, feature) pairs.
Dynamic tracklets additionally record the object tracking label (nObjID).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def build_tracklets(asso: List[np.ndarray]) -> List[List[Tuple[int, int]]]:
    """asso[f][j] = index in frame f-1 of feature j in frame f, or -1.
    asso[0] is ignored (no previous frame).  Returns tracklets as lists of
    (frame, feature) pairs, in creation order like the reference."""
    tracks: List[List[Tuple[int, int]]] = []
    prev_track_of = None  # track id of each feature in frame f-1
    n_frames = len(asso)
    for f in range(1, n_frames):
        a = asso[f]
        cur_track_of = np.full(len(a), -1, np.int64)
        for j, pj in enumerate(a):
            if pj == -1:
                continue
            if prev_track_of is not None and 0 <= pj < len(prev_track_of) \
                    and prev_track_of[pj] != -1:
                tid = prev_track_of[pj]
                tracks[tid].append((f, j))
                cur_track_of[j] = tid
            else:
                tracks.append([(f - 1, int(pj)), (f, j)])
                cur_track_of[j] = len(tracks) - 1
        prev_track_of = cur_track_of
    return tracks


def build_dynamic_tracklets(
    asso: List[np.ndarray], labels: List[np.ndarray]
) -> Tuple[List[List[Tuple[int, int]]], List[int]]:
    """Dynamic variant: only features with tracking label > 0 chain; each
    track records its object label (``nObjID``)."""
    tracks: List[List[Tuple[int, int]]] = []
    obj_ids: List[int] = []
    prev_track_of = None
    n_frames = len(asso)
    for f in range(1, n_frames):
        a = asso[f]
        lab = labels[f]
        cur_track_of = np.full(len(a), -1, np.int64)
        for j, pj in enumerate(a):
            if pj == -1 or lab[j] <= 0:
                continue
            if prev_track_of is not None and 0 <= pj < len(prev_track_of) \
                    and prev_track_of[pj] != -1:
                tid = prev_track_of[pj]
                tracks[tid].append((f, j))
                cur_track_of[j] = tid
            else:
                tracks.append([(f - 1, int(pj)), (f, j)])
                obj_ids.append(int(lab[j]))
                cur_track_of[j] = len(tracks) - 1
        prev_track_of = cur_track_of
    return tracks, obj_ids
