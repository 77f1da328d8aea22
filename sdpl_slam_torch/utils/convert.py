"""Carry state from the JAX package into this one.

There are no weights: what a run carries is its ``Settings`` and the
tracker's per-sequence state -- the fields ``sdpl_slam_tpu``'s
``System.save_checkpoint`` pickles.  With these a JAX run can be stopped
mid-sequence and continued here, and both can take the same next frame
from the same state.  A JAX batch-BA graph converts too, so both packages
can solve the same graph.  Nothing here imports JAX: objects are read by
attribute, arrays through ``np.asarray``.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from ..models.map_state import MapState
from ..solvers.batch_ba import BAGraph
from .config import Settings

TRACKER_FIELDS = ("f_id", "max_id", "velocity", "origin_inv", "last",
                  "last_meta", "last_mask", "last_flow", "oline_label")


def settings_from_jax(jax_settings) -> Settings:
    """Field-by-field copy of a ``sdpl_slam_tpu`` ``Settings``."""
    ours = {f.name for f in dataclasses.fields(Settings)}
    src = dataclasses.asdict(jax_settings)
    missing = ours - set(src)
    if missing:
        raise ValueError("JAX settings lack fields %s" % sorted(missing))
    return Settings(**{k: copy.deepcopy(v) for k, v in src.items() if k in ours})


def line_config_from_jax(jax_cfg):
    """A ``sdpl_slam_tpu.ops.lines.LineDetectConfig`` as this package's."""
    from ..ops.lines import LineDetectConfig

    return LineDetectConfig(**jax_cfg._asdict())


def _host(x):
    """Arrays (numpy or JAX) -> numpy copies, recursively through dicts and
    lists; everything else deep-copied."""
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    if hasattr(x, "__array__") and getattr(x, "ndim", 0) > 0:
        return np.array(x)
    return copy.deepcopy(x)


def jax_tracker_state(jax_system) -> dict:
    """The state ``save_checkpoint`` pickles, read off a JAX ``System``
    (flushed first, so a pipelined frame in flight is finished)."""
    t = jax_system.tracker
    t.flush()
    t.sync_host_state()
    return dict(
        f_id=t.f_id, max_id=t.max_id, velocity=t.velocity,
        origin_inv=t.origin_inv, last=t.last, last_meta=t.last_meta,
        last_mask=t.last_mask_np, last_flow=t.last_flow_np,
        oline_label=getattr(t, "_oline_label", None),
        map=t.map,
    )


def tracker_state_from_jax(tracker, state: dict) -> None:
    """Load ``state`` (the :data:`TRACKER_FIELDS` plus ``map``, as
    :func:`jax_tracker_state` returns or ``save_checkpoint`` pickles under
    "tracker" / "map") into a port ``Tracking``.  The carried state is host
    numpy in both packages; the tracker builds its device tensors from it
    at the next frame."""
    missing = [k for k in TRACKER_FIELDS + ("map",) if k not in state]
    if missing:
        raise ValueError("state lacks %s" % missing)
    tracker.f_id = int(state["f_id"])
    tracker.max_id = int(state["max_id"])
    tracker.velocity = _host(state["velocity"])
    tracker.origin_inv = _host(state["origin_inv"])
    tracker.last = _host(state["last"])
    tracker.last_meta = _host(state["last_meta"])
    tracker.last_mask_np = _host(state["last_mask"])
    tracker.last_flow_np = _host(state["last_flow"])
    if state["oline_label"] is not None:
        tracker._oline_label = _host(state["oline_label"])
    src = state["map"]
    m = MapState()
    for f in dataclasses.fields(MapState):
        setattr(m, f.name, _host(getattr(src, f.name)))
    tracker.map = m


def graph_from_jax(jax_graph, device):
    """A ``sdpl_slam_tpu`` ``BAGraph`` (padded; its padding rows flagged
    invalid) as this package's ``BAGraph`` on ``device``, field by field:
    floats keep their dtype, indices become int64."""
    out = {}
    for name in BAGraph._fields:
        a = np.array(getattr(jax_graph, name))
        if name == "prior_frame":
            out[name] = int(a)
            continue
        if np.issubdtype(a.dtype, np.integer):
            a = a.astype(np.int64)
        out[name] = torch.as_tensor(a, device=device)
    return BAGraph(**out)
