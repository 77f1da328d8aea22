"""Chained tracking: the resident core fed by host-pushed SAMPLES
(counterpart of the JAX package's ``models.chained``).

The device-resident loop (models/resident.py) keeps the feature state on
the device, but takes the dense depth / flow / mask planes every frame.
This mode keeps the same device core (grouping, solves, commit, renewal:
``build_core_stage``) and replaces every dense-plane lookup with values
the host samples at its *shadow* of the device feature positions:

 * The host holds the lagged pulled state (``depth`` - 1 steps behind the
   live device state: the hard-lag generation scheme) and a short ring of
   preprocessed planes, and rolls the pulled positions forward through its
   own flow planes to approximate the live positions.
 * Sample family A: plane values at the rolled base-state row positions
   (one row per base-state feature).  Family B: plane values at the
   previous frame's candidate correspondence positions (one row per
   candidate).  The device gathers per live row by the provenance the
   state carries (``ResidentState.s_asso`` / ``s_cand`` and the rest):
   kept rows read family A at their ancestor row, candidate-born rows
   family B.
 * Family C is the current frame's candidate selections (the host path's
   stat / line / obj / oline tuples): exact, since candidate positions
   are known on the host.
 * Mask recovery (UpdateMask) runs on the host over the rolled base
   object rows; the pushed mask samples come from the recovered mask.

Its approximations against the dense resident mode (sample positions lag
the optimised-flow updates by at most ``depth`` frames of sub-pixel drift;
mask-recovery votes miss features born since the base generation) are the
JAX package's, and tests/test_torch_chained.py holds them to its gates.

Per frame the host copies one bundle (a float32 vector, ``bundle_spec``)
and one small aux buffer (the GT label tables and the RANSAC draws) into
the static input buffers of a :class:`ChainedProgram` (pinned memory, no
blocking copy) and runs it: the counterpart of the JAX package's jitted
``build_chained_step``.  On the CPU the program runs the step eagerly; on
the card it is captured once into CUDA graphs, the joint LMs ending in
WHILE nodes, so a frame is one graph launch and the only host reads are
the lagged output copies.  The detectors of frames t+1 and t+2 run on a
side stream from the caller's ``next_gray`` / ``next_gray2``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..io import native as _native
from ..ops.geometry import Intrinsics
from ..utils.device import to_host_async
from . import frame_host as fh
from .resident import (ResidentDriver, ResidentProgram, StageInputs, _i32,
                       _unpack_aux, build_core_stage, n_hypotheses,
                       out_spec, state_from_host, state_to_host)

_FAMS = (("s", "NS"), ("l", "NLS"), ("o", "NO"), ("ol", "NLO"))


# ---------------------------------------------------------------------------
# bundle spec
# ---------------------------------------------------------------------------

def bundle_spec(caps, depth=2):
    """(name, shape) rows of the packed float32 sample bundle, in order: the
    JAX package's layout row for row, so a bundle packed by either unpacks
    the same.

    Family A (base-state rows) and family B (previous frame's candidates)
    carry raw plane samples; the candidate tuples (family C) are the host
    selections verbatim; ``olc_ok`` is the host-evaluated static-line
    filter over object-line candidates (the reference renewal quirk).  At
    pipeline ``depth`` 3 the base lags one more generation, so rows born
    two frames ago need their own family B2 (candidates of frame t-2,
    positions rolled one flow plane forward)."""
    NS, NLS, NO, NLO = caps["NS"], caps["NLS"], caps["NO"], caps["NLO"]
    fams = ("A", "B") if depth < 3 else ("A", "B", "B2")
    rows = []
    for fam in fams:
        rows += [
            (f"{fam}_s", (NS, 5)),      # inb, d, m, fu, fv
            (f"{fam}_l", (NLS, 11)),    # inb_s, inb_e, ds, de, dm, ms, me, f4
            (f"{fam}_o", (NO, 5)),      # inb, d, m, fu, fv
            (f"{fam}_ol", (NLO, 9)),    # inb_s, inb_e, ds, de, ms, f4
        ]
    rows += [
        ("c_s_uv", (NS, 2)), ("c_s_d", (NS,)), ("c_s_f", (NS, 2)),
        ("c_s_c", (NS, 2)), ("c_s_v", (NS,)),
        ("c_l_uv", (NLS, 4)), ("c_l_d", (NLS, 2)), ("c_l_f", (NLS, 4)),
        ("c_l_c", (NLS, 4)), ("c_l_v", (NLS,)),
        ("c_o_uv", (NO, 2)), ("c_o_d", (NO,)), ("c_o_f", (NO, 2)),
        ("c_o_c", (NO, 2)), ("c_o_s", (NO,)), ("c_o_v", (NO,)),
        ("c_ol_uv", (NLO, 4)), ("c_ol_d", (NLO, 2)), ("c_ol_f", (NLO, 4)),
        ("c_ol_c", (NLO, 4)), ("c_ol_s", (NLO,)), ("c_ol_v", (NLO,)),
        ("olc_ok", (NLO,)),
        ("f00", (2,)),                  # flow[0,0] (invalid-row fixups)
    ]
    return rows


def _numel(shape):
    return int(np.prod(shape, dtype=np.int64))


def bundle_size(caps, depth=2):
    return sum(_numel(shape) for _, shape in bundle_spec(caps, depth))


def _unpack_bundle(buf, caps, depth=2):
    """Views of a bundle (a tensor or an array) by name."""
    out, o = {}, 0
    for name, shape in bundle_spec(caps, depth):
        k = _numel(shape)
        out[name] = buf[o:o + k].reshape(shape)
        o += k
    return out


# ---------------------------------------------------------------------------
# device side: provenance gathers and sampled filters
# ---------------------------------------------------------------------------

def _rows(table, idx):
    """``table`` rows at ``idx`` clipped into range (``jnp.clip`` then a
    gather, as the JAX package reads them)."""
    return table[idx.clamp(0, table.shape[0] - 1).to(torch.int64)]


def _gather_prov(A, B, asso, cand):
    """Per live row: family A at the ancestor row if kept, else family B
    at the candidate row.  Rows with neither (never a valid row) read
    A[0]."""
    return torch.where((asso >= 0)[:, None], _rows(A, asso), _rows(B, cand))


def _gather_prov3(A, B1, B2, a2, c1, c2):
    """Depth-3 provenance gather.  Rows born last frame read family B1 at
    their candidate row (c1 >= 0 implies a2 = c2 = -1); rows born two
    frames ago read family B2 at their grandparent candidate row;
    everything older reads family A at its 2-step composed ancestor row in
    the base generation."""
    old = torch.where((c2 >= 0)[:, None], _rows(B2, c2), _rows(A, a2))
    return torch.where((c1 >= 0)[:, None], _rows(B1, c1), old)


def identity_prov(caps, device):
    """Depth-3 side provenance at a rebase point: every live row is its
    own base-generation row (a2 = identity), nothing is candidate-born
    within the window (c2 = -1)."""
    out = {}
    for fam, cap in _FAMS:
        n = caps[cap]
        out[f"a2_{fam}"] = torch.arange(n, dtype=torch.int32, device=device)
        out[f"c2_{fam}"] = torch.full((n,), -1, dtype=torch.int32,
                                      device=device)
    return out


def _compose_prov(state_prev, new_state, caps):
    """Next side provenance: this step's 1-deep keep indices
    (``new_state.*_asso``, rows of ``state_prev``) composed with
    ``state_prev``'s own 1-deep provenance -> 2-deep pointers (a2 -> the
    generation before ``state_prev``, the depth-3 base at the next frame's
    gather; c2 -> the candidate set of ``state_prev``'s birth frame)."""
    out = {}
    for fam, cap in _FAMS:
        k = getattr(new_state, f"{fam}_asso")
        neg = torch.full_like(k, -1)
        out[f"a2_{fam}"] = torch.where(
            k >= 0, _rows(getattr(state_prev, f"{fam}_asso"), k), neg)
        out[f"c2_{fam}"] = torch.where(
            k >= 0, _rows(getattr(state_prev, f"{fam}_cand"), k), neg)
    return out


def _bounds_pt(uv, h, w):
    x = uv[..., 0].to(torch.int32)
    y = uv[..., 1].to(torch.int32)
    return (x > 0) & (x < w - 1) & (y > 0) & (y < h - 1)


class SampledFilts:
    """The renewal filters over host-pushed samples (``DenseFilts``'s
    sampled twin).  ``sv / lv / ov / olv`` are the provenance-gathered
    sample rows of the live state's stat / line / obj / oline rows; ``b``
    is the unpacked bundle (the candidate tuples are read from it)."""

    def __init__(self, cfg, hw, b, sv, lv, ov, olv):
        self.cfg, self.hw, self.b = cfg, hw, b
        self.sv, self.lv, self.ov, self.olv = sv, lv, ov, olv

    # ---- state rows ----
    def stat_state(self, uv):
        h, w = self.hw
        inb_s, d = self.sv[:, 0], self.sv[:, 1]
        m, f = self.sv[:, 2], self.sv[:, 3:5]
        corr = uv + f
        ok = (_bounds_pt(uv, h, w) & (inb_s > 0.5)
              & (m == 0) & (d > 0) & (d <= 40.0)
              & (f[:, 0] != 0) & (f[:, 1] != 0)
              & (corr[:, 0] < w) & (corr[:, 0] > 0)
              & (corr[:, 1] < h) & (corr[:, 1] > 0))
        return ok, d, f, corr

    def line_state(self, uv4):
        h, w = self.hw
        inb_s, inb_e, ds, de, dm, ms, me = self.lv[:, :7].unbind(1)
        f4 = self.lv[:, 7:11]
        corr = uv4 + f4
        ln = torch.linalg.norm(uv4[:, 2:] - uv4[:, :2], dim=-1)
        disc = torch.abs(dm - 0.5 * (ds + de)) <= 10.0 * ln / 1000.0
        degen = ((torch.abs(uv4[:, 0] - uv4[:, 2]) < 1e-6)
                 & (torch.abs(uv4[:, 1] - uv4[:, 3]) < 1e-6))
        ok = (_bounds_pt(uv4[:, :2], h, w) & _bounds_pt(uv4[:, 2:], h, w)
              & (inb_s > 0.5) & (inb_e > 0.5) & ~degen
              & (ms == 0) & (me == 0)
              & (ds > 0) & (ds <= 40.0) & (de > 0) & (de <= 40.0) & disc
              & (corr[:, 0] > 0) & (corr[:, 0] < w)
              & (corr[:, 1] > 0) & (corr[:, 1] < h)
              & (corr[:, 2] > 0) & (corr[:, 2] < w)
              & (corr[:, 3] > 0) & (corr[:, 3] < h))
        return ok, torch.stack([ds, de], 1), f4, corr

    def obj_state(self, uv):
        h, w = self.hw
        inb_s, d = self.ov[:, 0], self.ov[:, 1]
        mi, f = self.ov[:, 2].to(torch.int32), self.ov[:, 3:5]
        corr = uv + f
        ok = (_bounds_pt(uv, h, w) & (inb_s > 0.5)
              & (mi != 0) & (d > 0) & (d < self.cfg.th_depth_obj)
              & (corr[:, 0] < w) & (corr[:, 0] > 0)
              & (corr[:, 1] < h) & (corr[:, 1] > 0))
        return ok, mi, d, f, corr

    # ---- candidate rows (positions exact; the selections already passed
    # the mask and bounds gates at these positions) ----
    def stat_cand(self, uv):
        h, w = self.hw
        b = self.b
        d, f, c = b["c_s_d"], b["c_s_f"], b["c_s_c"]
        ok = ((b["c_s_v"] > 0.5) & (d > 0) & (d <= 40.0)
              & (f[:, 0] != 0) & (f[:, 1] != 0)
              & (c[:, 0] < w) & (c[:, 0] > 0)
              & (c[:, 1] < h) & (c[:, 1] > 0))
        return ok, d, f, c

    def line_cand(self, uv4):
        h, w = self.hw
        b = self.b
        d2, f4, c4 = b["c_l_d"], b["c_l_f"], b["c_l_c"]
        ok = ((b["c_l_v"] > 0.5)
              & (d2[:, 0] > 0) & (d2[:, 0] <= 40.0)
              & (d2[:, 1] > 0) & (d2[:, 1] <= 40.0)
              & (c4[:, 0] > 0) & (c4[:, 0] < w)
              & (c4[:, 1] > 0) & (c4[:, 1] < h)
              & (c4[:, 2] > 0) & (c4[:, 2] < w)
              & (c4[:, 3] > 0) & (c4[:, 3] < h))
        return ok, d2, f4, c4

    def obj_cand(self, uv):
        h, w = self.hw
        b = self.b
        d, f, c = b["c_o_d"], b["c_o_f"], b["c_o_c"]
        m = b["c_o_s"].to(torch.int32)
        ok = ((b["c_o_v"] > 0.5) & (m != 0) & (d > 0)
              & (d < self.cfg.th_depth_obj)
              & (c[:, 0] < w) & (c[:, 0] > 0)
              & (c[:, 1] < h) & (c[:, 1] > 0))
        return ok, m, d, f, c

    def oline_cand_ok(self, uv4):
        return self.b["olc_ok"] > 0.5

    def flow4(self, uv4):
        """Flow at the kept object-line rows: the gathered samples."""
        return self.olv[:, 5:9]

    def flow4_final(self, uv4, carried_f4, valid):
        """Flow at the merged object-line rows: the carried samples, and
        flow[0, 0] where a row is invalid (the dense lookup's value at
        the zeroed position)."""
        fill = torch.cat([self.b["f00"], self.b["f00"]])[None, :]
        return torch.where(valid[:, None], carried_f4, fill)


def _inherit_sampled(cfg, state, sv, lv, ov, olv):
    """Sampled twin of ``resident.inherit_dev`` (Tracking.cc:269-473)."""
    th = cfg.th_depth_obj
    s_d = torch.where((sv[:, 0] > 0.5) & (sv[:, 1] > 0), sv[:, 1],
                      torch.full_like(sv[:, 1], -1.0))
    l_ok = ((lv[:, 0] > 0.5) & (lv[:, 1] > 0.5) & (lv[:, 2] > 0)
            & (lv[:, 3] > 0))
    l_d = torch.where(l_ok[:, None], lv[:, 2:4],
                      torch.full_like(lv[:, 2:4], -1.0))
    o_ok = (ov[:, 0] > 0.5) & (ov[:, 1] < th) & (ov[:, 1] > 0)
    o_d = torch.where(o_ok, ov[:, 1], torch.full_like(ov[:, 1], 0.1))
    o_sem = torch.where(o_ok, ov[:, 2].to(torch.int32),
                        torch.zeros((), dtype=torch.int32, device=ov.device))
    ol_ok = ((olv[:, 0] > 0.5) & (olv[:, 1] > 0.5)
             & (olv[:, 2] > 0) & (olv[:, 2] < th)
             & (olv[:, 3] > 0) & (olv[:, 3] < th))
    ol_d = torch.where(ol_ok[:, None], olv[:, 2:4],
                       torch.full_like(olv[:, 2:4], 0.1))
    ol_sem = torch.where(ol_ok, olv[:, 4].to(torch.int32),
                         torch.zeros((), dtype=torch.int32,
                                     device=olv.device))
    return (state.s_c, s_d, state.l_c, l_d, state.o_c, o_d, o_sem,
            state.ol_c, ol_d, ol_sem)


def _ltf_sampled(state, lv):
    """Sampled twin of ``resident.line_track_filter_dev``."""
    uv4 = state.l_c
    ds, de, dm, ms, me = lv[:, 2], lv[:, 3], lv[:, 4], lv[:, 5], lv[:, 6]
    length = torch.linalg.norm(uv4[:, 2:] - uv4[:, :2], dim=-1)
    ok = ((torch.abs(dm - 0.5 * (ds + de)) <= 10.0 * length / 1000.0)
          & (ms == 0) & (me == 0))
    return state.l_valid & ok


def build_chained_step(cfg, K: Intrinsics, caps: dict, hw, depth=2):
    """The chained per-frame step: unpack the bundle -> provenance gathers
    -> sampled inherit and filters -> the shared core stage.

        depth 2: step(state, bundle, gt_sem_prev, gt_sem_cur, u_cam, u_obj)
                 -> (new_state, out_buf, lm_host_syncs)
        depth 3: step(state, prov, bundle, gt_sem_prev, gt_sem_cur, u_cam,
                      u_obj) -> (new_state, new_prov, out_buf, syncs)

    ``depth`` is the software-pipeline depth (frames in flight + 1).  At
    depth 2 the state's own 1-deep asso / cand provenance addresses
    families A / B.  At depth 3 the base generation lags one more frame,
    so the step carries a side ``prov`` dict of 2-deep composed pointers
    (a2 / c2 per family) and gathers across families A / B2 / B1.  The
    RANSAC draws ``u_cam`` / ``u_obj`` are inputs, as in the resident
    step."""
    core = build_core_stage(cfg, K, caps)

    def run_core(state, b, gt_sem_prev, gt_sem_cur, u_cam, u_obj,
                 sv, lv, ov, olv):
        si = StageInputs(
            stat_tmp=(b["c_s_uv"], b["c_s_d"], b["c_s_f"], b["c_s_c"],
                      b["c_s_v"] > 0.5),
            line_tmp=(b["c_l_uv"], b["c_l_d"], b["c_l_f"], b["c_l_c"],
                      b["c_l_v"] > 0.5),
            obj_tmp=(b["c_o_uv"], b["c_o_d"], b["c_o_f"], b["c_o_c"],
                     b["c_o_s"].to(torch.int32), b["c_o_v"] > 0.5),
            oline_tmp=(b["c_ol_uv"], b["c_ol_d"], b["c_ol_f"], b["c_ol_c"],
                       b["c_ol_s"].to(torch.int32), b["c_ol_v"] > 0.5),
            inh=_inherit_sampled(cfg, state, sv, lv, ov, olv),
            line_ok0=_ltf_sampled(state, lv))
        filts = SampledFilts(cfg, hw, b, sv, lv, ov, olv)
        return core(state, si, filts, hw, gt_sem_prev, gt_sem_cur, u_cam,
                    u_obj, state.last_mask, state.last_flow)

    def step(state, bundle, gt_sem_prev, gt_sem_cur, u_cam, u_obj):
        b = _unpack_bundle(bundle, caps)
        g = [_gather_prov(b[f"A_{fam}"], b[f"B_{fam}"],
                          getattr(state, f"{fam}_asso"),
                          getattr(state, f"{fam}_cand"))
             for fam, _ in _FAMS]
        return run_core(state, b, gt_sem_prev, gt_sem_cur, u_cam, u_obj, *g)

    def step3(state, prov, bundle, gt_sem_prev, gt_sem_cur, u_cam, u_obj):
        b = _unpack_bundle(bundle, caps, depth=3)
        g = [_gather_prov3(b[f"A_{fam}"], b[f"B_{fam}"], b[f"B2_{fam}"],
                           prov[f"a2_{fam}"], getattr(state, f"{fam}_cand"),
                           prov[f"c2_{fam}"])
             for fam, _ in _FAMS]
        new_state, out, syncs = run_core(state, b, gt_sem_prev, gt_sem_cur,
                                         u_cam, u_obj, *g)
        return new_state, _compose_prov(state, new_state, caps), out, syncs

    return step3 if depth >= 3 else step


def chained_aux_spec(caps, n_cam: int, n_obj: int):
    """(name, shape) rows of the step's small inputs, packed into one
    float32 buffer: the GT label tables and the RANSAC draws of the
    camera and the ``MAXO`` object lanes."""
    return [("gt_prev", (16,)), ("gt_cur", (16,)), ("u_cam", (n_cam, 3)),
            ("u_obj", (caps["MAXO"], n_obj, 3))]


def build_chained_frame(cfg, K: Intrinsics, caps: dict, hw, depth=2):
    """:func:`build_chained_step` over the program's inputs: the bundle
    and the packed ``aux`` of :func:`chained_aux_spec`.

        depth 2: run(state, bundle, aux) -> (new_state, out_buf, syncs)
        depth 3: run(state, prov, bundle, aux)
                 -> (new_state, new_prov, out_buf, syncs)"""
    step = build_chained_step(cfg, K, caps, hw, depth)
    spec = chained_aux_spec(caps, *n_hypotheses(cfg))

    def small(aux):
        a = _unpack_aux(aux, spec)
        return (_i32(a["gt_prev"]), _i32(a["gt_cur"]), a["u_cam"],
                a["u_obj"])

    if depth >= 3:
        def run3(state, prov, bundle, aux):
            return step(state, prov, bundle, *small(aux))
        return run3

    def run(state, bundle, aux):
        return step(state, bundle, *small(aux))
    return run


def _carried(state, prov) -> list:
    """The chained step's carried buffers in one order: the state, then
    the provenance by name."""
    return list(state) + [prov[k] for k in sorted(prov)]


class ChainedProgram(ResidentProgram):
    """The chained step over static buffers: a :class:`ResidentProgram`
    whose carried state also holds, at depth 3, the side provenance
    ``prov`` (a2 / c2 per family; empty at depth 2).  A call runs the step
    and then writes the new state and the new provenance into their
    buffers (the provenance is composed from the state before the step,
    inside the step).  Eager on the CPU and as the card's plain version;
    on the card captured once into CUDA graphs at its first call."""

    captures = 0

    def __init__(self, run, template, prov_template: dict, inputs: dict,
                 out_numel: int, device, graph: bool = False):
        super().__init__(run, template, inputs, out_numel, device, graph)
        self.prov = {k: torch.zeros(t.shape, dtype=t.dtype,
                                    device=self.device)
                     for k, t in prov_template.items()}

    def held(self) -> list:
        return _carried(self.state, self.prov)

    def _step(self) -> int:
        if self.prov:
            new_state, new_prov, out, syncs = self.run(self.state, self.prov,
                                                       **self.inp)
        else:
            new_state, out, syncs = self.run(self.state, **self.inp)
            new_prov = {}
        for dst, src in zip(self.state, new_state):
            dst.copy_(src)
        for k, t in new_prov.items():
            self.prov[k].copy_(t)
        self.out.copy_(out)
        return syncs

    def eager_twin(self) -> "ChainedProgram":
        return ChainedProgram(
            self.run, self.state, self.prov,
            {k: (tuple(t.shape), t.dtype) for k, t in self.inp.items()},
            self.out.numel(), self.device, graph=False)


# chained programs, shared across identically configured drivers (on the
# card a capture takes a second); the drivers hand the buffers over
_CHAINED_PROGRAMS: dict = {}


def chained_program(cfg, K: Intrinsics, caps: dict, hw, depth: int,
                    template, prov_template: dict, inputs: dict,
                    device) -> ChainedProgram:
    """The memoized chained-step program on ``device``, keyed as the JAX
    package's ``_CHAINED_STEP_MEMO`` (settings, caps, image size, depth)
    and on the state, provenance and input shapes and the device.  A
    graph program on the card, captured at its first call; an eager one
    on the CPU."""
    dev = torch.device(device)
    key = (repr(cfg), (K.fx, K.fy, K.cx, K.cy), repr(sorted(caps.items())),
           tuple(hw), depth,
           tuple((tuple(t.shape), t.dtype) for t in template),
           tuple((k, tuple(t.shape)) for k, t in sorted(prov_template.items())),
           tuple((k, tuple(s), d) for k, (s, d) in sorted(inputs.items())),
           str(dev))
    prog = _CHAINED_PROGRAMS.get(key)
    if prog is None:
        n_out = sum(_numel(shape) for _, shape, _ in out_spec(caps))
        prog = _CHAINED_PROGRAMS[key] = ChainedProgram(
            build_chained_frame(cfg, K, caps, hw, depth), template,
            prov_template, inputs, n_out, dev, graph=dev.type == "cuda")
    return prog


# ---------------------------------------------------------------------------
# host side: shadow sampling (numpy, or the native library where it loads)
# ---------------------------------------------------------------------------

def _np_floor_lookup(plane, uv):
    """Host twin of ``resident._lookup``: floor indices and the
    open-interval bounds -> (values, inb)."""
    h, w = plane.shape[:2]
    u = np.floor(uv[..., 0]).astype(np.int32)
    v = np.floor(uv[..., 1]).astype(np.int32)
    inb = (u > 0) & (u < w - 1) & (v > 0) & (v < h - 1)
    vals = plane[np.clip(v, 0, h - 1), np.clip(u, 0, w - 1)]
    return vals, inb


def _flat_idx(plane_shape, q):
    """Floor, clip and flatten one position set -> (flat_idx, inb); the
    per-plane gathers reuse it."""
    h, w = plane_shape
    u = np.floor(q[..., 0]).astype(np.int32)
    v = np.floor(q[..., 1]).astype(np.int32)
    inb = (u > 0) & (u < w - 1) & (v > 0) & (v < h - 1)
    np.clip(u, 0, w - 1, out=u)
    np.clip(v, 0, h - 1, out=v)
    return v * w + u, inb


def _sample_point_rows(depth, flow, mask, q):
    """(N, 5) family rows [inb, d, m, fu, fv] at positions q."""
    out = _native.sample_point_rows(depth, flow, mask, q)
    if out is not None:
        return out
    idx, inb = _flat_idx(mask.shape, q)
    out = np.empty((len(q), 5), np.float32)
    out[:, 0] = inb
    out[:, 1] = depth.ravel()[idx]
    out[:, 2] = mask.ravel()[idx]
    out[:, 3:5] = flow.reshape(-1, 2)[idx]
    return out


def _sample_line_rows(depth, flow, mask, q4):
    """(N, 11) family rows [inb_s, inb_e, ds, de, dm, ms, me, f4]."""
    out = _native.sample_line_rows(depth, flow, mask, q4)
    if out is not None:
        return out
    qs, qe = q4[:, :2], q4[:, 2:]
    i_s, inb_s = _flat_idx(mask.shape, qs)
    i_e, inb_e = _flat_idx(mask.shape, qe)
    i_m, _ = _flat_idx(mask.shape, 0.5 * (qs + qe))
    df, mf, ff = depth.ravel(), mask.ravel(), flow.reshape(-1, 2)
    out = np.empty((len(q4), 11), np.float32)
    out[:, 0] = inb_s
    out[:, 1] = inb_e
    out[:, 2] = df[i_s]
    out[:, 3] = df[i_e]
    out[:, 4] = df[i_m]
    out[:, 5] = mf[i_s]
    out[:, 6] = mf[i_e]
    out[:, 7:9] = ff[i_s]
    out[:, 9:11] = ff[i_e]
    return out


def _sample_oline_rows(depth, flow, mask, q4):
    """(N, 9) family rows [inb_s, inb_e, ds, de, ms, f4]."""
    out = _native.sample_oline_rows(depth, flow, mask, q4)
    if out is not None:
        return out
    i_s, inb_s = _flat_idx(mask.shape, q4[:, :2])
    i_e, inb_e = _flat_idx(mask.shape, q4[:, 2:])
    df, ff = depth.ravel(), flow.reshape(-1, 2)
    out = np.empty((len(q4), 9), np.float32)
    out[:, 0] = inb_s
    out[:, 1] = inb_e
    out[:, 2] = df[i_s]
    out[:, 3] = df[i_e]
    out[:, 4] = mask.ravel()[i_s]
    out[:, 5:7] = ff[i_s]
    out[:, 7:9] = ff[i_e]
    return out


def _np_filt_line_ok(uv4, depth, flow, mask):
    """Host twin of ``resident._filt_line``'s ok flag (the object-line
    candidate gate, the reference renewal quirk)."""
    h, w = mask.shape
    xs = uv4[:, 0].astype(np.int32)
    ys = uv4[:, 1].astype(np.int32)
    xe = uv4[:, 2].astype(np.int32)
    ye = uv4[:, 3].astype(np.int32)
    inb = ((xs > 0) & (xs < w - 1) & (ys > 0) & (ys < h - 1)
           & (xe > 0) & (xe < w - 1) & (ye > 0) & (ye < h - 1))
    xsc, ysc = np.clip(xs, 0, w - 1), np.clip(ys, 0, h - 1)
    xec, yec = np.clip(xe, 0, w - 1), np.clip(ye, 0, h - 1)
    ms, me = mask[ysc, xsc], mask[yec, xec]
    ds, de = depth[ysc, xsc], depth[yec, xec]
    xm = np.clip((xs + xe) // 2, 0, w - 1)
    ym = np.clip((ys + ye) // 2, 0, h - 1)
    dm = depth[ym, xm]
    ln = np.sqrt(((xs - xe) ** 2 + (ys - ye) ** 2).astype(np.float32))
    disc = np.abs(dm - 0.5 * (ds + de)) <= 10.0 * ln / 1000.0
    corr = uv4 + np.concatenate([flow[ysc, xsc], flow[yec, xec]], axis=1)
    degen = ((np.abs(uv4[:, 0] - uv4[:, 2]) < 1e-6)
             & (np.abs(uv4[:, 1] - uv4[:, 3]) < 1e-6))
    return (inb & ~degen & (ms == 0) & (me == 0)
            & (ds > 0) & (ds <= 40.0) & (de > 0) & (de <= 40.0) & disc
            & (corr[:, 0] > 0) & (corr[:, 0] < w)
            & (corr[:, 1] > 0) & (corr[:, 1] < h)
            & (corr[:, 2] > 0) & (corr[:, 2] < w)
            & (corr[:, 3] > 0) & (corr[:, 3] < h))


def _rolled_positions(q, flow_p, stride):
    """Positions ``q`` (rows of ``stride`` = 2 or 4 coordinates) advanced
    one frame through ``flow_p``, as a new array."""
    out = np.ascontiguousarray(q, np.float32).copy()
    if _native.roll_positions(flow_p, out, stride):
        return out
    if stride == 2:
        f, _ = _np_floor_lookup(flow_p, out)
        return (out + f).astype(np.float32)
    fs, _ = _np_floor_lookup(flow_p, out[:, :2])
    fe, _ = _np_floor_lookup(flow_p, out[:, 2:])
    return (out + np.concatenate([fs, fe], 1)).astype(np.float32)


def _sample_families(depth, flow, mask, pos):
    """One family's four sample tables at positions ``pos`` (s, l, o, ol)."""
    return dict(s=_sample_point_rows(depth, flow, mask, pos["s"]),
                l=_sample_line_rows(depth, flow, mask, pos["l"]),
                o=_sample_point_rows(depth, flow, mask, pos["o"]),
                ol=_sample_oline_rows(depth, flow, mask, pos["ol"]))


_STRIDE = dict(s=2, l=4, o=2, ol=4)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

class ChainedDriver(ResidentDriver):
    """Chained-mode driver: the resident core and host shadow sampling.

    Generation scheme (hard lag): before frame t's family-A build the host
    drains step outputs until at most ``depth - 1`` are pending, so its
    base is exactly the state the live device rows' provenance refers to
    (generation t - depth).  Depth 2 uses the state's own 1-deep asso /
    cand; depth 3 also carries the composed 2-deep side provenance
    (``self.prov``) and a second candidate family B2.  Depth 3 hides one
    more frame of dispatch-to-result latency at the cost of one more frame
    of shadow staleness in the sampled positions and mask-recovery votes.

    A window BA drains everything first (its refined pose goes back into
    the device state) and so does every reader of the map: after a full
    drain the host base is the live state, and the provenance is reset to
    the identity.  The stop frame's own window runs at the final drain, as
    in the port's resident driver.

    The step runs over a :class:`ChainedProgram` (shared by identically
    configured drivers, handed over as the resident driver's program is):
    ``state`` and, at depth 3, ``prov`` are its buffers, so everything
    that writes them from outside (the window BA's pose, the rebase to the
    identity) writes in place."""

    def __init__(self, tracker):
        super().__init__(tracker)
        depth = int(getattr(tracker.cfg, "chained_depth", 2) or 2)
        self.depth = max(2, min(3, depth))
        self.LAG = self.depth - 1   # most pending AFTER the pre-frame drain
        self.base = None            # the base generation's object rows
        self.base_pos = None        # rolled positions, per family
        self.base_pos_frame = -1    # the frame base_pos lives in
        self.planes = {}            # frame -> (depth_pre, flow, mask_rec)
        self.prev_cands = None      # (stat, line, obj, oline) candidates
        self.prev_cands2 = None     # the generation before prev_cands
        self.prov = {}              # depth-3 composed side provenance
        self._det_pending = {}      # frame -> (needs, detector handle)
        self._hw = None
        # per-section wall ms of each frame, section -> [ms, ...], when
        # SDPL_CHAINED_PERF is set (the bench reads them); None otherwise
        self.perf = {} if os.environ.get("SDPL_CHAINED_PERF") else None
        self.last_bundle = None     # the bundle last loaded (the bench's probe)

    # -- mode transitions ----------------------------------------------
    def enter(self):
        tr = self.tr
        self._leave_program()
        h, w = tr.last_mask_np.shape
        self._hw = (h, w)
        # the dense mirrors are not read in this mode
        self.state = state_from_host(
            tr.last, tr.last_meta, tr.max_id, tr.velocity,
            np.zeros((1, 1), np.int32), np.zeros((1, 1, 2), np.float32),
            tr.MAXO, tr.device)
        self._prev_gt = (tr.last.get("gt_objs", []), tr.last["pose_gt"])
        self._last_pose = np.asarray(tr.last["pose"])
        last = tr.last
        self.base = dict(o_sem=last["obj_sem"], o_valid=last["obj_valid"])
        self.base_pos = dict(
            s=np.array(last["stat_corres"], np.float32),
            l=np.array(last["line_corres"], np.float32),
            o=np.array(last["obj_corres"], np.float32),
            ol=np.array(last["oline_corres"], np.float32))
        self.base_pos_frame = tr.f_id       # corres live in the new frame
        # the previous frame's planes, for rolling and mask recovery
        self.planes[tr.f_id - 1] = (tr.depth_np, tr.last_flow_np,
                                    tr.last_mask_np)
        self.prev_cands = self.prev_cands2 = None
        self.prov = (identity_prov(self.caps, tr.device)
                     if self.depth >= 3 else {})
        self._det_pending = {}

    def exit(self):
        """Drain everything and write the device state back to the host
        tracker; the host planes are the authoritative mirrors here."""
        tr = self.tr
        self.drain_all()
        last, meta, max_id = state_to_host(self.state)
        last["pose_gt"] = self._prev_gt[1]
        last["gt_objs"] = self._prev_gt[0]
        tr.last, tr.last_meta, tr.max_id = last, meta, max_id
        tr.velocity = self.state.velocity.cpu().numpy()
        _, flow_l, mask_l = self.planes[max(self.planes)]
        tr.last_mask_np = np.array(mask_l)
        tr.last_flow_np = np.array(flow_l)
        tr.mask_np = tr.last_mask_np.copy()
        self._drop_program()
        self.state = None

    # -- the program and its buffers -------------------------------------
    def _held(self) -> list:
        return _carried(self.state, self.prov)

    def _take(self, prog, clone=False):
        super()._take(prog, clone)
        self.prov = ({k: t.clone() for k, t in prog.prov.items()}
                     if clone else prog.prov)

    def _step_program(self, inputs) -> ChainedProgram:
        """The shared program of this driver's settings, depth and shapes
        (a graph on the card), holding this driver's state."""
        tr = self.tr
        return self._hold(chained_program(
            tr.cfg, tr.K, self.caps, self._hw, self.depth, self.state,
            self.prov, inputs, tr.device))

    def _rebase_identity(self):
        """After a full drain the host base is the live device state: reset
        the device provenance to the identity so family-A gathers stay
        aligned.  In place: a captured step reads these buffers."""
        dev = self.tr.device
        for fam, cap in _FAMS:
            ident = torch.arange(self.caps[cap], dtype=torch.int32,
                                 device=dev)
            getattr(self.state, f"{fam}_asso").copy_(ident)
            getattr(self.state, f"{fam}_cand").fill_(-1)
            if self.prov:
                self.prov[f"a2_{fam}"].copy_(ident)
                self.prov[f"c2_{fam}"].fill_(-1)

    def _set_base_from_out(self, o, frame):
        """Adopt a drained step output (the state of ``frame``) as the new
        base generation; its positions are the rows' correspondences,
        uv + flow(frame)[uv], which live in frame + 1."""
        self.base = dict(o_sem=o["obj_sem"], o_valid=o["obj_valid"])
        flow_p = self.planes[frame][1]

        def corres(uv):
            if uv.shape[1] == 2:
                f, _ = _np_floor_lookup(flow_p, uv)
            else:
                f = np.concatenate([_np_floor_lookup(flow_p, uv[:, :2])[0],
                                    _np_floor_lookup(flow_p, uv[:, 2:])[0]],
                                   1)
            return (uv + f).astype(np.float32)

        self.base_pos = dict(s=corres(o["stat_uv"]), l=corres(o["line_uv"]),
                             o=corres(o["obj_uv"]),
                             ol=corres(o["oline_uv"]))
        self.base_pos_frame = frame + 1

    def _roll_base_to(self, frame):
        """Advance ``base_pos`` through the stored flow planes to
        ``frame``."""
        while self.base_pos_frame < frame:
            flow_p = self.planes[self.base_pos_frame][1]
            self.base_pos = {fam: _rolled_positions(q, flow_p, _STRIDE[fam])
                             for fam, q in self.base_pos.items()}
            self.base_pos_frame += 1

    def _host_mask_recovery(self, mask, f_id):
        """Host twin of UpdateMask (Tracking.cc:4730-4810) over the rolled
        base object rows (features born since the base generation do not
        vote)."""
        prev = self.planes.get(f_id - 1)
        if prev is None:
            return mask
        _, last_flow, last_mask = prev
        h, w = mask.shape
        o_sem = np.asarray(self.base["o_sem"])
        valid = np.asarray(self.base["o_valid"]).astype(bool) & (o_sem > 0)
        q = self.base_pos["o"]
        u = np.floor(q[:, 0]).astype(np.int32)
        v = np.floor(q[:, 1]).astype(np.int32)
        inb = (u > 0) & (u < w) & (v > 0) & (v < h)
        samples = mask[np.clip(v, 0, h - 1), np.clip(u, 0, w - 1)]
        recover = []
        for lab in np.unique(o_sem[valid]):
            sel = valid & (o_sem == lab) & inb
            if sel.sum() < 100:
                continue
            vals, counts = np.unique(samples[sel], return_counts=True)
            if len(vals) and vals[np.argmax(counts)] == 0:
                recover.append(int(lab))
        if not recover:
            return mask
        ys, xs = np.nonzero(np.isin(last_mask, recover))
        nx = xs + last_flow[ys, xs, 0].astype(np.int32)
        ny = ys + last_flow[ys, xs, 1].astype(np.int32)
        ok = (nx > 0) & (nx < w) & (ny > 0) & (ny < h)
        # ascending-label overwrite by a scatter-max, as update_mask_dev
        splat = np.zeros_like(mask)
        np.maximum.at(splat, (ny[ok], nx[ok]), last_mask[ys[ok], xs[ok]])
        return np.where(splat > 0, splat, mask)

    # -- per frame -----------------------------------------------------
    def track(self, gray, depth_raw, flow, mask, pose_gt, gt_objs, timing,
              f_id, n_images, stop_frame, line_detections=None,
              point_detections=None, next_gray=None, next_gray2=None):
        """One frame through the chained step; returns the most recently
        drained camera pose (T_cw), until the last frame.  With ``perf`` on,
        the wall ms of each section are appended to it under the JAX
        driver's names, each section ending where the JAX driver marks it."""
        from .tracking import _np_preprocess_depth

        tr, cfg = self.tr, self.tr.cfg
        t_all = time.perf_counter()
        perf, last = self.perf, [t_all]

        def mark(name):
            now = time.perf_counter()
            perf.setdefault(name, []).append((now - last[0]) * 1e3)
            last[0] = now
        # the detectors of the next two frames first: their device work
        # runs on the side stream while the host samples this frame
        need = (cfg.use_sample_fea == 0 and point_detections is None,
                line_detections is None and cfg.use_lines)
        if any(need):
            for fr_, g in ((f_id + 1, next_gray), (f_id + 2, next_gray2)):
                if g is not None and fr_ not in self._det_pending:
                    self._det_pending[fr_] = (
                        need, tr._dispatch_detectors(g, *need))

        # the previous frame's window BA completes before this dispatch:
        # the refined pose feeds this frame's solve
        if self._lba_trigger(f_id - 1):
            self.drain_all()
            self._run_partial_ba(f_id - 1)
        if perf is not None:
            mark("dispatch_det")

        # ---- hard-lag drain: the base must be exactly the provenance
        # generation of the live state.  The output comes home by the copy
        # to_host_async started; there is no pull thread, so this is where
        # the host waits for the card ----
        while len(self.pending) > self.LAG:
            self._drain_one()
        if perf is not None:
            mark("drain")

        # ---- host planes ----
        depth_pre = _np_preprocess_depth(
            np.asarray(depth_raw, np.float32), cfg.choose_data,
            cfg.depth_map_factor, cfg.bf)
        flow_np = np.ascontiguousarray(flow, dtype=np.float32)
        mask_np = np.asarray(mask, np.int32)
        self._roll_base_to(f_id)
        mask_rec = self._host_mask_recovery(mask_np, f_id)
        self.planes[f_id] = (depth_pre, flow_np, mask_rec)
        for k in [k for k in self.planes if k < f_id - 3]:
            del self.planes[k]
        if perf is not None:
            mark("planes")

        # ---- families A and B, and the detector-independent selection ----
        obj_tmp = _native.select_object_points(
            depth_pre, flow_np, mask_rec, cfg.th_depth_obj, tr.NO)
        if obj_tmp is None:
            obj_tmp = fh.select_object_points(
                depth_pre, flow_np, mask_rec, cfg.th_depth_obj, tr.NO)
        planes = (depth_pre, flow_np, mask_rec)
        A = _sample_families(*planes, self.base_pos)
        B = (_sample_families(*planes, dict(zip(
                ("s", "l", "o", "ol"), (c[3] for c in self.prev_cands))))
             if self.prev_cands is not None
             else {k: np.zeros_like(v) for k, v in A.items()})
        fams = dict(A=A, B=B)
        if self.depth >= 3:
            if self.prev_cands2 is not None:
                # candidates of frame t-2: their correspondences live in
                # t-1; rolled one flow plane forward to sample this frame
                flow_prev = self.planes[f_id - 1][1]
                fams["B2"] = _sample_families(*planes, {
                    fam: _rolled_positions(c[3], flow_prev, _STRIDE[fam])
                    for fam, c in zip(("s", "l", "o", "ol"),
                                      self.prev_cands2)})
            else:
                fams["B2"] = {k: np.zeros_like(v) for k, v in A.items()}
        if perf is not None:
            mark("families")

        # ---- this frame's detections and candidate selections (C) ----
        pend = self._det_pending.pop(f_id, None)
        for k in [k for k in self._det_pending if k <= f_id]:
            del self._det_pending[k]
        if pend is not None and pend[0] == need:
            det, lines = tr._take_detections(pend[1])
        else:
            det, lines = tr._detect(gray, *need)
        if need[1]:
            line_detections = lines
        tr.depth_np, tr.mask_np = depth_pre, mask_rec
        stat_tmp, line_tmp, oline_tmp = tr._finish_selection(
            det, point_detections, line_detections, flow_np, *self._hw)
        olc_ok = _np_filt_line_ok(oline_tmp[0], depth_pre, flow_np, mask_rec)
        if perf is not None:
            mark("selection")

        # ---- pack, push, dispatch ----
        parts = {f"{fam}_{k}": v for fam, tabs in fams.items()
                 for k, v in tabs.items()}
        for pre, tup in (("c_s", stat_tmp), ("c_l", line_tmp)):
            for suf, v in zip(("uv", "d", "f", "c", "v"), tup):
                parts[f"{pre}_{suf}"] = v
        for pre, tup in (("c_o", obj_tmp), ("c_ol", oline_tmp)):
            for suf, v in zip(("uv", "d", "f", "c", "s", "v"), tup):
                parts[f"{pre}_{suf}"] = v
        parts["olc_ok"] = olc_ok
        parts["f00"] = flow_np[0, 0]
        buf = np.concatenate([
            np.ravel(np.asarray(parts[name])).astype(np.float32)
            for name, _ in bundle_spec(self.caps, self.depth)])
        self.prev_cands2 = self.prev_cands
        self.prev_cands = (stat_tmp, line_tmp, obj_tmp, oline_tmp)
        self.last_bundle = buf
        if perf is not None:
            mark("families_pack")

        t0 = time.perf_counter()
        spec = chained_aux_spec(self.caps, *n_hypotheses(cfg))
        aux = np.zeros(sum(_numel(shape) for _, shape in spec), np.float32)
        self._labels_and_draws(_unpack_aux(aux, spec), gt_objs, f_id)
        arrays = dict(bundle=buf, aux=aux)
        prog = self._step_program({k: (a.shape, torch.float32)
                                   for k, a in arrays.items()})
        prog.load(arrays)
        with torch.profiler.record_function("chained_step"):
            tr.lm_host_syncs += prog()
        # on the stream of the launch: the copy is taken before the next
        # frame's launch overwrites the output buffer
        host, ready = to_host_async(prog.out)
        timing[1] = (time.perf_counter() - t0) * 1e3
        if perf is not None:
            mark("dispatch_step")
        # slot 0: the host's prep (mask recovery, sampling, selections)
        timing[0] = (time.perf_counter() - t_all) * 1e3 - timing[1]
        self.pending.append(dict(
            f_id=f_id, host=host, ready=ready, pose_gt=pose_gt,
            gt_objs=gt_objs, prev_gt=self._prev_gt, timing=timing.copy()))
        self._prev_gt = (gt_objs, pose_gt)

        # the last frame finishes synchronously, so the final map is whole;
        # its own window BA runs here (no later frame would start it)
        if f_id >= stop_frame or f_id >= n_images - 1:
            self.drain_all()
            if self._lba_trigger(f_id):
                self._run_partial_ba(f_id)
            self._finish_run(f_id, stop_frame)
        return np.asarray(self._last_pose)

    def _drain_one(self):
        p, o = super()._drain_one()
        self._set_base_from_out(o, p["f_id"])
        return p, o

    def drain_all(self):
        while self.pending:
            self._drain_one()
        if self.state is not None:
            # the base is the live state now: provenance is the identity
            self._rebase_identity()
