"""Edge-parallel global bundle adjustment on ``torch.distributed``
(counterpart of the JAX package's ``parallel.sharded_ba``).

The full-sequence BA is the framework's scale axis (SURVEY.md section 5):
a KITTI sequence gives hundreds of thousands of observation edges.  The
edge stacks of :mod:`..solvers.batch_ba` are parallel over the edge axis:
each edge gathers a few vertices, computes a small residual and Jacobian,
and scatter-adds into the variable vector.  Each rank of a process group
holds a contiguous block of every edge family (families padded with
invalid edges, which weigh 0, to a multiple of the world size), and the
sums that GSPMD inserts for the JAX package are explicit collectives here:

* once per LM step, one ``all_reduce(SUM)`` of the gradient, the
  block-Jacobi diagonal and the cost (packed into one flat tensor);
* in every CG iteration, one ``all_reduce(SUM)`` of the Hessian-vector
  product;
* the prior edge sits on rank 0 only, so the sums count it once.

Two layouts, as in the JAX package:

* **replicated** (:func:`shard_graph`): every rank holds every vertex
  array; the CG runs redundantly on each rank on the reduced vectors, so
  its inner products need no collective.
* **partitioned** (:func:`shard_graph_partitioned`): edges sorted stably by
  the frame (or frame-ordered vertex) they touch, invalid last, then cut
  into blocks; each vertex family whose count the world size divides is
  split into row blocks, the others stay replicated.  A rank holds only its
  block at rest (:func:`variable_bytes_per_device`).  The CG vectors are
  split the same way: each iteration all-gathers the search direction to
  linearise against, reduces the product and keeps its rows, and every
  inner product is summed over the ranks (the gain denominator too).
  Its results equal the replicated layout's to rounding.

``reduce_dtype`` (``ba_dtype: "mixed"``) runs the CG recurrences and the
reduced inner products in that dtype while the sharded HVP stays float32.

Backends: NCCL when every rank has a card of its own, gloo otherwise (the
CPU, or several ranks on one card, which NCCL refuses; gloo stages CUDA
tensors through the host).  Each step first checks that gloo takes CUDA
tensors for ``all_reduce`` and ``all_gather``, and fails loudly if not.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..solvers import batch_ba as bb

# BAGraph fields split along their leading (edge) axis; everything else
# (vertex initialisations, scalars) is replicated
_EDGE_FIELDS = {
    "odo_i", "odo_j", "odo_meas", "odo_valid",
    "smo_i", "smo_j", "smo_valid",
    "sp_cam", "sp_pt", "sp_meas", "sp_valid",
    "sl_cam", "sl_line", "sl_meas", "sl_valid",
    "dp_cam", "dp_pt", "dp_meas", "dp_valid",
    "tern_prev", "tern_cur", "tern_mot", "tern_valid",
    "dl_cam", "dl_line", "dl_meas", "dl_valid",
    "ltern_prev", "ltern_cur", "ltern_mot", "ltern_valid",
}

# (sort key field, the family's fields) per edge family: sorting edges by
# the frame (or frame-ordered vertex id) they touch makes a contiguous edge
# block reference a contiguous variable range
_EDGE_SORT_KEYS = {
    "odo": ("odo_i", ("odo_i", "odo_j", "odo_meas", "odo_valid")),
    "smo": ("smo_i", ("smo_i", "smo_j", "smo_valid")),
    "sp": ("sp_cam", ("sp_cam", "sp_pt", "sp_meas", "sp_valid")),
    "sl": ("sl_cam", ("sl_cam", "sl_line", "sl_meas", "sl_valid")),
    "dp": ("dp_cam", ("dp_cam", "dp_pt", "dp_meas", "dp_valid")),
    "tern": ("tern_mot", ("tern_prev", "tern_cur", "tern_mot",
                          "tern_valid")),
    "dl": ("dl_cam", ("dl_cam", "dl_line", "dl_meas", "dl_valid")),
    "ltern": ("ltern_mot", ("ltern_prev", "ltern_cur", "ltern_mot",
                            "ltern_valid")),
}

# variable arrays split along their leading axis in the partitioned layout
# (frame blocks for poses and motions; id blocks for structure, which the
# builder numbers in frame order)
_VAR_FIELDS = {
    "cam_T0", "cam_valid", "mot_T0", "mot_valid",
    "Xs0", "Xs_valid", "Ls_U0", "Ls_w0", "Ls_valid",
    "Xd0", "Xd_valid", "Ld_U0", "Ld_w0", "Ld_valid",
}

# the vertex family of each variable field, and each state field
_FIELD_FAMILY = {
    "cam_T0": "cam", "cam_valid": "cam", "mot_T0": "mot", "mot_valid": "mot",
    "Xs0": "xs", "Xs_valid": "xs", "Ls_U0": "ls", "Ls_w0": "ls",
    "Ls_valid": "ls", "Xd0": "xd", "Xd_valid": "xd", "Ld_U0": "ld",
    "Ld_w0": "ld", "Ld_valid": "ld",
}
_STATE_FAMILY = {"cam_T": "cam", "mot_T": "mot", "Xs": "xs", "Ls_U": "ls",
                 "Ls_w": "ls", "Xd": "xd", "Ld_U": "ld", "Ld_w": "ld"}


# ---------------------------------------------------------------------------
# process groups
# ---------------------------------------------------------------------------


def init_world(rank: int, world_size: int, port: int, device) -> torch.device:
    """Join a ``world_size`` process group at ``tcp://localhost:port`` as
    ``rank``; returns the rank's device.  NCCL when every rank can have a
    card of its own (card ``rank``), gloo otherwise (the CPU, or every rank
    on card 0)."""
    dev = torch.device(device)
    nccl = dev.type == "cuda" and world_size <= torch.cuda.device_count()
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if nccl else 0)
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if nccl else "gloo",
                            init_method="tcp://localhost:%d" % port,
                            rank=rank, world_size=world_size)
    return dev


def make_mesh(n_devices: Optional[int] = None):
    """(process group, rank) of the initialised default group, the
    counterpart of the JAX package's device mesh; ``n_devices`` must equal
    the world size when given."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call init_world "
                           "(or torch.distributed.init_process_group) first")
    if n_devices is not None and n_devices != dist.get_world_size():
        raise ValueError("make_mesh(%d): the world has %d ranks"
                         % (n_devices, dist.get_world_size()))
    return dist.group.WORLD, dist.get_rank()


def _check_gloo_cuda(group, device: torch.device) -> None:
    """Before a step's collectives on CUDA tensors through gloo: check that
    ``all_reduce`` and ``all_gather`` take them and give the right sums;
    raises otherwise."""
    if device.type != "cuda" or dist.get_backend(group) != "gloo":
        return
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    try:
        t = torch.full((3,), float(rank + 1), device=device)
        dist.all_reduce(t, group=group)
        parts = [torch.empty(2, device=device) for _ in range(world)]
        dist.all_gather(parts, torch.full((2,), float(rank), device=device),
                        group=group)
        ok = (torch.all(t == world * (world + 1) / 2)
              and torch.equal(torch.cat(parts).cpu(), torch.arange(
                  world, dtype=torch.float32).repeat_interleave(2)))
    except RuntimeError as e:
        raise RuntimeError("gloo refuses CUDA tensors for all_reduce / "
                           "all_gather: %s" % e) from e
    if not ok:
        raise RuntimeError("gloo all_reduce / all_gather of CUDA tensors "
                           "gave wrong values")


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


class ShardedGraph(NamedTuple):
    """One rank's part of a sharded BAGraph.  ``local`` holds the rank's
    edge blocks and its variable rows (all rows of a replicated family);
    ``split`` names the families whose rows are split; ``counts`` are the
    full vertex counts per family."""
    local: bb.BAGraph
    group: object
    rank: int
    world: int
    split: frozenset
    counts: dict


def _pad_to_multiple(x: torch.Tensor, mult: int) -> torch.Tensor:
    rem = (-x.shape[0]) % mult
    if rem == 0:
        return x
    return torch.cat([x, x.new_zeros((rem,) + tuple(x.shape[1:]))])


def _block(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


def _counts(graph: bb.BAGraph) -> dict:
    return {"cam": graph.cam_T0.shape[0], "mot": graph.mot_T0.shape[0],
            "xs": graph.Xs0.shape[0], "ls": graph.Ls_U0.shape[0],
            "xd": graph.Xd0.shape[0], "ld": graph.Ld_U0.shape[0]}


def _local_graph(vals: dict, rank: int, world: int, split) -> bb.BAGraph:
    out = {}
    for name, val in vals.items():
        # clones, so that a rank keeps only its block alive
        if name in _EDGE_FIELDS:
            val = _block(_pad_to_multiple(val, world), rank, world).clone()
        elif name in _VAR_FIELDS and _FIELD_FAMILY[name] in split:
            val = _block(val, rank, world).clone()
        elif name == "prior_info" and rank != 0:
            # the prior edge lives on rank 0; the sums count it once
            val = torch.zeros_like(val)
        out[name] = val
    return bb.BAGraph(**out)


def shard_graph(graph: bb.BAGraph, mesh) -> ShardedGraph:
    """The replicated layout: this rank's contiguous block of every edge
    family (padded with invalid edges to a multiple of the world size),
    every vertex array whole."""
    group, rank = mesh
    world = dist.get_world_size(group)
    return ShardedGraph(_local_graph(graph._asdict(), rank, world, ()),
                        group, rank, world, frozenset(), _counts(graph))


def shard_graph_partitioned(graph: bb.BAGraph, mesh) -> ShardedGraph:
    """The frame-range partitioned layout (SURVEY 7.3): every edge family
    sorted stably by the frame (or frame-ordered vertex id) it touches,
    invalid edges last, and cut into contiguous blocks; each vertex family
    whose count the world size divides split into row blocks, the others
    replicated.  The graph is a permutation of the same edge set, so a
    step equals the replicated layout's to rounding."""
    group, rank = mesh
    world = dist.get_world_size(group)
    vals = graph._asdict()
    big = torch.iinfo(torch.int64).max
    for keyf, fields in _EDGE_SORT_KEYS.values():
        key = torch.where(vals[fields[-1]], vals[keyf].to(torch.int64),
                          torch.full_like(vals[keyf], big, dtype=torch.int64))
        order = torch.sort(key, stable=True)[1]
        for f in fields:
            vals[f] = vals[f][order]
    counts = _counts(graph)
    split = frozenset(f for f, c in counts.items() if c % world == 0)
    return ShardedGraph(_local_graph(vals, rank, world, split), group, rank,
                        world, split, counts)


def state_from_graph(graph) -> bb.BAState:
    """Initial state aliasing the graph's vertex initialisations: the
    rank's rows of a :class:`ShardedGraph`, or a whole ``BAGraph``'s."""
    return bb.initial_state(graph.local if isinstance(graph, ShardedGraph)
                            else graph)


def variable_bytes_per_device(graph) -> int:
    """Bytes of the variable arrays one rank holds at rest (the
    long-sequence memory axis, SURVEY 7.3): the whole arrays of a plain
    ``BAGraph`` or of the replicated layout; the rank's row blocks of the
    split families in the partitioned layout."""
    g = graph.local if isinstance(graph, ShardedGraph) else graph
    return sum(getattr(g, name).numel() * getattr(g, name).element_size()
               for name in _VAR_FIELDS)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


class _Collectives:
    """The sums and gathers of one sharded graph's step."""

    def __init__(self, sg: ShardedGraph, device):
        self.sg = sg
        _check_gloo_cuda(sg.group, device)
        # the flat delta vector, family by family: a rank holds all entries
        # of a replicated family and its row block of a split one
        fams = [(f, sg.counts[f] * bb._FAMILY_DIM[f], f in sg.split)
                for f in ("cam", "mot", "xs", "ls", "xd", "ld")]
        sizes = [n // sg.world if split else n for _, n, split in fams]
        n_local = sum(sizes)
        own, full_from, part = [], [], []
        o_full = o_local = 0
        for (f, n, split), size in zip(fams, sizes):
            lo = o_full + (sg.rank * size if split else 0)
            own.append(torch.arange(lo, lo + size))
            part.append(torch.full((size,), split))
            # where the family's full entries lie in the gathered local
            # vectors (rank r's at r * n_local): a split family's block r
            # from rank r, a replicated family from rank 0
            idx = o_local + torch.arange(size)
            if split:
                idx = (torch.arange(sg.world)[:, None] * n_local
                       + idx[None]).reshape(-1)
            full_from.append(idx)
            o_full += n
            o_local += size
        self.n_full = o_full
        self.own_idx = torch.cat(own).to(device)
        self.full_idx = torch.cat(full_from).to(device)
        self.part = torch.cat(part).to(device)
        self.any_split = bool(sg.split)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce (SUM) of ``t`` over the group, in place."""
        dist.all_reduce(t, group=self.sg.group)
        return t

    def own(self, v_full: torch.Tensor) -> torch.Tensor:
        """The rank's entries of a full flat vector."""
        return v_full[self.own_idx] if self.any_split else v_full

    def full(self, v_local: torch.Tensor) -> torch.Tensor:
        """The full flat vector from every rank's entries (one
        ``all_gather``)."""
        if not self.any_split:
            return v_local
        parts = [torch.empty_like(v_local) for _ in range(self.sg.world)]
        dist.all_gather(parts, v_local.contiguous(), group=self.sg.group)
        return torch.cat(parts)[self.full_idx]

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Inner product of two local CG vectors: the split entries summed
        over the ranks, the replicated entries once."""
        if not self.any_split:
            return torch.dot(a, b)
        zero = a.new_zeros(())
        s = self.sum(torch.dot(torch.where(self.part, a, zero), b).reshape(1))
        return s[0] + torch.dot(torch.where(self.part, zero, a), b)

    def gather_rows(self, family: str, x: torch.Tensor) -> torch.Tensor:
        """A variable array's full rows (one ``all_gather`` when split)."""
        if family not in self.sg.split:
            return x
        parts = [torch.empty_like(x) for _ in range(self.sg.world)]
        dist.all_gather(parts, x.contiguous(), group=self.sg.group)
        return torch.cat(parts)


def _full_state(col: _Collectives, state: bb.BAState) -> bb.BAState:
    return bb.BAState(**{k: col.gather_rows(_STATE_FAMILY[k], v)
                         for k, v in state._asdict().items()})


def _step(col: _Collectives, state: bb.BAState, w: bb.BAWeights, lam,
          cg_iters: int, reduce_dtype=None, cg_rtol=1e-4):
    """One damped GN step on the rank's edges: the rank's delta entries
    (a flat vector in the local layout), the cost, the gain denominator and
    the CG iterations, the last three the same on every rank."""
    sg = col.sg
    lam = torch.as_tensor(lam, dtype=state.cam_T.dtype,
                          device=state.cam_T.device)
    full = _full_state(col, state)
    lin, prior, cost = bb._linearize(sg.local, full, w)
    g, hvp, bd = bb._hvp_and_grad(lin, prior, sg.local, full)
    # one all-reduce for the gradient, the block diagonal and the cost
    fams = list(bd)
    packed = col.sum(torch.cat([g, cost.reshape(1)]
                               + [bd[f].reshape(-1) for f in fams]))
    g, cost = packed[:col.n_full], packed[col.n_full]
    o = col.n_full + 1
    for f in fams:
        bd[f] = packed[o:o + bd[f].numel()].view(bd[f].shape)
        o += bd[f].numel()
    if col.any_split:
        bd = {f: _block(b, sg.rank, sg.world) if f in sg.split else b
              for f, b in bd.items()}

    def hvp_local(v):
        return col.own(col.sum(hvp(col.full(v))))

    x, gain_den, n_cg = bb._pcg(hvp_local, col.own(g),
                                bb._block_jacobi(bd, lam), lam, cg_iters,
                                state, reduce_dtype, cg_rtol, dot=col.dot)
    return x, cost, gain_den, n_cg


def _device_of(sg: ShardedGraph) -> torch.device:
    return sg.local.cam_T0.device


def sharded_ba_step(graph: ShardedGraph, state: bb.BAState, w: bb.BAWeights,
                    lam, mesh=None, cg_iters: int = 10, reduce_dtype=None):
    """One damped-GN BA step over the sharded graph (``state`` in the
    graph's layout, as :func:`state_from_graph` gives it; ``mesh``, the
    JAX signature's, is not needed: the graph carries its group).  Returns what
    ``batch_ba.ba_gn_step`` returns: the full delta per family (gathered),
    the cost, the gain denominator and the CG iterations run.
    ``reduce_dtype`` runs the CG recurrences and the reduced inner products
    in that dtype while the sharded HVP stays float32."""
    col = _Collectives(graph, _device_of(graph))
    x, cost, gain_den, n_cg = _step(col, state, w, lam, cg_iters,
                                    reduce_dtype)
    full = _full_state(col, state)
    return bb._views(col.full(x), full), cost, gain_den, n_cg


def run_sharded_ba(graph: bb.BAGraph, w: bb.BAWeights, mesh,
                   max_iters: int = 10, cg_iters: int = 20,
                   partitioned: bool = False, reduce_dtype=None):
    """The LM loop over the sharded graph (the full-sequence BA across
    ranks), step for step the JAX package's: lambda from 1e-5, a step taken
    when the cost is finite and falls (rho > 0), lambda scaled by
    max(1/3, 1 - (2 rho - 1)^3) then, else by nu, doubling.  Every rank
    takes the same decisions from the reduced costs.  ``partitioned`` takes
    the frame-blocked layout with split variables.  Returns (the full
    final state, gathered; the final cost as a float)."""
    sg = (shard_graph_partitioned if partitioned else shard_graph)(graph,
                                                                   mesh)
    col = _Collectives(sg, _device_of(sg))

    def cost_of(state):
        return float(col.sum(bb._cost_only(sg.local, _full_state(col, state),
                                           w).reshape(1))[0])

    state = state_from_graph(sg)
    lam = torch.tensor(1e-5, dtype=state.cam_T.dtype,
                       device=state.cam_T.device)
    nu = 2.0
    cost = cost_of(state)
    for _ in range(max_iters):
        x, _, gain_den, _ = _step(col, state, w, lam, cg_iters, reduce_dtype)
        new_state = bb._retract(state, bb._views(x, state))
        new_cost = cost_of(new_state)
        rho = (cost - new_cost) / max(float(gain_den), 1e-20)
        if np.isfinite(new_cost) and rho > 0:
            state, cost = new_state, new_cost
            lam = lam * max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            nu = 2.0
        else:
            lam = lam * nu
            nu *= 2.0
    return _full_state(col, state), cost
