"""A multi-process dry run of the sharded global BA on a real tracked graph,
the counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``.

    python -m sdpl_slam_torch.parallel.dryrun [N] [--cpu]

This process tracks the tiny synthetic sequence of that entry point (5
frames at 320x96, one moving object, lines injected; 4 tracked) with this
package's ``System`` and builds the global BA graph, which has every edge
type.  Then ``N`` processes join one ``torch.distributed`` world (gloo on
the CPU or with several ranks on one card, NCCL with a card a rank) and run
``run_sharded_ba(..., max_iters=2, cg_iters=5, partitioned=True)`` on it.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import tempfile

import numpy as np
import torch
import torch.multiprocessing as mp

from ..utils.device import checked_device


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def tracked_graph(device):
    """The global BA graph (on the CPU) of the tiny sequence tracked on
    ``device``."""
    from ..models.system import System
    from ..solvers import ba_builder
    from ..utils.synthetic import SynthConfig, SynthSequence, synth_settings

    cfg = SynthConfig(n_frames=5, n_objects=1, width=320, height=96,
                      fx=180.0, fy=180.0, cx=160.0, cy=48.0)
    settings = synth_settings(cfg)
    settings.max_track_point_bg = 128
    settings.max_track_point_obj = 64
    settings.max_static_lines = 16
    settings.max_objects = 2
    settings.min_object_points = 20
    settings.min_pnp_inliers_obj = 15
    settings.run_local_ba = False
    system = System(settings, verbose=False, device=device)
    seq = SynthSequence(cfg)
    for t in range(4):
        f = seq.frame(t)
        system.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                          f.obj_rows, t * 0.1, 4, line_detections=f.lines)
    m = system.map
    graph, _ = ba_builder.build_graph(m, system.tracker.K, 0, m.n_frames,
                                      device="cpu")
    return graph


def _worker(rank, world, port, graph, device, out_dir):
    from ..solvers import batch_ba as bb
    from . import sharded_ba

    torch.set_num_threads(1)
    dev = sharded_ba.init_world(rank, world, port, device)
    try:
        graph = bb.BAGraph(*(x.to(dev) if torch.is_tensor(x) else x
                             for x in graph))
        mesh = sharded_ba.make_mesh(world)
        state, cost = sharded_ba.run_sharded_ba(
            graph, bb.BAWeights(), mesh, max_iters=2, cg_iters=5,
            partitioned=True)
        if rank == 0:
            with open(os.path.join(out_dir, "dryrun.json"), "w") as f:
                json.dump(dict(
                    cost=cost, backend=torch.distributed.get_backend(),
                    cams_finite=bool(torch.isfinite(state.cam_T).all())), f)
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda") -> float:
    """Track the tiny sequence here, run the partitioned sharded BA on its
    global graph in ``n_devices`` processes, print ``dryrun_multichip OK:
    ...`` and return the final cost; raises if a worker fails or the result
    is not finite."""
    dev = checked_device(device, "dryrun_multichip")
    graph = tracked_graph(dev)
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_worker, args=(n_devices, free_port(), graph, str(dev),
                                out_dir), nprocs=n_devices, join=True)
        with open(os.path.join(out_dir, "dryrun.json")) as f:
            res = json.load(f)
    if not (np.isfinite(res["cost"]) and res["cams_finite"]):
        raise RuntimeError("dryrun_multichip: not finite: %r" % res)
    print("dryrun_multichip OK: %d-process world (%s on %s), partitioned "
          "sharded BA step cost=%.4f"
          % (n_devices, res["backend"], dev.type, res["cost"]))
    return res["cost"]


if __name__ == "__main__":
    args = sys.argv[1:]
    n = int(next((a for a in args if not a.startswith("-")), 4))
    dryrun_multichip(n, device="cpu" if "--cpu" in args else "cuda")
