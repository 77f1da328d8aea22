"""Frame feature ops on tensors (counterpart of ``sdpl_slam_tpu.models.frame``).

The selections, inheritance and renewal run on host numpy
(:mod:`.frame_host`); what the tracker needs on its device is the
unprojection of pixels into the world and the deterministic sample grid
used when ``UseSampleFeature`` is on.
"""

from __future__ import annotations

import torch

from ..ops import geometry, lie
from ..ops.geometry import Intrinsics


def grid_sample_uv(height: int, width: int, n_points: int = 3000, *,
                   device) -> torch.Tensor:
    """Uniform integral pixel lattice, the ``SampleKeyPoints`` equivalent
    (reference Frame.cc:1494-1562: 3000 points on a 20x20 grid)."""
    n = int(round(n_points ** 0.5))
    us = torch.linspace(2.0, width - 3.0, max(n, 2), dtype=torch.float32,
                        device=device)
    vs = torch.linspace(2.0, height - 3.0, max((n_points + n - 1) // n, 2),
                        dtype=torch.float32, device=device)
    vv, uu = torch.meshgrid(vs, us, indexing="ij")
    pts = torch.stack([uu.reshape(-1), vv.reshape(-1)], -1)
    return torch.round(pts[:n_points])


def world_points(K: Intrinsics, T_cw: torch.Tensor, uv: torch.Tensor,
                 depth: torch.Tensor) -> torch.Tensor:
    """Unproject pixels (..., N, 2) at depth (..., N) into WORLD coordinates
    through camera poses (..., 4, 4) (``Optimizer::Get3DinWorld``)."""
    return lie.transform_point(lie.se3_inv(T_cw),
                               geometry.backproject(K, uv, depth))

