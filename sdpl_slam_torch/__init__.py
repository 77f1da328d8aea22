"""SDPL-SLAM in PyTorch: the dynamic point-line RGB-D SLAM pipeline of
the JAX package on plain PyTorch tensors, with hand-written CUDA kernels
for Hopper where the JAX package used Pallas.

Layout mirrors the JAX package so each module's counterpart is easy to find:

- ``ops``      : Lie-group / projective / line geometry, FAST pyramid (with
                 the CUDA FAST-9/16 score kernel), the line detector and
                 its LSD oracle, RANSAC init.
- ``solvers``  : the batched joint flow+pose LM and the pose-only LM; batch
                 BA (the window and the full-sequence LM with block-Jacobi
                 CG).
- ``models``   : Frame ops, host-side selections, Map, Tracking, System.
- ``io``       : sequence loaders and the frame prefetcher, a PNG codec on
                 zlib + numpy, result writers, the native host-I/O
                 bindings.
- ``utils``    : Settings, metrics, plotting, the numpy synthetic sequence
                 generator and the JAX-state converter.
- ``csrc``     : CUDA C++ kernel sources, built at first use.

Every tensor lives on an explicit device (``System(..., device=...)``);
there is no silent fallback from CUDA to the CPU.
"""

__version__ = "0.1.0"

import torch as _torch

# Metric SLAM geometry cannot tolerate TF32 (about three decimal digits):
# the JAX package forces full-f32 matmuls for the same reason
# (the JAX package's ``__init__.py``), so the port turns TF32 off for matmuls and
# for cuDNN, whose float32 default is TF32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
