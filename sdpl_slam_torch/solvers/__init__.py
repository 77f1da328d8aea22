"""Batched nonlinear least-squares solvers (the g2o replacement)."""
