"""Process groups and the edge-parallel global bundle adjustment on
``torch.distributed``."""
