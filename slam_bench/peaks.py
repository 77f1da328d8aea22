"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name()`` gives (NVIDIA's data sheet, SXM part,
at the full 700 W power limit)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_per_s=3.35e12),
}
