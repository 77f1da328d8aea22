"""The benchmark of ``sdpl_slam_torch`` on one CUDA card.

``python3 -m slam_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (``run.py``).
It imports the program under test and nothing of the JAX package.
"""
