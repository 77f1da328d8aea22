"""On the card: the control of each cell (the program with TF32 switched on,
the nearest precision below the float32 its configuration states), and the
program with every object motion left at the identity, have to come out
not correct by the cell's limits, on three seeds, at the cell's own size
(one window of whole sequences).  Skipped without a card.

    python3 -m pytest slam_bench/tests/test_slam_bench_card.py -m gpu -p no:cacheprovider
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from slam_bench import reference, spec

ROOT = Path(spec.HERE).parent
CELLS = [w["name"] for w in spec.Benchmark().doc["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("broken", [["--control", "tf32"],
                                    ["--fault", "object_identity"]])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_the_fault_are_not_correct(card, cell, broken):
    r = subprocess.run(
        [sys.executable, "-m", "slam_bench.calibrate", "--workload", cell,
         "--seeds", "3", "--first-seed", "3000000001", "--seconds", "0"]
        + broken,
        cwd=ROOT, capture_output=True, text=True, timeout=1500)
    assert r.returncode == 0, r.stderr[-3000:]
    limits = spec.Benchmark().limits(cell)
    lines = [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 3
    for line in lines:
        correct, checks = reference.judge(line["numbers"], limits)
        assert not correct, (line["seed"], checks)
