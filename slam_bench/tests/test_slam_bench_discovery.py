"""A cell, a traffic mix, a configuration and a per-layer metric are found
by name: adding them adds files and entries and edits no file of the
benchmark's folder."""

import hashlib
import json
import shutil
from pathlib import Path

from slam_bench import spec

ROOT = Path(spec.HERE).parent


def _digests(base):
    return {p.relative_to(base): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in base.rglob("*") if p.is_file()}


def test_a_new_cell_mix_config_and_metric_are_found_by_name(tmp_path):
    base = tmp_path / "slam_bench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(Path(spec.HERE) / sub, base / sub)
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digests(base)

    cfg = json.loads((base / "configs" / "kitti.json").read_text())
    cfg["scene"]["n_objects"] = 3
    (base / "configs" / "kitti3.json").write_text(json.dumps(cfg))
    (base / "traffic" / "schur.json").write_text(json.dumps(
        {"settings": {"run_local_ba": True, "ba_schur": True}}))
    (base / "limits" / "kitti3.schur.json").write_text(
        json.dumps({"cam_t_mm": 1.0}))
    (base / "metrics" / "frames.count.py").write_text(
        "def read(rec):\n    return float(rec['frames'])\n")
    doc["configs"].append(dict(name="kitti3", source="x",
                               file="slam_bench/configs/kitti3.json",
                               reduced=[], why="three cars"))
    doc["workloads"].append(dict(name="kitti3.schur", config="kitti3",
                                 traffic="schur", chips=1, why="Schur windows"))
    doc["per_layer"].append(dict(name="frames.count", unit="frames",
                                 better="higher", source="program_counter",
                                 layer="traffic", moves="fps",
                                 workloads=["kitti3.schur"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))

    after = _digests(base)
    assert {k: after[k] for k in before} == before      # nothing edited
    b = spec.Benchmark(root=tmp_path, base=base)
    cell = b.cell("kitti3.schur")
    assert b.config(cell["config"])["scene"]["n_objects"] == 3
    assert b.traffic(cell["traffic"])["settings"]["ba_schur"]
    assert b.limits("kitti3.schur") == {"cam_t_mm": 1.0}
    names = [m["name"] for m in b.metrics("per_layer", "kitti3.schur")]
    assert names == ["frames.count"]
    assert b.reader("frames.count")(dict(frames=53)) == 53.0
    e2e = [m["name"] for m in b.metrics("end_to_end", "kitti3.schur")]
    assert e2e == ["fps", "setup_s"]


def test_every_cell_has_its_files():
    b = spec.Benchmark()
    for cell in b.doc["workloads"]:
        assert b.config(cell["config"])["settings"]
        assert "settings" in b.traffic(cell["traffic"])
        assert b.limits(cell["name"])
        for m in b.metrics("per_layer", cell["name"]):
            assert callable(b.reader(m["name"]))
