"""The port's bench (``sdpl_slam_torch/bench.py``) against the JAX package's
``bench.py`` (imported, its ``main`` not called): the window frames it
leaves out, its settings, its JSON keys; the chained driver's section
names against the JAX driver's; one small run of ``bench.run`` on the CPU
(640x192, 10 frames, window 8 / overlap 2: one window, at frame 7), FAST
and the line detector in the loop; and the line it prints without a card.
"""

import ast
import copy
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sdpl_slam_torch import bench
from sdpl_slam_torch.models.chained import bundle_size
from sdpl_slam_torch.utils.synthetic import SynthConfig, SynthSequence

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
N_FRAMES = 10          # 9 tracked; the window at frame 7 runs at frame 8


@pytest.fixture(scope="module")
def jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _window_settings(cfg, window, overlap):
    """The bench's settings at ``cfg`` with the window BA at ``window`` /
    ``overlap``."""
    s = bench._settings(cfg)
    s.run_local_ba = True
    s.window_size, s.overlap_size = window, overlap
    return s


@pytest.mark.parametrize("window,overlap", [(20, 4), (8, 2)])
@pytest.mark.parametrize("n", [10, 20, 36, 54])
def test_non_lba_times_match_jax(jax_bench, window, overlap, n):
    """The same frames left out as ``bench.py``'s, window or not."""
    s = _window_settings(SynthConfig(), window, overlap)
    warmup = 2 if n < 20 else 4
    times = [float(t) for t in range(warmup, n)]
    assert (bench._non_lba_times(times, s, n, warmup)
            == jax_bench._non_lba_times(times, s, n, warmup))


def test_settings_match_jax(jax_bench):
    """Every field the two ``Settings`` share holds the same value."""
    import synthetic as jsyn

    tcfg = bench.bench_config()
    jcfg = jsyn.SynthConfig(**{
        f.name: getattr(tcfg, f.name) for f in dataclasses.fields(jsyn.SynthConfig)
        if hasattr(tcfg, f.name)})
    got = bench._settings(tcfg)
    want = jax_bench._settings(jcfg, jsyn.synth_settings)
    shared = ({f.name for f in dataclasses.fields(got)}
              & {f.name for f in dataclasses.fields(want)})
    assert len(shared) > 60
    for name in sorted(shared):
        assert getattr(got, name) == getattr(want, name), name
    assert got.use_sample_fea == 0 and got.chained_tracking


def _out_keys(path: Path) -> set:
    """The keys a bench script writes: those of every dict literal bound to
    ``out`` and of every ``out[...] =`` assignment."""
    keys = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if (isinstance(tgt, ast.Name) and tgt.id == "out"
                    and isinstance(node.value, ast.Dict)):
                keys |= {k.value for k in node.value.keys}
            if (isinstance(tgt, ast.Subscript)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "out"):
                keys.add(tgt.slice.value)
    return keys


def test_json_keys_cover_jax():
    """The port writes every key ``bench.py`` writes, and ``device``."""
    want = _out_keys(ROOT / "bench.py")
    got = _out_keys(ROOT / "sdpl_slam_torch" / "bench.py")
    assert {"metric", "value", "rpe_t_m", "transport_wait_ms",
            "tracking_plus_lba_fps", "cpu_smoke_fps", "error"} <= want
    assert want <= got and got - want == {"device"}


def _mark_names(path: Path, fn: str) -> list:
    """The constant first arguments of the calls of ``fn`` (a name, or an
    attribute such as ``trace.section``) in ``path``, in source order."""
    def named(f):
        return (isinstance(f, ast.Name) and f.id == fn) or (
            isinstance(f, ast.Attribute) and "." in fn
            and f.attr == fn.rpartition(".")[2]
            and isinstance(f.value, ast.Name)
            and f.value.id == fn.rpartition(".")[0])
    calls = [n for n in ast.walk(ast.parse(path.read_text()))
             if isinstance(n, ast.Call) and named(n.func) and n.args
             and isinstance(n.args[0], ast.Constant)]
    return [n.args[0].value for n in sorted(
        calls, key=lambda n: (n.lineno, n.col_offset))]


def _jax_sections():
    names = _mark_names(ROOT / "sdpl_slam_tpu" / "models" / "chained.py",
                        "_mark")
    assert len(names) == 7
    return names


def test_section_names_match_jax():
    """The chained driver's sections (``chained.<name>`` spans of the span
    recorder) are JAX's, in JAX's order."""
    got = _mark_names(ROOT / "sdpl_slam_torch" / "models" / "chained.py",
                      "trace.section")
    assert got == ["chained." + k for k in _jax_sections()]


@pytest.fixture(scope="module")
def small_run():
    """``bench.run`` on the CPU, one pass, warmup 2.  A copy of the system
    is taken just before the device-exec probe: the same run without it."""
    cfg = SynthConfig(n_frames=N_FRAMES, n_objects=2, noise_flow=0.2)
    settings = _window_settings(cfg, 8, 2)
    systems, unprobed, probe = [], [], bench._device_exec_probe

    def probing(system, *a, **k):
        drv = system.tracker._res
        unprobed.append(copy.deepcopy(system))
        unprobed.append(drv.last_bundle.copy())
        unprobed.append(drv.prog.inp["bundle"].clone())
        return probe(system, *a, **k)

    bench._device_exec_probe = probing
    try:
        out = bench.run(cfg, settings, passes=1, device="cpu", warmup=2,
                        systems=systems)
    finally:
        bench._device_exec_probe = probe
    return dict(cfg=cfg, out=out, system=systems[0], unprobed=unprobed[0],
                bundle=unprobed[1], loaded=unprobed[2])


def test_small_run_gates_and_keys(small_run):
    """The RPE gates hold; a CPU run never publishes a headline."""
    out = small_run["out"]
    assert out["rpe_t_m"] < 0.005 and out["rpe_r_deg"] < 0.1
    assert "gate_failed" not in out and "error" not in out
    assert out["value"] == 0 and out["vs_baseline"] == 0
    assert out["platform"] == "cpu" and out["device"] == "cpu"
    assert out["cpu_smoke_fps"] > 0
    assert out["device_exec_ms_per_frame"] > 0
    assert len(out["stage_ms"]) == 5 and out["pass_median_ms"] == [
        out["median_frame_ms"]]
    assert out["host_ms"] > 0 and out["transport_wait_ms"] >= 0
    assert out["lba_first_window_ms"] == out["lba_warm_window_ms"] > 0
    assert set(out) <= _out_keys(ROOT / "sdpl_slam_torch" / "bench.py")
    json.dumps(out)


def test_small_run_window_and_sections(small_run):
    """One window (at frame 7), and one entry per section for every
    chained frame (all but frame 0), in JAX's order."""
    system = small_run["system"]
    assert len(system.map.lba_times) == 1
    assert [(r["kind"], r["frame"]) for r in system.tracker.ba_runs] == [
        ("local", 7)]
    perf = system.tracker._res.perf
    assert list(perf) == _jax_sections()
    assert all(len(v) == N_FRAMES - 2 for v in perf.values())


def test_small_run_last_bundle(small_run):
    """``last_bundle`` is the bundle the program was loaded with."""
    drv = small_run["system"].tracker._res
    caps = {k: drv.caps[k] for k in ("NS", "NLS", "NO", "NLO")}
    assert small_run["bundle"].size == bundle_size(caps, drv.depth)
    assert small_run["bundle"].dtype == np.float32
    assert np.array_equal(small_run["loaded"].numpy(), small_run["bundle"])
    assert np.array_equal(drv.last_bundle, small_run["bundle"])


def test_probe_leaves_the_tracker_as_it_was(small_run):
    """After the probe one more frame gives the pose, bit for bit, of the
    same run without the probe."""
    seq = SynthSequence(small_run["cfg"])
    n = seq.n_frames - 1
    f = seq.frame(n)
    poses = [s.track_rgbd(f.gray, f.depth, f.flow, f.mask, f.gt_pose,
                          f.obj_rows, n * 0.1, n + 1)
             for s in (small_run["system"], small_run["unprobed"])]
    assert np.array_equal(poses[0], poses[1])
    a, b = small_run["system"].map, small_run["unprobed"].map
    assert a.n_frames == b.n_frames == n + 1
    assert np.array_equal(a.camera_poses[-1], b.camera_poses[-1])


def test_main_without_a_card_fails_loudly(monkeypatch, capsys):
    """No card and no CPU request: the failure line (value 0, an error),
    alone on standard output, and a non-zero exit."""
    monkeypatch.delenv("SDPL_BENCH_ALLOW_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 1
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["value"] == 0 and out["vs_baseline"] == 0
    assert out["metric"] == "kitti_scale_tracking_fps_per_chip"
    assert "CUDA" in out["error"]


def test_main_prints_its_line_on_an_error(monkeypatch, capsys):
    """An error inside the run still prints the line, and exits non-zero;
    what the run prints goes to standard error."""
    def boom(*a, **k):
        print("noise")
        raise RuntimeError("boom")

    monkeypatch.setattr(bench, "run", boom)
    assert bench.main(["--cpu"]) == 1
    cap = capsys.readouterr()
    out = json.loads(cap.out)
    assert out["value"] == 0 and "RuntimeError: boom" in out["error"]
    assert "noise" in cap.err and "noise" not in cap.out
