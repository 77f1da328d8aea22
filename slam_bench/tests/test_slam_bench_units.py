"""The benchmark's arithmetic on the CPU: rates, tails, interval unions,
the FAST byte count, the readers, the JAX-module check, and the
reference's comparison against ground truth."""

import numpy as np
import pytest
import torch

from slam_bench import fast_ref, probes, reference, run, scene, spec

G = dict(width=320, height=128, fx=300.0, fy=300.0, cx=160.0, cy=64.0,
         n_objects=2, cam_speed=0.6, obj_speed=0.9)


def _rec(n, latency_s=0.01):
    return dict(n=n, latency_s=[latency_s] * n)


def test_rate_is_every_frame_over_the_whole_window():
    recs = [_rec(53), _rec(53)]
    e2e = run.end_to_end(recs, window_s=4.0, setup_s=1.5)
    assert e2e["fps"] == pytest.approx(106 / 4.0)
    assert e2e["setup_s"] == 1.5


def test_p95_is_taken_over_every_frame_of_every_sequence():
    a = dict(n=100, latency_s=[0.010] * 100)
    b = dict(n=100, latency_s=[0.010] * 80 + [0.200] * 20)
    e2e = run.end_to_end([a, b], 1.0, 0.0)
    lat = [0.010] * 180 + [0.200] * 20
    assert e2e["pose_latency_ms.p95"] == pytest.approx(
        float(np.percentile(np.asarray(lat) * 1e3, 95)))
    assert e2e["pose_latency_ms.p95"] == pytest.approx(200.0)


@pytest.mark.parametrize("intervals,total", [
    ([], 0.0),
    ([(0, 1), (2, 3)], 2.0),
    ([(0, 2), (1, 3)], 3.0),
    ([(0, 5), (1, 2), (3, 4)], 5.0),
    ([(3, 4), (0, 1), (0.5, 3.5)], 4.0),
    ([(1, 1), (2, 1)], 0.0),
])
def test_union_of_intervals(intervals, total):
    assert probes.union(intervals) == pytest.approx(total)


def test_gaps_cover_what_the_union_leaves():
    iv = [(1, 2), (1.5, 3), (5, 6)]
    gs = probes.gaps(iv, 0, 8)
    assert gs == [(0, 1), (3, 5), (6, 8)]
    assert probes.union(iv) + sum(e - s for s, e in gs) == pytest.approx(8)


def test_fast_bytes_of_the_kitti_pyramid():
    shapes = fast_ref.pyramid_shapes(375, 1242)
    assert len(shapes) == 8
    assert sum(lh * lw for *_, lh, lw in shapes) == 1_441_432
    assert fast_ref.pyramid_bytes(375, 1242) == 17_297_184


@pytest.mark.parametrize("names,found", [
    (["numpy", "torch", "sdpl_slam_torch", "sdpl_slam_torch.ops"], []),
    (["jax.numpy"], ["jax"]),
    (["jaxlib.xla_client", "flax"], ["flax", "jaxlib"]),
    (["sdpl_slam_tpu.ops.lie"], ["sdpl_slam_tpu"]),
    (["jaxtyping", "flaxen", "sdpl_slam_tpu_extra"], []),
])
def test_forbidden_modules_by_whole_top_level_name(names, found):
    assert run.forbidden_modules(names) == found


def _launch_rec():
    return dict(frames=4,
                perf={"drain": [20.0, 22.0], "planes": [2.0, 2.0],
                      "dispatch_det": [1.0, 501.0]},
                launches=[("step", 0.0, 30.0), ("detector", 10.0, 35.0),
                          ("detector", 35.0, 40.0), ("ba", 60.0, 70.0)],
                device_window_ms=100.0,
                ba_runs=[dict(ms=500.0, cg_iterations=120)],
                stretch=None, device_kind="cpu", frame_shape=(375, 1242),
                fast_cfg=None)


@pytest.mark.parametrize("name,value", [
    ("chained.host_ms", (4.0 + 502.0 - 500.0) / 2),
    ("chained.wait_ms", 21.0),
    ("step.device_ms", 30.0),
    ("detector.device_ms", 30.0 / 4),
    ("device.idle_pct", 100.0 * (1 - 50.0 / 100.0)),
    ("fast.roofline_pct", None),
])
def test_readers(name, value):
    got = spec.Benchmark().reader(name)(_launch_rec())
    if value is None:
        assert got is None
    else:
        assert got == pytest.approx(value)


def test_fast_roofline_reads_the_profiled_kernel():
    rec = _launch_rec()
    rec.update(device_kind="NVIDIA H100 80GB HBM3",
               fast_cfg=dict(n_levels=8, scale=1.2),
               stretch=dict(kernels={"fast_pyramid_kernel(Table)": [12.0, 12.0],
                                     "other": [1.0]}))
    got = spec.Benchmark().reader("fast.roofline_pct")(rec)
    assert got == pytest.approx(100 * 17_297_184 / 3.35e12 / 12e-6)


def test_fast_reference_equals_the_programs_plain_detector():
    from sdpl_slam_torch.ops import fast

    gray = scene.render(G, 3)["gray"]
    uv, va = fast_ref.detect(gray, 500, 20, 7)
    puv, _, pva = fast.detect_keypoints(torch.from_numpy(gray),
                                       fast.FastPyramidConfig(n_features=500))
    assert fast_ref.mismatch(uv, va, puv.numpy(), pva.numpy()) == 0
    moved = puv.numpy().copy()
    moved[np.flatnonzero(pva.numpy())[0]] += 1
    assert fast_ref.mismatch(uv, va, moved, pva.numpy()) == 2


class _Seq:
    """The scene's ground truth for a few frames, as ``scene.Sequence``."""

    def __init__(self, n):
        self.g, self.n = dict(G), n
        frames = [scene.render(G, t) for t in range(n)]
        self.pose = np.stack([f["pose"] for f in frames])
        self.mask = np.stack([f["mask"] for f in frames]).astype(np.int32)
        self.gray = np.stack([f["gray"] for f in frames])

    def object_pixels(self, t, k):
        return int(np.count_nonzero(self.mask[t] == k + 1))


def _gt_record(seq, n):
    """What a perfect tracker's map would hold, in the map's world (the
    first frame's camera)."""
    A = np.linalg.inv(seq.pose[0].astype(np.float64))
    poses = [A @ seq.pose[t] for t in range(n)]
    motions, rm, sm = [], [], []        # one entry a frame pair
    for i in range(1, n):
        mo, r, s = [np.eye(4)], [0], [0]
        for k in range(G["n_objects"]):
            if seq.object_pixels(i - 1, k) and seq.object_pixels(i, k):
                H = scene.obj_pose(G, k, i).astype(np.float64) @ np.linalg.inv(
                    scene.obj_pose(G, k, i - 1).astype(np.float64))
                mo.append(A @ H @ np.linalg.inv(A))
                r.append(k + 1)
                s.append(k + 1)
        motions.append(mo)
        rm.append(r)
        sm.append(s)
    return dict(n=n, poses=poses, motions=motions, rm_labels=rm,
                sm_labels=sm, fast={}, fast_cfg=None)


def test_reference_reads_zero_for_the_ground_truth_and_sees_each_fault():
    seq = _Seq(5)
    rec = _gt_record(seq, 4)
    nums = reference.window_numbers([rec], seq)
    for k in ("frames_missing", "cam_t_mm", "obj_t_mm", "obj_label_err",
              "obj_missed"):
        assert nums[k] == pytest.approx(0.0, abs=1e-3), k
    assert nums["cam_r_deg"] < 1e-3 and nums["obj_r_deg"] < 1e-3

    moved = dict(rec, poses=[p.copy() for p in rec["poses"]])
    moved["poses"][2][0, 3] += 0.01
    assert reference.window_numbers([moved], seq)["cam_t_mm"] == \
        pytest.approx(10.0, rel=1e-3)
    short = dict(rec, poses=rec["poses"][:3])
    assert reference.window_numbers([short], seq)["frames_missing"] == 1
    swapped = dict(rec, rm_labels=[list(x) for x in rec["rm_labels"]])
    swapped["rm_labels"][2][1] = 9
    assert reference.window_numbers([swapped], seq)["obj_label_err"] == 1
    dropped = dict(rec, motions=[m[:1] for m in rec["motions"]],
                   sm_labels=[s[:1] for s in rec["sm_labels"]],
                   rm_labels=[r[:1] for r in rec["rm_labels"]])
    assert reference.window_numbers([dropped], seq)["obj_missed"] > 0
    still = dict(rec, motions=[[np.eye(4) for _ in m] for m in rec["motions"]])
    nums = reference.window_numbers([still], seq)
    assert nums["obj_t_mean_mm"] > 100.0 and nums["obj_missed"] == 0
