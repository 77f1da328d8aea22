"""The benchmark's copy of the scene generator against the program's, and
its cache and flow noise."""

import numpy as np
import pytest

from slam_bench import scene

G = dict(width=320, height=128, fx=300.0, fy=300.0, cx=160.0, cy=64.0,
         n_objects=3, cam_speed=0.6, obj_speed=0.9)


def test_copy_renders_the_programs_noise_free_frames():
    from sdpl_slam_torch.utils.synthetic import SynthConfig, SynthSequence

    prog = SynthSequence(SynthConfig(n_frames=5, **G), cache=False)
    for t in range(5):
        f, r = prog.frame(t), scene.render(G, t)
        assert np.array_equal(f.gray, r["gray"])
        assert np.array_equal(f.mask, r["mask"].astype(np.int32))
        np.testing.assert_allclose(r["depth"], f.depth, atol=1e-4)
        np.testing.assert_allclose(r["flow"], f.flow, atol=1e-3)
        np.testing.assert_allclose(r["pose"], f.gt_pose, atol=1e-5)
        np.testing.assert_array_equal(r["rows"], np.stack(f.obj_rows))


def test_cache_is_written_once_and_read_back(tmp_path):
    a = scene.Sequence(G, 3, tmp_path)
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].name.startswith("frames-")
    b = scene.Sequence(G, 3, tmp_path)
    for k in ("gray", "depth", "flow", "mask", "pose"):
        assert np.array_equal(getattr(a, k), getattr(b, k))
    assert all(np.array_equal(x, y) for t in range(3)
               for x, y in zip(a.rows[t], b.rows[t]))
    assert scene.Sequence(dict(G, n_objects=2), 3, tmp_path).mask.max() == 2
    assert len(list(tmp_path.iterdir())) == 2


def test_noise_is_the_seeds_and_differs_by_frame():
    shape = (16, 24, 2)
    a, b = (scene.FlowNoise(2 ** 31 + 9, shape, 0.2, "cpu") for _ in range(2))
    c = scene.FlowNoise(2 ** 31 + 10, shape, 0.2, "cpu")
    assert np.array_equal(a.field(0, 3), b.field(0, 3))
    assert not np.array_equal(a.field(0, 3), c.field(0, 3))
    assert not np.array_equal(a.field(0, 3), a.field(0, 4))
    assert not np.array_equal(a.field(0, 3), a.field(1, 3))
    assert a.bank.std() == pytest.approx(0.2, rel=0.1)
    clean = np.ones(shape, np.float32)
    outs = [a.noisy(clean, 0, t) for t in range(scene.FlowNoise.RING)]
    assert len({id(o) for o in outs}) == scene.FlowNoise.RING
    np.testing.assert_array_equal(outs[2], clean + a.field(0, 2))
