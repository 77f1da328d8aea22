"""The port's I/O without OpenCV or PyYAML: the flat yaml parser against
PyYAML on the shipped settings files, the numpy+zlib PNG codec against
OpenCV and the native libpng decoder, and the sequence loaders against the
JAX package's on one written sequence."""

import dataclasses
import importlib.util
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import yaml

from sdpl_slam_tpu.io import dataset as jax_dataset
from sdpl_slam_tpu.utils import config as jax_config
from sdpl_slam_torch.io import dataset, native, png
from sdpl_slam_torch.io.prefetch import FramePrefetcher
from sdpl_slam_torch.models.system import System
from sdpl_slam_torch.utils import config
from sdpl_slam_torch.utils.synthetic import (SynthConfig, SynthSequence,
                                             lba_settings)

ROOT = Path(__file__).resolve().parents[1]
YAMLS = ("kitti", "omd", "tum")


# ------------------------------- yaml --------------------------------------
@pytest.mark.parametrize("name", YAMLS)
def test_flat_yaml_matches_pyyaml(name):
    text = (ROOT / "examples" / (name + ".yaml")).read_text()
    ours = config.parse_flat_yaml(text)
    ref = yaml.safe_load("\n".join(
        l for l in text.splitlines() if not l.lstrip().startswith("%")))
    assert ours == ref and len(ours) >= 25
    assert {k: type(v) for k, v in ours.items()} == \
           {k: type(v) for k, v in ref.items()}


@pytest.mark.parametrize("name", YAMLS)
def test_shipped_yaml_loads_and_system_constructs(name):
    """``System(settings.yaml)`` constructs from every shipped file, with
    the same settings as the JAX package reads apart from the port's
    ``pipelined_tracking`` default."""
    path = ROOT / "examples" / (name + ".yaml")
    ours = dataclasses.asdict(config.load_settings(path))
    theirs = dataclasses.asdict(jax_config.load_settings(path))
    assert ours.pop("pipelined_tracking") is False
    assert theirs.pop("pipelined_tracking") is True
    assert ours == theirs
    system = System(path, verbose=False, device="cpu")
    assert system.settings.width > 0 and system.settings.use_lines


def test_flat_yaml_scalars_and_refusals():
    got = config.parse_flat_yaml(
        "%YAML:1.0\n---\n# comment\n\nA.b: 1\nc: -2.5e-3 # trailing\n"
        "d: true\ne: False\nf: ~\ng: 'x y'\nh: text\ni: 0x10\nj:\n")
    assert got == {"A.b": 1, "c": -2.5e-3, "d": True, "e": False, "f": None,
                   "g": "x y", "h": "text", "i": "0x10", "j": None}
    for bad in ("a:\n  b: 1\n", "a: [1, 2]\n", "- a\n", "a: {b: 1}\n"):
        with pytest.raises(ValueError):
            config.parse_flat_yaml(bad)


def test_overrides_round_trip(tmp_path):
    s = lba_settings(SynthConfig(n_frames=2))
    s.run_global_ba = True
    s.stop_frame = 7
    s.ba_dtype = "mixed"
    path = tmp_path / "s.yaml"
    path.write_text("%YAML:1.0\nCamera.fx: 1.0\n" + config.format_overrides(s))
    assert dataclasses.asdict(config.load_settings(path)) == dataclasses.asdict(s)
    assert "yaml" not in config.load_settings.__code__.co_names


# -------------------------------- png --------------------------------------
def _filter_rows(rows, types, bpp):
    """Reference PNG row filtering, byte by byte (the spec's definitions)."""
    h, n = rows.shape
    out = np.zeros((h, n), np.uint8)
    for r in range(h):
        for i in range(n):
            a = int(rows[r, i - bpp]) if i >= bpp else 0
            b = int(rows[r - 1, i]) if r else 0
            c = int(rows[r - 1, i - bpp]) if r and i >= bpp else 0
            if types[r] == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                pred = (0, a, b, (a + b) // 2)[types[r]]
            out[r, i] = (int(rows[r, i]) - pred) & 255
    return out


def _png_bytes(img, types):
    """A PNG of ``img`` whose row r uses filter ``types[r]``."""
    import struct

    ch = 1 if img.ndim == 2 else img.shape[2]
    depth = 8 * img.dtype.itemsize
    rows = (img.astype(">u2") if depth == 16 else img).view(np.uint8)
    rows = np.ascontiguousarray(rows).reshape(img.shape[0], -1)
    filt = _filter_rows(rows, types, ch * depth // 8)
    body = np.concatenate([np.asarray(types, np.uint8)[:, None], filt], 1)
    ihdr = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], depth,
                       {1: 0, 2: 4, 3: 2, 4: 6}[ch], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(body.tobytes()))
            + png._chunk(b"IEND", b""))


def _images():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:23, 0:31]
    smooth = (xx * 7 + yy * 5) % 256
    return {
        "grey8": (smooth + rng.integers(0, 9, smooth.shape)).astype(np.uint8),
        "grey16": (smooth * 200 + rng.integers(0, 999, smooth.shape)).astype(np.uint16),
        "rgb8": rng.integers(0, 256, (23, 31, 3)).astype(np.uint8),
        "greyalpha8": rng.integers(0, 256, (23, 31, 2)).astype(np.uint8),
        "rgba8": rng.integers(0, 256, (23, 31, 4)).astype(np.uint8),
    }


@pytest.mark.parametrize("name", sorted(_images()))
def test_png_reads_all_filter_types(name, tmp_path):
    """Every row filter (None, Sub, Up, Average, Paeth), mixed in one file
    and each alone, decodes to the image; OpenCV and the native decoder
    read the same files the same."""
    img = _images()[name]
    h = img.shape[0]
    mixes = [[r % 5 for r in range(h)], [(r * 3 + 1) % 3 for r in range(h)]]
    mixes += [[t] * h for t in range(5)]
    for types in mixes:
        data = _png_bytes(img, types)
        np.testing.assert_array_equal(png.decode_png(data), img)
    path = tmp_path / "mixed.png"
    path.write_bytes(_png_bytes(img, mixes[0]))
    if img.ndim == 2 or img.shape[2] != 2:       # OpenCV expands grey+alpha
        ref = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if ref.ndim == 3:
            ref = ref[..., [2, 1, 0] + ([3] if ref.shape[2] == 4 else [])]
        np.testing.assert_array_equal(ref, img)
    if native.available():
        np.testing.assert_array_equal(native.read_png(str(path)), img)


@pytest.mark.parametrize("name", sorted(_images()))
def test_png_write_read_round_trip(name, tmp_path):
    img = _images()[name]
    path = tmp_path / (name + ".png")
    png.write_png(path, img)
    np.testing.assert_array_equal(png.read_png(path), img)
    if native.available():
        np.testing.assert_array_equal(native.read_png(str(path)), img)
    if img.ndim == 2:
        np.testing.assert_array_equal(
            cv2.imread(str(path), cv2.IMREAD_UNCHANGED), img)
        cv2.imwrite(str(path), img)              # OpenCV's own filter choice
        np.testing.assert_array_equal(png.read_png(path), img)


def test_png_refuses_what_it_cannot_read(tmp_path):
    with pytest.raises(ValueError, match="signature"):
        png.decode_png(b"not a png at all")
    pal = tmp_path / "pal.png"
    import struct
    pal.write_bytes(b"\x89PNG\r\n\x1a\n" + png._chunk(
        b"IHDR", struct.pack(">IIBBBBB", 2, 2, 8, 3, 0, 0, 0))
        + png._chunk(b"IDAT", zlib.compress(b"\0\0\0\0\0\0"))
        + png._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="unsupported PNG"):
        png.read_png(pal)
    with pytest.raises(ValueError, match="uint8 or uint16"):
        png.encode_png(np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError, match="only PNG"):
        dataset.read_image_gray(tmp_path / "x.jpg")


# ------------------------------ loaders ------------------------------------
@pytest.fixture(scope="module")
def written(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "make_demo_sequence_torch",
        ROOT / "examples" / "make_demo_sequence_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    root = tmp_path_factory.mktemp("seq")
    cfg = SynthConfig(n_frames=4, n_objects=1, width=320, height=96,
                      fx=180.0, fy=180.0, cx=160.0, cy=48.0)
    seq = SynthSequence(cfg)
    mod.write_sequence(root, seq, 4)
    return root, seq


def test_loaders_match_jax(written):
    """Both packages read the written sequence to equal arrays."""
    root, seq = written
    a, b = dataset.load_sequence(root), jax_dataset.load_sequence(root)
    assert a.n_frames == b.n_frames == 3
    np.testing.assert_array_equal(a.timestamps, b.timestamps)
    np.testing.assert_array_equal(a.poses_gt, b.poses_gt)
    for i in range(4):
        for x, y in zip(a.frame(i), b.frame(i)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        assert len(a.gt_obj_poses(i)) == len(b.gt_obj_poses(i)) == 1
        np.testing.assert_array_equal(a.gt_obj_poses(i)[0], b.gt_obj_poses(i)[0])
        np.testing.assert_array_equal(a.gt_pose(i), b.gt_pose(i))
    f = seq.frame(2)
    gray, depth, flow, mask = a.frame(2)
    np.testing.assert_array_equal(gray, f.gray)
    np.testing.assert_array_equal(mask, f.mask)
    np.testing.assert_array_equal(flow, f.flow)
    np.testing.assert_allclose(depth / 100.0, np.clip(f.depth, 0, 300), atol=0.01)


def test_loaders_without_the_native_library(written, monkeypatch):
    """With the native library absent the numpy readers give the same
    arrays, and ``png_decoder`` says which one ran."""
    root, _ = written
    with_native = dataset.load_sequence(root).frame(1)
    name = dataset.png_decoder()
    assert name == ("native libpng" if native.available() else "numpy+zlib")
    monkeypatch.setattr(native, "available", lambda: False)
    assert dataset.png_decoder() == "numpy+zlib"
    plain = dataset.load_sequence(root).frame(1)
    for x, y in zip(plain, with_native):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        dataset.read_image_gray(root / "image_0" / "000001.png"), plain[0])
    np.testing.assert_array_equal(
        dataset.read_depth_png(root / "depth" / "000001.png"), plain[1])


def test_rgb_image_reads_as_luma(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (9, 11, 3)).astype(np.uint8)
    png.write_png(tmp_path / "c.png", rgb)
    want = jax_dataset.read_image_gray(tmp_path / "c.png")
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_array_equal(dataset.read_image_gray(tmp_path / "c.png"), want)


def test_flo_round_trip_and_prefetcher(written, tmp_path):
    root, seq = written
    dataset.write_flo(tmp_path / "f.flo", seq.frame(0).flow)
    np.testing.assert_array_equal(dataset.read_flo(tmp_path / "f.flo"),
                                  jax_dataset.read_flo(tmp_path / "f.flo"))
    loaded = dataset.load_sequence(root)
    pf = FramePrefetcher(loaded.frame, loaded.n_frames, lookahead=2)
    seen = []
    for i, frame in pf:
        nxt = pf.peek(i + 1)
        assert (nxt is None) == (i + 1 >= loaded.n_frames)
        np.testing.assert_array_equal(frame[0], seq.frame(i).gray)
        seen.append(i)
    pf.close()
    assert seen == [0, 1, 2]
