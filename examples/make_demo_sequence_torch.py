#!/usr/bin/env python
"""Render a synthetic dynamic sequence to disk in the reference dataset
layout, plus a matching settings.yaml: the self-contained demo input of
``run_sequence_torch.py``, twin of ``examples/make_demo_sequence.py`` on
the port's numpy generator and PNG writer (no OpenCV, no JAX).

Usage: python examples/make_demo_sequence_torch.py [--kitti] <out_dir>
           [n_frames] [n_objects] [width height]

``width height`` default to the generator's 640x192; ``1242 375`` writes
the KITTI-scale sequence (KITTI intrinsics).  Produces (reference
example/sdpl_slam.cc:164-267 layout):

    <out_dir>/times.txt            timestamps
    <out_dir>/image_0/%06d.png     gray frames
    <out_dir>/depth/%06d.png       16-bit depth PNGs (factor 100)
    <out_dir>/semantic/%06d.txt    integer instance-label matrices
    <out_dir>/flow/%06d.flo        Middlebury forward flow
    <out_dir>/pose_gt.txt          camera GT (frame_id + 16 floats)
    <out_dir>/object_pose.txt      object GT rows (10 floats)
    <out_dir>/settings.yaml        matching intrinsics/config

With ``--kitti`` the sequence is in KITTI mode (``ChooseData: 2``), and
at ``1242 375`` its settings.yaml is :func:`kitti_settings`, the
configuration ``chip_smoke.py``'s KITTI phase tracks (the bench's caps,
window BA 20 / 4, the global BA, the dense-Schur step).  The
depth PNGs hold disparity, ``raw = 256 * bf / depth`` (the reader's
inverse, ``bf / (raw / 256)``), rounded and clipped to 16 bits: depths under
256 * bf / 65535 (1.51 m at bf = 387.5744) are written at that floor, and
the clipped pixels are counted and printed; the object rows are KITTI's
``[frame, id, B(4), t_camera(3), yaw]`` (``utils.synthetic.kitti_obj_rows``).

Then:  python examples/run_sequence_torch.py <out_dir>/settings.yaml <out_dir> demo_out
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SETTINGS_TEMPLATE = """%YAML:1.0
# Written by make_demo_sequence_torch.py for the demo sequence here.
Camera.fx: {fx}
Camera.fy: {fy}
Camera.cx: {cx}
Camera.cy: {cy}
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.k3: 0.0
Camera.width: {width}
Camera.height: {height}
Camera.fps: 10.0
Camera.bf: {bf!r}
Camera.RGB: 1
ChooseData: {choose_data}
DepthMapFactor: {depth_factor!r}
ThDepthBG: 40.0
ThDepthOBJ: 25.0
MaxTrackPointBG: 1200
MaxTrackPointOBJ: 800
SFMgThres: 0.12
SFDsThres: 0.3
WINDOW_SIZE: 20
OVERLAP_SIZE: 4
UseSampleFeature: 0
ORBextractor.nFeatures: 2500
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""

DEPTH_FACTOR = 100.0
KITTI_DEPTH_FACTOR = 256.0     # KITTI disparity PNGs (the reference's yaml)
BF = 387.5744


def _write_label_matrix(path, mask: np.ndarray) -> None:
    """``np.savetxt(path, mask, fmt="%d")`` for a matrix of few distinct
    non-negative labels, by table lookup (about 10x faster at KITTI
    size)."""
    table = np.array([b"%d" % v for v in range(int(mask.max()) + 1)],
                     dtype=object)
    with open(path, "wb") as f:
        for row in table[mask]:
            f.write(b" ".join(row) + b"\n")


def kitti_settings(cfg):
    """KITTI mode on the bench's configuration (``utils.synthetic.
    lba_settings``: reference caps, detectors in the loop, window BA 20 /
    4): disparity depth at this writer's factor and bf, the global BA by
    KITTI's default (``run_global_ba`` unset), the dense-Schur step for
    both BAs, and the reference's boundary shrink (25 / 50 px)."""
    from sdpl_slam_torch.utils.synthetic import lba_settings

    s = lba_settings(cfg)
    s.choose_data = 2
    s.depth_map_factor = KITTI_DEPTH_FACTOR
    s.bf = BF
    s.run_global_ba = None
    s.ba_schur = True
    s.boundary_shrink_x, s.boundary_shrink_y = 25, 50
    return s


def write_sequence(root, seq, n_files: int, extra_settings: str = "",
                   kitti: bool = False) -> int:
    """Write frames 0..n_files-1 of ``seq`` (a
    ``sdpl_slam_torch.utils.synthetic.SynthSequence``) under ``root`` with
    a settings.yaml of its intrinsics; ``extra_settings`` is appended to
    the yaml (``key: value`` lines; a later key overrides an earlier).
    ``kitti``: KITTI mode (disparity PNGs, KITTI object rows).  Returns the
    number of depth pixels clipped to the 16-bit range."""
    from sdpl_slam_torch.io import dataset, png
    from sdpl_slam_torch.utils.synthetic import kitti_obj_rows

    root = Path(root)
    cfg = seq.cfg
    for d in ("image_0", "depth", "semantic", "flow"):
        (root / d).mkdir(parents=True, exist_ok=True)
    np.savetxt(root / "times.txt", np.arange(n_files) * 0.1, fmt="%.6f")
    poses, objposes = [], []
    clipped = 0
    for i in range(n_files):
        f = seq.frame(i)
        png.write_png(root / "image_0" / f"{i:06d}.png", f.gray)
        if kitti:
            with np.errstate(divide="ignore"):
                raw = np.where(f.depth > 0,
                               KITTI_DEPTH_FACTOR * BF / f.depth, 0.0)
            clipped += int((raw > 65535).sum())
            raw = np.rint(np.clip(raw, 0, 65535))
        else:
            raw = np.clip(f.depth, 0, 300) * DEPTH_FACTOR
        png.write_png(root / "depth" / f"{i:06d}.png", raw.astype(np.uint16))
        _write_label_matrix(root / "semantic" / f"{i:06d}.txt", f.mask)
        dataset.write_flo(root / "flow" / f"{i:06d}.flo", f.flow)
        poses.append([i] + list(f.gt_pose.astype(np.float64).ravel()))
        rows = kitti_obj_rows(cfg, i, f.obj_rows) if kitti else f.obj_rows
        for row in rows:
            objposes.append(list(row) + [0.0] * max(0, 10 - len(row)))
    np.savetxt(root / "pose_gt.txt", np.asarray(poses), fmt="%.9f")
    if objposes:
        np.savetxt(root / "object_pose.txt", np.asarray(objposes),
                   fmt="%.9f")
    (root / "settings.yaml").write_text(SETTINGS_TEMPLATE.format(
        fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy,
        width=cfg.width, height=cfg.height, bf=BF,
        choose_data=2 if kitti else 1,
        depth_factor=KITTI_DEPTH_FACTOR if kitti else DEPTH_FACTOR)
        + extra_settings)
    return clipped


def main(argv):
    kitti = "--kitti" in argv
    argv = [a for a in argv if a != "--kitti"]
    if len(argv) < 2 or len(argv) == 5:
        print(__doc__)
        return 1
    from sdpl_slam_torch.utils.synthetic import (SynthConfig, SynthSequence,
                                                 kitti_config)

    root = Path(argv[1])
    n = int(argv[2]) if len(argv) > 2 else 30
    n_objects = int(argv[3]) if len(argv) > 3 else 2
    cfg = SynthConfig(n_frames=n + 1, n_objects=n_objects, noise_flow=0.2)
    if len(argv) > 5:
        width, height = int(argv[4]), int(argv[5])
        if (width, height) == (1242, 375):
            cfg = kitti_config(n_frames=n + 1)
            cfg.n_objects = n_objects
        else:
            # the default camera, scaled to the new width
            k = width / cfg.width
            cfg.width, cfg.height = width, height
            cfg.fx, cfg.fy = cfg.fx * k, cfg.fy * k
            cfg.cx, cfg.cy = width / 2.0, height / 2.0
    extra = ""
    if kitti and (cfg.width, cfg.height) == (1242, 375):
        from sdpl_slam_torch.utils.config import format_overrides

        extra = format_overrides(kitti_settings(cfg))
    clipped = write_sequence(root, SynthSequence(cfg), n + 1, extra,
                             kitti=kitti)
    print(f"demo sequence written to {root} ({n + 1} frames of "
          f"{cfg.width}x{cfg.height}, {n_objects} objects"
          f"{', KITTI mode' if kitti else ''}; {clipped} depth pixels "
          f"clipped to 16 bits)")
    print(f"next: python examples/run_sequence_torch.py {root}/settings.yaml "
          f"{root} demo_out")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
