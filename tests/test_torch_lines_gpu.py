"""The line detector's two hand-written kernels on a CUDA card
(``csrc/line_detect.cu``): ``ops.lines.nfa_significance_cuda`` and
``merge_rounds_cuda`` against the plain chains ``_nfa_significance_torch``
and ``_merge_rounds_torch`` on the same card inputs, at both benchmark
cells' image sizes (1242x375 and 640x480, both octaves, both edge modes)
on a synthetic frame with structure lines; the whole ``detect_lines``
through the kernels against the plain chains patched in; the launch
counters, eager and through a captured detector program; and the
wrappers' refusals.  Skipped where there is no card.  This file imports no
JAX:

    python -m pytest tests/test_torch_lines_gpu.py -m gpu --noconftest -p no:cacheprovider

Tolerances: the merge rounds are elementwise float32 with correctly
rounded division and square root, so kernel and plain chain agree bit for
bit.  The NFA gate's counts are exact and equal; its significance goes
through lgammaf, logf, log1pf, expf and log10f, which the kernel and
PyTorch's elementwise kernels may take from different builds of the CUDA
math library (a few ulps), so ``best`` agrees within 1e-4 and the gate's
decision wherever ``|best|`` is at least 1e-3 (``test_nfa_gate``'s rule
against the JAX package).  Whole detections: both endpoints within
chip_smoke.py's ``LINE_MATCH_PX`` for at least 0.99 of either set.
"""

import numpy as np
import pytest
import torch

from sdpl_slam_torch.models import frame_program
from sdpl_slam_torch.ops import lines as L
from sdpl_slam_torch.utils.synthetic import (SynthConfig, SynthSequence,
                                             kitti_config)

# the two cells' frames: kitti.track (1242x375) and omd.track (640x480)
SHAPES = ("kitti", "omd")
MATCH_MIN = 0.99


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _config(shape):
    if shape == "kitti":
        return kitti_config(n_frames=1)
    return SynthConfig(width=640, height=480, cx=320.0, cy=240.0,
                       n_frames=1, n_objects=4)


def _line_cfg(sc, mode=0):
    """The tracker's line detector at the cells' settings
    (``Tracking._line_cfg``: 800 candidates, 2 octaves)."""
    return L.LineDetectConfig(max_lines=800,
                              min_length=max(8.0, 0.02 * min(sc.width,
                                                             sc.height)),
                              n_octaves=2, mode=mode)


@pytest.fixture(scope="module")
def frames(cuda):
    """shape -> (grey uint8 image on the card, the synthetic config)."""
    out = {}
    for shape in SHAPES:
        sc = _config(shape)
        f = SynthSequence(sc).frame(0)
        assert f.lines is not None and len(f.lines)
        out[shape] = (torch.from_numpy(f.gray).to(cuda), sc)
    return out


@pytest.fixture(scope="module")
def stage_inputs(frames):
    """(shape, octave, mode) -> what one ``detect_lines`` call on the card
    hands the two stages (``chip_smoke.line_stage_calls``, the plain
    chains in place): the refined tile segments (the merge's input) and
    the merged candidates with the gradients (the NFA gate's)."""
    import chip_smoke

    out = {}
    for shape, (img, sc) in frames.items():
        for mode in (0, 1):
            calls = chip_smoke.line_stage_calls(img, _line_cfg(sc, mode))
            for o, c in enumerate(calls):
                out[shape, o, mode] = dict(
                    cfg=c["cfg"], seg=c["seg"], ok=c["ok"], flat=c["flat"],
                    valid=c["merged"][1].reshape(-1), gx=c["gx"], gy=c["gy"])
    return out


CASES = [(s, o, m) for s in SHAPES for o in (0, 1) for m in (0, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=lambda c: "%s-o%d-m%d" % c)
def test_merge_rounds_kernel_bit_for_bit(stage_inputs, case):
    s = stage_inputs[case]
    ref_seg, ref_ok = L._merge_rounds_torch(s["seg"], s["ok"], s["cfg"])
    got_seg, got_ok = L.merge_rounds_cuda(s["seg"], s["ok"], s["cfg"])
    torch.cuda.synchronize()
    assert int(ref_ok.sum()) < int(s["ok"].sum())      # some tiles merged
    assert torch.equal(got_ok, ref_ok)
    assert torch.equal(got_seg, ref_seg)


@pytest.mark.gpu
def test_merge_rounds_kernel_in_device_memory(stage_inputs):
    """A grid too large for a block's shared memory (4 copies of the KITTI
    grid, 28,520 tiles) runs on the output buffers, bit for bit too."""
    s = stage_inputs["kitti", 0, 0]
    seg = s["seg"].repeat(2, 2, 1).contiguous()
    ok = s["ok"].repeat(2, 2).contiguous()
    ref_seg, ref_ok = L._merge_rounds_torch(seg, ok, s["cfg"])
    got_seg, got_ok = L.merge_rounds_cuda(seg, ok, s["cfg"])
    torch.cuda.synchronize()
    assert 17 * ok.numel() > 227 * 1024
    assert int(ref_ok.sum()) < int(ok.sum())
    assert torch.equal(got_ok, ref_ok)
    assert torch.equal(got_seg, ref_seg)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=lambda c: "%s-o%d-m%d" % c)
def test_nfa_kernel_against_plain(stage_inputs, case):
    s = stage_inputs[case]
    args = (s["flat"], s["gx"], s["gy"], s["cfg"])
    ref_best, ref_k, ref_n = L._nfa_significance_torch(*args)
    best, k, n = L.nfa_significance_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(k, ref_k)
    assert torch.equal(n, ref_n)
    finite = torch.isfinite(ref_best)
    assert torch.equal(torch.isfinite(best), finite)
    assert torch.equal(best[~finite], ref_best[~finite])
    assert float((best[finite] - ref_best[finite]).abs().max()) <= 1e-4
    eps = s["cfg"].nfa_log_eps
    far = (ref_best - eps).abs() >= 1e-3
    assert torch.equal((best > eps)[far], (ref_best > eps)[far])
    # the gate keeps some candidates and drops others
    gate = s["valid"] & (best > eps)
    assert 0 < int(gate.sum()) < int(s["valid"].sum())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", (0, 1))
@pytest.mark.parametrize("shape", SHAPES)
def test_detect_lines_kernel_path_against_plain(frames, monkeypatch, shape,
                                                mode):
    import chip_smoke

    img, sc = frames[shape]
    cfg = _line_cfg(sc, mode)

    def compact(seg):
        keep = seg.valid.cpu().numpy()
        return seg.uv4.cpu().numpy()[keep]

    got = compact(L.detect_lines(img, cfg))
    with monkeypatch.context() as m:
        m.setattr(L, "_nfa_significance", L._nfa_significance_torch)
        m.setattr(L, "_merge_rounds", L._merge_rounds_torch)
        ref = compact(L.detect_lines(img, cfg))
    assert len(got) > 10 and len(ref) > 10
    px = chip_smoke.LINE_MATCH_PX
    assert chip_smoke._match_frac(got, ref, px) >= MATCH_MIN
    assert chip_smoke._match_frac(ref, got, px) >= MATCH_MIN


def _counts():
    return (L.nfa_significance_cuda.launches, L.merge_rounds_cuda.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
def test_launch_counters(frames, cuda, shape):
    img, sc = frames[shape]
    cfg = _line_cfg(sc)
    before = _counts()
    L.detect_lines(img, cfg)
    assert _counts() == (before[0] + 2, before[1] + 2)   # one an octave
    # no launch where the plain chain skips the work
    before = _counts()
    L.detect_lines(img, cfg._replace(nfa_gate=False, merge_rounds=0))
    assert _counts() == before
    # a captured detector program: its capture's launches once a replay
    prog = frame_program.detector_program(tuple(img.shape), np.uint8, None,
                                          cfg, cuda)
    stream = frame_program.detector_stream(cuda)
    with torch.cuda.stream(stream):
        prog.load({"img": img.cpu().numpy()})
        prog.run_stage(0)                    # captured at the first call
        before = _counts()
        for _ in range(3):
            prog.run_stage(0)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 6, before[1] + 6)
    # the line stage's graph: the two chains are 4 kernel nodes now, of
    # 1,154 at both sizes on an H100 (~10,500 with the plain chains)
    assert sum(prog.node_counts[0]) <= 1200


@pytest.mark.gpu
def test_wrappers_refuse(stage_inputs, cuda):
    s = stage_inputs["omd", 1, 0]
    seg, ok, cfg = s["seg"], s["ok"], s["cfg"]
    flat, gx, gy = s["flat"], s["gx"], s["gy"]
    for bad in ((seg.double(), ok), (seg, ok.float()),
                (seg.transpose(0, 1).contiguous().transpose(0, 1), ok),
                (seg, ok.t().contiguous().t()), (seg.cpu(), ok.cpu()),
                (seg, ok.cpu())):
        with pytest.raises(ValueError):
            L.merge_rounds_cuda(*bad, cfg)
    for bad in ((flat.double(), gx, gy), (flat, gx.half(), gy),
                (flat.t().contiguous().t(), gx, gy),
                (flat, gx.t().contiguous().t(), gy),
                (flat.cpu(), gx.cpu(), gy.cpu()), (flat, gx, gy.cpu()),
                (flat[:, :3].contiguous(), gx, gy)):
        with pytest.raises(ValueError):
            L.nfa_significance_cuda(*bad, cfg)
