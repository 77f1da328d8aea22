"""The routing of the line detector's two card kernels, on the CPU:
``ops.lines._nfa_significance`` and ``_merge_rounds`` run the plain chains
for CPU tensors and never reach ``nfa_significance_cuda`` or
``merge_rounds_cuda`` (their launch counters stay where they were, the
kernel library is never built), with the plain chains' results; and each
wrapper refuses, with ValueError, a CPU tensor, a wrong dtype or shape, and
a non-contiguous input.  The kernels themselves run in
``tests/test_torch_lines_gpu.py`` on a card."""

import pytest
import torch

from sdpl_slam_torch.ops import lines as L
from sdpl_slam_torch.utils.synthetic import SynthConfig, SynthSequence


@pytest.fixture(scope="module")
def octave():
    """The merge's and the NFA gate's inputs of octave 0 on a 320x96
    synthetic frame, as ``detect_lines`` hands them
    (``chip_smoke.line_stage_calls``)."""
    import chip_smoke

    sc = SynthConfig(width=320, height=96, cx=160.0, cy=48.0, n_frames=1)
    img = torch.from_numpy(SynthSequence(sc).frame(0).gray).float()
    cfg = L.LineDetectConfig(max_lines=200, min_length=8.0)
    c = chip_smoke.line_stage_calls(img, cfg)[0]
    return dict(img=img, cfg=cfg, gx=c["gx"], gy=c["gy"], seg=c["seg"],
                ok=c["ok"], flat=c["flat"])


def _counts():
    return (L.nfa_significance_cuda.launches, L.merge_rounds_cuda.launches)


def test_cpu_tensors_take_the_plain_chains(octave):
    o, before = octave, _counts()
    seg, ok = L._merge_rounds(o["seg"], o["ok"], o["cfg"])
    ref_seg, ref_ok = L._merge_rounds_torch(o["seg"], o["ok"], o["cfg"])
    assert torch.equal(seg, ref_seg) and torch.equal(ok, ref_ok)
    assert int(ok.sum()) < int(o["ok"].sum())           # tiles merged
    got = L._nfa_significance(o["flat"], o["gx"], o["gy"], o["cfg"])
    ref = L._nfa_significance_torch(o["flat"], o["gx"], o["gy"], o["cfg"])
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    segs = L.detect_lines(o["img"], o["cfg"])
    assert int(segs.valid.sum()) > 0
    assert _counts() == before
    assert L._line_kernels.cache_info().currsize == 0   # never built


def test_no_rounds_return_the_tiles(octave):
    o = octave
    cfg = o["cfg"]._replace(merge_rounds=0)
    seg, ok = L._merge_rounds(o["seg"], o["ok"], cfg)
    assert torch.equal(seg, o["seg"]) and torch.equal(ok, o["ok"])


def _merge_inputs(o):
    seg, ok = o["seg"], o["ok"]
    return {"cpu": (seg, ok), "seg dtype": (seg.double(), ok),
            "ok dtype": (seg, ok.float()), "seg shape": (seg[..., :3], ok),
            "seg layout": (seg.transpose(0, 1).contiguous().transpose(0, 1),
                           ok),
            "ok layout": (seg, ok.t().contiguous().t())}


def _nfa_inputs(o):
    flat, gx, gy = o["flat"], o["gx"], o["gy"]
    return {"cpu": (flat, gx, gy), "uv4 dtype": (flat.double(), gx, gy),
            "gx dtype": (flat, gx.half(), gy), "gy shape": (flat, gx, gy[1:]),
            "uv4 layout": (flat.t().contiguous().t(), gx, gy),
            "gy layout": (flat, gx, gy.t().contiguous().t())}


MESSAGES = {"cpu": "lies on cpu", "dtype": "wants torch", "shape": "wants",
            "layout": "not contiguous"}


@pytest.mark.parametrize("case", ("cpu", "seg dtype", "ok dtype",
                                  "seg shape", "seg layout", "ok layout"))
def test_merge_rounds_cuda_refuses(octave, case):
    before = _counts()
    with pytest.raises(ValueError, match=MESSAGES[case.split()[-1]]):
        L.merge_rounds_cuda(*_merge_inputs(octave)[case], octave["cfg"])
    assert _counts() == before


@pytest.mark.parametrize("case", ("cpu", "uv4 dtype", "gx dtype",
                                  "gy shape", "uv4 layout", "gy layout"))
def test_nfa_significance_cuda_refuses(octave, case):
    before = _counts()
    with pytest.raises(ValueError, match=MESSAGES[case.split()[-1]]):
        L.nfa_significance_cuda(*_nfa_inputs(octave)[case], octave["cfg"])
    assert _counts() == before
