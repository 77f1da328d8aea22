#!/usr/bin/env python
"""The line detector of the PyTorch port on a CUDA card against the CPU,
stage by stage, on one KITTI-scale synthetic frame: each stage is given
the CPU's inputs on both devices, so a difference is that stage's own;
then the whole detector end to end, with the segments that have no
counterpart.  Needs a CUDA card.

Usage: python examples/lines_card_vs_cpu.py [mode]     (0 LSD-style, 1 EDLines-style)
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from sdpl_slam_torch.ops import lines as L  # noqa: E402
from sdpl_slam_torch.utils.synthetic import SynthSequence, kitti_config  # noqa: E402


def _cmp(name, a, b):
    a, b = a.cpu(), b.cpu()
    if not a.dtype.is_floating_point:
        print("%-28s mismatches %d of %d" % (name, int((a != b).sum()), a.numel()))
        return
    d = (a - b).abs()
    d = d[torch.isfinite(d)]
    print("%-28s max abs diff %.3g, over 1e-3: %d of %d" % (
        name, float(d.max()) if d.numel() else 0.0, int((d > 1e-3).sum()),
        a.numel()))


def main(argv):
    mode = int(argv[1]) if len(argv) > 1 else 0
    gray = torch.from_numpy(SynthSequence(kitti_config(n_frames=2)).frame(0).gray)
    cfg = L.LineDetectConfig(max_lines=800, min_length=8.0, mode=mode)
    edges = L._ed_edges if mode == 1 else L._thin_edges

    def card(x):
        return x.cuda()

    img = gray.float()
    octaves = []
    for o in range(cfg.n_octaves):
        if o:
            img = L._downsample2(img)
        ocfg = cfg._replace(min_length=cfg.min_length / 2 ** o,
                            min_support=max(4, cfg.min_support // (1 + o)))
        print("--- octave", o, tuple(img.shape))
        gx, gy = L._sobel(img)
        gxc, gyc = L._sobel(card(img))
        _cmp("sobel gx", gx, gxc)
        _cmp("sobel gy", gy, gyc)
        mag = torch.sqrt(gx * gx + gy * gy)
        _cmp("mag", mag, torch.sqrt(gxc * gxc + gyc * gyc))
        e = edges(mag, gx, gy, cfg.grad_threshold)
        _cmp("edge map", e, edges(card(mag), card(gx), card(gy),
                                  cfg.grad_threshold))
        seg, ok = L._tile_fit(e, mag, cfg.tile, ocfg.min_support,
                              cfg.min_anisotropy, gx=gx, gy=gy)
        segc, okc = L._tile_fit(card(e), card(mag), cfg.tile,
                                ocfg.min_support, cfg.min_anisotropy,
                                gx=card(gx), gy=card(gy))
        _cmp("tile_fit ok", ok, okc)
        both = ok & okc.cpu()
        _cmp("tile_fit seg (both ok)", seg[both], segc.cpu()[both])
        r = L._refine_endpoints(seg, ok, e, mag, cfg.refine_steps)
        rc = L._refine_endpoints(card(seg), card(ok), card(e), card(mag),
                                 cfg.refine_steps)
        _cmp("refine_endpoints", r[ok], rc.cpu()[ok])
        m, mok = L._merge_rounds(r, ok, ocfg)
        mc, mokc = L._merge_rounds(card(r), card(ok), ocfg)
        _cmp("merge_rounds ok", mok, mokc)
        both = mok & mokc.cpu()
        _cmp("merge_rounds seg", m[both], mc.cpu()[both])
        flat = m.reshape(-1, 4)
        v = mok.reshape(-1) & (L._norm(flat[:, 2:] - flat[:, :2])
                               >= 0.5 * ocfg.min_length)
        best, k, n = L._nfa_significance(flat, gx, gy, ocfg)
        bestc, kc, nc = L._nfa_significance(card(flat), card(gx), card(gy), ocfg)
        _cmp("nfa k", k[v], kc.cpu()[v])
        _cmp("nfa n", n[v], nc.cpu()[v])
        fin = torch.isfinite(best) & v
        _cmp("nfa significance", best[fin], bestc.cpu()[fin])
        _cmp("nfa gate", (best > 0) & v, (bestc.cpu() > 0) & v)
        s = L._detect_octave(img, ocfg)
        octaves.append(L.Segments(s.uv4 * 2 ** o, s.length * 2 ** o, s.valid))
    uv4 = torch.cat([x.uv4 for x in octaves])
    valid = torch.cat([x.valid for x in octaves])
    ma, mac = L._merge_all(uv4, valid, cfg), L._merge_all(card(uv4), card(valid), cfg)
    _cmp("merge_all valid", ma.valid, mac.valid)
    both = ma.valid & mac.valid.cpu()
    _cmp("merge_all uv4", ma.uv4[both], mac.uv4.cpu()[both])

    a = L.detect_lines_np(gray.numpy(), cfg, device="cuda")
    again = L.detect_lines_np(gray.numpy(), cfg, device="cuda")
    b = L.detect_lines_np(gray.numpy(), cfg, device="cpu")
    print("--- end to end: card %d segments (twice identical: %s), CPU %d"
          % (len(a), np.array_equal(a, again), len(b)))
    dm = np.inf
    for other in (b, b[:, [2, 3, 0, 1]]):           # either endpoint order
        d = (a[:, None, :] - other[None, :, :]).reshape(len(a), len(b), 2, 2)
        dm = np.minimum(dm, np.sqrt((d ** 2).sum(-1)).max(-1))
    for tol in (0.01, 0.1, 0.5, 2.0, 5.0):
        print("both endpoints within %.2f px: card->cpu %.3f, cpu->card %.3f"
              % (tol, (dm.min(1) < tol).mean(), (dm.min(0) < tol).mean()))
    for i in np.nonzero(dm.min(1) >= 0.5)[0]:
        print("card", a[i].round(2), "nearest on the CPU",
              b[dm[i].argmin()].round(2), "at %.2f px" % dm[i].min())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
