"""Dense-Schur direct step for window-scale batch BA (counterpart of
the JAX package's ``solvers.schur_ba``).

The g2o back end eliminates the landmark vertices by a Schur complement
before it solves the reduced (pose + motion) system (``BlockSolver``; every
landmark vertex of the reference's batch optimisers is marginalised,
Optimizer.cc:4124,4233,4785).  :mod:`.batch_ba` instead runs matrix-free
CG over all edges.  For window-scale graphs the reduced system is small,
6 * (frames + motions) dof, so this module takes g2o's exact step:

* static points and lines have block-diagonal Hessian blocks (3x3, 4x4),
  inverted in one batched solve;
* dynamic points and lines are chained by the ternary motion edges (one
  vertex per observation, linked to its predecessor, Optimizer.cc:4763-
  4813): their Hessian is block-tridiagonal along each tracklet chain, and
  every chain is factored by block-Thomas, a loop over the K <= F chain
  positions batched over chains;
* the coupling blocks are dense per landmark family, ``Bt`` (P, d, NDOF),
  so the Schur complement ``S = A - Bt^T D^-1 Bt`` is one matrix product a
  family, and the damped step is a dense Cholesky solve.

One LM iteration is one linearization, the scatter assembly, the family
solves and products, and one (NDOF, NDOF) Cholesky: no CG loop.
:func:`run_ba_fused_schur` is JAX's ``run_ba_fused_schur``: on the card
one captured program whose LM loop ends on the device;
:func:`run_ba_schur`, its plain version, runs the same LM iteration
(``batch_ba.lm_iteration``) from the host with one read an iteration.

Where the JAX module relies on XLA, this one says so explicitly:

* every scatter-add goes through ``utils.device.scatter_add`` on flat
  indices (a fixed order of summation on the card too, so a Schur BA
  repeats bit for bit);
* JAX's Cholesky returns NaNs on a matrix that is not positive definite,
  and the JAX step falls back to an LU solve when the solution is not
  finite.  ``cholesky_ex`` reports the failure in ``info`` and may return
  a finite partial factor, so the fallback fires on ``info != 0`` or a
  non-finite solution, chosen on the device with ``torch.where`` (both
  solves run; no host read; the LU in float64, :func:`_solve_reduced`);
* the inverses are ``inv_ex`` / ``solve_ex`` (no error check, so no host
  synchronisation), with JAX's ``1e-10 * I`` and ``1e-8 * I``.

``ba_builder`` pads graphs and chain tables to JAX's buckets; a padded
vertex has no edge and forms a chain of its own, a padded chain row is
all -1.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import scatter_add
from . import batch_ba as bb

MAX_DENSE_DOF = 2048


class SchurMeta(NamedTuple):
    """Chain structure of the dynamic landmark families.

    ``xd_chain``: (NC, K) int64 vertex ids forming each block-tridiagonal
    chain (consecutive ids by construction of ``build_graph``), -1 padded;
    every vertex of the family in one row (:func:`chains_from_links` over
    the family's count; :func:`_meta` checks it).  ``ld_chain``: the
    same for the dynamic line vertices."""

    xd_chain: torch.Tensor
    ld_chain: torch.Tensor
    n_frames: int
    n_motions: int


def chains_from_links(n_verts: int, link_prev: np.ndarray, k_max: int,
                      valid: np.ndarray | None = None):
    """Maximal runs of consecutive vertex ids connected by ternary links (a
    link at i couples blocks i and i + 1).  Returns an (NC, k_max) int32
    matrix, -1 padded.

    ``valid`` masks out padding entries of ``link_prev`` (the graph's
    ``tern_valid``); without it a padding zero would make a false 0 -> 1
    link.  Real runs are one tracklet's consecutive vertices, one a window
    frame, so a run never exceeds ``k_max`` = F; that is asserted, because
    splitting a longer run would drop its coupling block and the step would
    not be exact."""
    n = max(int(n_verts), 0)
    if n == 0:
        return np.full((1, k_max), -1, np.int32)
    has_link = np.zeros(n, bool)
    lp = np.asarray(link_prev, np.int64)
    if valid is not None:
        lp = lp[np.asarray(valid, bool)[: len(lp)]]
    lp = lp[(lp >= 0) & (lp < n - 1)]
    has_link[lp] = True
    starts = np.nonzero(np.concatenate([[True], ~has_link[:-1]]))[0]
    ends = np.concatenate([starts[1:], [n]])
    run_max = int((ends - starts).max())
    if valid is not None and run_max > k_max:
        raise AssertionError(
            f"ternary chain of length {run_max} exceeds window size "
            f"{k_max}; graph construction invariant violated")
    rows = []
    for s, e in zip(starts, ends):
        i = s
        while i < e:
            ln = min(e - i, k_max)
            row = np.full(k_max, -1, np.int32)
            row[:ln] = np.arange(i, i + ln, dtype=np.int32)
            rows.append(row)
            i += ln
    return np.stack(rows).astype(np.int32)


# ---------------------------------------------------------------------------
# batched block-tridiagonal solve (block-Thomas over chains)
# ---------------------------------------------------------------------------


def _eye(d, like):
    return torch.eye(d, dtype=like.dtype, device=like.device)


def _tridiag_solve(chain, Dd, Eo, rhs):
    """Solve the block-tridiagonal system along every chain.

    chain: (NC, K) vertex ids (-1 pad), every row of the system in one
    chain (:func:`chains_from_links` over all P vertices: a vertex without
    links is a chain of one); Dd: (P, d, d) diagonal blocks; Eo: (P, d, d)
    super-diagonal blocks (Eo[i] couples i and i + 1; read only inside
    chains); rhs: (P, d, W).  Returns (P, d, W).  The JAX function also
    takes chains that leave rows out and solves those block-diagonally;
    here every chain matrix comes from :func:`chains_from_links`, so that
    solve, whose rows would all be discarded, is not made."""
    P, d, W = rhs.shape
    if P == 0:
        return rhs.clone()
    chain = chain.to(device=rhs.device, dtype=torch.long)
    NC, K = chain.shape
    idx = chain.clamp(0, P - 1)
    ok = chain >= 0                                        # (NC, K)
    eye = _eye(d, Dd)
    reg = 1e-10 * eye
    Dc = torch.where(ok[..., None, None], Dd[idx], eye)    # (NC, K, d, d)
    rc = torch.where(ok[..., None, None], rhs[idx], 0.0)   # (NC, K, d, W)
    # E between positions i and i + 1 exists where both are real
    link = ok[:, :-1] & ok[:, 1:]
    Ec = torch.where(link[..., None, None], Eo[idx[:, :-1]], 0.0)

    # forward elimination: Dh_0 = D_0, z_0 = r_0;
    #   Dh_i = D_i - E_{i-1}^T Dh_{i-1}^-1 E_{i-1}
    #   z_i  = r_i - E_{i-1}^T Dh_{i-1}^-1 z_{i-1}
    Dh_inv = [torch.linalg.inv_ex(Dc[:, 0] + reg)[0]]
    zs = [rc[:, 0]]
    for i in range(1, K):
        E_prev = Ec[:, i - 1]
        M = E_prev.transpose(1, 2) @ Dh_inv[-1]            # E^T Dh^-1
        Dh = Dc[:, i] - M @ E_prev
        zs.append(rc[:, i] - M @ zs[-1])
        Dh_inv.append(torch.linalg.inv_ex(Dh + reg)[0])

    # back substitution: y_K = Dh_K^-1 z_K; y_i = Dh_i^-1 (z_i - E_i y_{i+1})
    ys = [None] * K
    ys[K - 1] = Dh_inv[K - 1] @ zs[K - 1]
    for i in range(K - 2, -1, -1):
        ys[i] = Dh_inv[i] @ (zs[i] - Ec[:, i] @ ys[i + 1])
    y = torch.stack(ys, 1) * ok[..., None, None].to(rhs.dtype)

    out = torch.zeros_like(rhs)
    scatter_add(out, idx.reshape(-1), y.reshape(-1, d, W))
    return out


# ---------------------------------------------------------------------------
# dense assembly
# ---------------------------------------------------------------------------

_LMK = {"xs": 3, "ls": 4, "xd": 3, "ld": 4}
_CM = ("cam", "mot")


def _scatter_A(A, rows_base, cols_base, blocks):
    """A[rows_base + (0..r), cols_base + (0..c)] += blocks for a batch of
    edges; blocks (E, r, c), bases (E,)."""
    E, r, c = blocks.shape
    n = A.shape[1]
    ar = torch.arange(r, device=A.device)
    ac = torch.arange(c, device=A.device)
    flat = ((rows_base[:, None, None] + ar[None, :, None]) * n
            + cols_base[:, None, None] + ac[None, None, :])
    scatter_add(A.view(-1), flat.reshape(-1), blocks.reshape(-1))


def _scatter_Bt(Bt, vidx, cols_base, blocks):
    """Bt[vidx, :, cols_base + (0..c)] += blocks; Bt (P, d, NDOF), blocks
    (E, d, c)."""
    E, d, c = blocks.shape
    n = Bt.shape[2]
    ad = torch.arange(d, device=Bt.device)
    ac = torch.arange(c, device=Bt.device)
    flat = ((vidx[:, None, None] * d + ad[None, :, None]) * n
            + cols_base[:, None, None] + ac[None, None, :])
    scatter_add(Bt.view(-1), flat.reshape(-1), blocks.reshape(-1))


def _solve_reduced(S, rhs):
    """The damped reduced system ``S d = rhs``, symmetrised and regularised
    by ``1e-8 * I``.  Cholesky first; with a large-information prior (1e5 /
    1e7) float32 cancellation in the elimination can leave S slightly
    indefinite, and then the general LU solve is taken: where
    ``cholesky_ex`` reports a failure (``info != 0``; its partial factor
    can be finite) or its solution is not finite.  Both solves run and the
    choice is made on the device.

    Both are written with routines that a CUDA graph can hold inside a
    WHILE body (the captured LM loop, ``batch_ba.BAProgram``): the
    factorisations and triangular solves, not cuSOLVER's ``potrs`` /
    ``getrs``, and the LU in float64, because cuSOLVER's float32 ``getrf``
    above 512 unknowns and both ``*trs`` allocate memory inside a capture
    (graph memory nodes, which no conditional body may hold).  The float64
    LU is also the more exact of the two fallbacks."""
    S_d = 0.5 * (S + S.T) + 1e-8 * _eye(S.shape[0], S)
    L, info = torch.linalg.cholesky_ex(S_d)
    y = torch.linalg.solve_triangular(L, rhs[:, None], upper=False)
    d_chol = torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]
    LU, piv, _ = torch.linalg.lu_factor_ex(S_d.double())
    P, Lu, U = torch.lu_unpack(LU, piv)
    y = torch.linalg.solve_triangular(Lu, P.mT @ rhs.double()[:, None],
                                      upper=False, unitriangular=True)
    d_lu = torch.linalg.solve_triangular(U, y, upper=True)[:, 0]
    chol_ok = (info == 0) & torch.isfinite(d_chol).all()
    return torch.where(chol_ok, d_chol, d_lu.to(S.dtype))


def dense_schur_step(graph: bb.BAGraph, state: bb.BAState, w: bb.BAWeights,
                     lam, meta: SchurMeta):
    """One damped Gauss-Newton step solved exactly: assemble the reduced
    (camera + motion) system by Schur elimination of every landmark family
    and solve it by dense Cholesky.  Returns (delta dict, cost, gain_den),
    the contract of ``batch_ba.ba_gn_step`` without the CG count."""
    F, M = meta.n_frames, meta.n_motions
    NDOF = 6 * (F + M)
    dt, dev = state.cam_T.dtype, state.cam_T.device
    lam = torch.as_tensor(lam, dtype=dt, device=dev)
    lin, (r_p, J_p), cost = bb._linearize(graph, state, w)

    A = torch.zeros((NDOF, NDOF), dtype=dt, device=dev)
    b = torch.zeros(NDOF, dtype=dt, device=dev)
    P_sz = {"xs": state.Xs.shape[0], "ls": state.Ls_U.shape[0],
            "xd": state.Xd.shape[0], "ld": state.Ld_U.shape[0]}
    Bt = {f: torch.zeros((P_sz[f], d, NDOF), dtype=dt, device=dev)
          for f, d in _LMK.items()}
    Dd = {f: (lam * _eye(d, A)).expand(P_sz[f], d, d).clone()
          for f, d in _LMK.items()}
    bL = {f: torch.zeros((P_sz[f], d), dtype=dt, device=dev)
          for f, d in _LMK.items()}
    Eo = {f: torch.zeros((P_sz[f], d, d), dtype=dt, device=dev)
          for f, d in (("xd", 3), ("ld", 4))}

    def cm_base(fam, idx):
        return 6 * idx if fam == "cam" else 6 * F + 6 * idx

    for o in lin:
        verts, jacs, wgt, r = o["verts"], o["jacs"], o["wgt"], o["r"]
        for si, ((fam_i, idx_i), J_i) in enumerate(zip(verts, jacs)):
            JiW = J_i * wgt[:, None, None]
            g_i = torch.einsum("eri,er->ei", JiW, r)
            if fam_i in _CM:
                k = g_i.shape[1]
                pos = (cm_base(fam_i, idx_i)[:, None]
                       + torch.arange(k, device=dev)[None, :])
                scatter_add(b, pos.reshape(-1), -g_i.reshape(-1))
            else:
                scatter_add(bL[fam_i], idx_i, -g_i)
            for sj, ((fam_j, idx_j), J_j) in enumerate(zip(verts, jacs)):
                blk = JiW.transpose(1, 2) @ J_j
                if fam_i in _CM and fam_j in _CM:
                    _scatter_A(A, cm_base(fam_i, idx_i),
                               cm_base(fam_j, idx_j), blk)
                elif fam_j in _CM:
                    _scatter_Bt(Bt[fam_i], idx_i, cm_base(fam_j, idx_j), blk)
                elif fam_i not in _CM:
                    if si == sj:
                        scatter_add(Dd[fam_i], idx_i, blk)
                    elif si < sj:
                        # ternary off-diagonal (prev, cur): stored at prev,
                        # where cur == prev + 1 (build_graph's consecutive
                        # vertex ids)
                        okc = idx_j == idx_i + 1
                        scatter_add(Eo[fam_i], idx_i,
                                    torch.where(okc[:, None, None], blk, 0.0))
                # (camera or motion, landmark) pairs are the transposes of
                # the (landmark, camera or motion) visits above

    # the prior on the anchored camera (its cost is in _linearize's)
    pf, pinfo = graph.prior_frame, graph.prior_info
    Jp, rp = J_p[0], r_p[0]
    s = 6 * pf
    A[s:s + 6, s:s + 6] += (pinfo * Jp).T @ Jp
    b[s:s + 6] -= (pinfo * Jp).T @ rp

    A = A + lam * _eye(NDOF, A)

    # Schur: S = A - sum_f Bt_f^T D_f^-1 Bt_f; rhs = b - Bt^T D^-1 bL
    S, rhs, Ysol = A, b, {}
    for f, d in _LMK.items():
        aug = torch.cat([Bt[f], bL[f][:, :, None]], dim=2)
        if f in ("xd", "ld"):
            chain = meta.xd_chain if f == "xd" else meta.ld_chain
            sol = _tridiag_solve(chain, Dd[f], Eo[f], aug)
        else:
            sol = torch.linalg.solve_ex(Dd[f] + 1e-10 * _eye(d, A), aug)[0]
        Ysol[f] = sol
        Bt2 = Bt[f].reshape(-1, NDOF)
        sol2 = sol.reshape(-1, NDOF + 1)
        S = S - Bt2.T @ sol2[:, :NDOF]
        rhs = rhs - Bt2.T @ sol2[:, NDOF]

    d_cm = _solve_reduced(S, rhs)

    # landmark back-substitution: d_L = D^-1 (bL - Bt d_cm)
    delta = {"cam": d_cm[:6 * F].reshape(F, 6),
             "mot": d_cm[6 * F:].reshape(M, 6)}
    for f in _LMK:
        delta[f] = Ysol[f][:, :, NDOF] - Ysol[f][:, :, :NDOF] @ d_cm

    g_full = {"cam": -b[:6 * F].reshape(F, 6), "mot": -b[6 * F:].reshape(M, 6)}
    g_full.update({f: -bL[f] for f in _LMK})
    gain_den = sum(torch.sum(delta[k] * (lam * delta[k] - g_full[k]))
                   for k in delta)
    return delta, cost, gain_den


def _meta(graph: bb.BAGraph, xd_chain, ld_chain) -> SchurMeta:
    """The chain tables checked (every vertex of each dynamic family in
    one row once: a padded graph's padded vertices in chains of their
    own, padded rows all -1) and on the graph's device."""
    dev = graph.cam_T0.device
    chains = []
    for ch, n in ((xd_chain, graph.Xd0.shape[0]), (ld_chain,
                                                   graph.Ld_U0.shape[0])):
        ch = np.asarray(ch, np.int64)
        if not np.array_equal(np.sort(ch[ch >= 0]), np.arange(n)):
            raise ValueError("the chains must hold each of the family's %d "
                             "vertices once" % n)
        chains.append(torch.as_tensor(ch, device=dev))
    return SchurMeta(xd_chain=chains[0], ld_chain=chains[1],
                     n_frames=int(graph.cam_T0.shape[0]),
                     n_motions=int(graph.mot_T0.shape[0]))


def _schur_step(graph: bb.BAGraph, w: bb.BAWeights, meta: SchurMeta):
    """The Schur step as ``batch_ba.LMLoop`` takes it."""
    def step(state, lam):
        x, _, gain_den = dense_schur_step(graph, state, w, lam, meta)
        return x, gain_den, None
    return step


def run_ba_schur(graph: bb.BAGraph, w: bb.BAWeights, xd_chain, ld_chain,
                 max_iters: int = 20, gain_threshold: float = 1e-4):
    """The LM loop of JAX's ``run_ba_fused_schur`` with the exact step, run
    eagerly: the plain version of :func:`run_ba_fused_schur`, the same
    ``batch_ba.lm_iteration`` driven from the host, one read a LM
    iteration.  ``xd_chain`` / ``ld_chain``: :func:`chains_from_links` of
    the dynamic point and line families.

    Returns (final BAState, final cost (device scalar), iterations run)."""
    meta = _meta(graph, xd_chain, ld_chain)
    s = bb.LMLoop(graph, w, _schur_step(graph, w, meta), max_iters,
                  gain_threshold)
    it = bb.lm_run(s, run_ba_schur)
    return s.state, s.cost, it


run_ba_schur.host_syncs = 0      # host reads: one per LM iteration
run_ba_schur.iterations = 0      # LM iterations


def run_ba_fused_schur(graph: bb.BAGraph, w: bb.BAWeights, xd_chain,
                       ld_chain, F: int, M: int, max_iters: int = 20,
                       gain_threshold: float = 1e-4):
    """The LM loop with the dense-Schur step as one program (JAX's
    ``run_ba_fused_schur``): on the card one launch of a captured graph
    whose LM loop ends on the device in a WHILE node (the block-Thomas
    loop over chain positions is static in F, so it captures as straight
    code).  ``F`` / ``M``: the graph's frame and (padded) motion counts.
    Counts one host read and the LM iterations on ``run_ba_schur``.

    Returns (final BAState, final cost (float), LM iterations run)."""
    if (F, M) != (graph.cam_T0.shape[0], graph.mot_T0.shape[0]):
        raise ValueError("F, M = %d, %d do not match the graph's %s, %s" % (
            F, M, graph.cam_T0.shape[0], graph.mot_T0.shape[0]))
    meta = _meta(graph, xd_chain, ld_chain)

    def make_step(g, extras, cg_iters):
        return _schur_step(g, w, meta._replace(xd_chain=extras[0],
                                               ld_chain=extras[1]))

    return bb.fused_call("schur", graph, w, make_step,
                         (meta.xd_chain, meta.ld_chain), max_iters, 0,
                         gain_threshold, run_ba_schur)
