"""Large-scale bundle adjustment: matrix-free Schur solve with PCG.

The dense solver (ops/schur_ba.py) materializes the (C, L, 6, 4) cam-line
coupling W and the (6C x 6C) reduced camera system — exact and fast at
window scale, but a memory wall at C*L ~ 1e6 (engine/refine.py's global
solve) and far past anything the reference's sparse normal Cholesky
(/root/reference/src/lba_problem.cpp:96-131) could not handle.  This module
is the scalable path, playing the role of Ceres's ITERATIVE_SCHUR +
SCHUR_JACOBI preconditioner, laid out for dense device reductions:

* observations live in a **line-major bucketed layout**: (L, kL) padded
  rows, one bucket per landmark line.  Per-line reductions (Hll, gl, the
  W^T x product in the Schur matvec) become dense sums over the bucket
  axis — no scatter, no one-hot, no sorting on device.
* a **camera-bucket permutation** (C, kC) -> flat observation index gives
  the same dense-gather story for per-camera reductions (Hcc, gc, W y).
* the reduced camera system S = Hcc_d - W Binv W^T is never materialized:
  PCG on S runs with two gathers + two bucketed einsum reductions per
  matvec, O(O * 24) FLOPs, all dense.
* preconditioner: SCHUR_JACOBI — the exact 6x6 diagonal blocks of S
  (cheap here because a (cam, line) pair has at most one observation, so
  the per-camera coupling sum needs only the camera's own bucket).
* the LM trust-region loop is identical to ops/schur_ba.py (Ceres
  constants); the inner CG tolerance is Ceres's eta = 1e-2 forcing
  sequence (src/lba_problem.cpp:124-131 sets eta 1e-2).

Memory: O(O * 24 + C * 36 + L * 16) — linear in observations, no C*L term.
A 2000-camera / 16k-line / 200k-obs global solve fits in ~50 MB of HBM.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .residuals import lba_residual_batch, lba_residual_jac_batch
from .schur_ba import (BAStats, _INIT_RADIUS, _MIN_DIAG, _MAX_DIAG,
                       _MIN_RELATIVE_DECREASE, _inv4_equilibrated,
                       _robust_weights, _tolerances)


# ---------------------------------------------------------------------------
# Host-side layout builder
# ---------------------------------------------------------------------------

class LineMajorProblem(NamedTuple):
    """Bucketed BA problem (host numpy; pass to global_ba_cg as jnp)."""

    obs: np.ndarray        # (L, kL, 8)
    obs_cam: np.ndarray    # (L, kL) int32 camera index per observation
    obs_valid: np.ndarray  # (L, kL) bool
    cam_perm: np.ndarray   # (C, kC) int32 flat index into L*kL
    cam_perm_valid: np.ndarray  # (C, kC) bool
    kL: int
    kC: int
    fill: float            # valid / padded observation ratio


def pack_line_major(obs, obs_cam, obs_line, num_cams, num_lines,
                    round_to: int = 8, k_l=None, k_c=None) -> LineMajorProblem:
    """Bucket flat observations by line + build the camera permutation.

    obs (O, 8), obs_cam (O,), obs_line (O,) — valid observations only.
    Bucket sizes are padded to multiples of ``round_to`` for friendly
    tiling.  ``k_l`` / ``k_c`` force the bucket sizes (must be >= the
    natural ones) so several problems packed for one vmapped solve share
    a layout (engine/refine.py global_refine_many).
    """
    obs = np.asarray(obs, np.float64).reshape(-1, 8)
    obs_cam = np.asarray(obs_cam, np.int64)
    obs_line = np.asarray(obs_line, np.int64)
    O = len(obs)
    C, L = int(num_cams), int(num_lines)

    cnt_l = np.bincount(obs_line, minlength=L)
    cnt_c = np.bincount(obs_cam, minlength=C)
    rnd = lambda n: max(round_to, int(-(-n // round_to) * round_to))
    kL = int(k_l) if k_l else rnd(int(cnt_l.max()) if O else 1)
    kC = int(k_c) if k_c else rnd(int(cnt_c.max()) if O else 1)
    if O:
        assert kL >= cnt_l.max() and kC >= cnt_c.max(), (kL, kC)

    ob = np.zeros((L, kL, 8))
    oc = np.zeros((L, kL), np.int32)
    ov = np.zeros((L, kL), bool)
    # slot within bucket = rank among observations of the same line
    # (vectorized: stable sort by line, then index minus group start)
    order = np.argsort(obs_line, kind="stable")
    ls = obs_line[order]
    start_l = np.searchsorted(ls, np.arange(L))
    slot = np.arange(O) - start_l[ls] if O else np.zeros(0, np.int64)
    ob[ls, slot] = obs[order]
    oc[ls, slot] = obs_cam[order]
    ov[ls, slot] = True
    flat_of = np.empty(O, np.int64)
    flat_of[order] = ls * kL + slot

    cp = np.zeros((C, kC), np.int32)
    cpv = np.zeros((C, kC), bool)
    order_c = np.argsort(obs_cam, kind="stable")
    cs = obs_cam[order_c]
    start_c = np.searchsorted(cs, np.arange(C))
    slot_c = np.arange(O) - start_c[cs] if O else np.zeros(0, np.int64)
    cp[cs, slot_c] = flat_of[order_c]
    cpv[cs, slot_c] = True

    fill = O / max(L * kL, 1)
    return LineMajorProblem(ob, oc, ov, cp, cpv, kL, kC, fill)


# ---------------------------------------------------------------------------
# System evaluation (residuals + blocks, no dense W)
# ---------------------------------------------------------------------------

def _eval_system_lm(cam_wt, line_orth, obs, obs_cam, w_valid, cam_perm,
                    cam_perm_valid, cam_free_f, line_free_f, baseline,
                    huber_delta, robust, line_param):
    """Blocks for the bucketed layout.

    Returns cost, Hcc (C,6,6), Hll (L,4,4), gc (C,6), gl (L,4),
    Wb (L,kL,6,4).  Padded observations contribute exact zeros
    (select-zeroed residuals/Jacobians), so gathers need no re-masking.
    """
    L, kL = obs.shape[:2]
    C = cam_wt.shape[0]

    cw = cam_wt[obs_cam.reshape(-1)]                       # (L*kL, 6)
    lo = jnp.repeat(line_orth, kL, axis=0)                 # (L*kL, 4)
    r, Jc, Jl = lba_residual_jac_batch(cw, lo, obs.reshape(-1, 8),
                                       baseline, line_param=line_param)

    w_r, cost_i = _robust_weights(r, huber_delta, robust)
    wv = w_valid.reshape(-1)
    cost = jnp.sum(jnp.where(wv > 0, cost_i, 0.0))

    valid = wv[:, None] > 0
    scale = w_r[:, None]
    r = jnp.where(valid, r * scale, 0.0)
    cf = cam_free_f[obs_cam.reshape(-1)]
    lf = jnp.repeat(line_free_f, kL, axis=0)
    Jc = jnp.where(valid[..., None], Jc * scale[..., None]
                   * cf[:, None, None], 0.0)
    Jl = jnp.where(valid[..., None], Jl * scale[..., None]
                   * lf[:, None, None], 0.0)

    A = jnp.einsum("oki,okj->oij", Jc, Jc)                 # (L*kL,6,6)
    B = jnp.einsum("oki,okj->oij", Jl, Jl)                 # (L*kL,4,4)
    Wb = jnp.einsum("oki,okj->oij", Jc, Jl)                # (L*kL,6,4)
    gc_o = jnp.einsum("oki,ok->oi", Jc, r)                 # (L*kL,6)
    gl_o = jnp.einsum("oki,ok->oi", Jl, r)                 # (L*kL,4)

    # per-line blocks: dense sum over the bucket axis
    Hll = jnp.sum(B.reshape(L, kL, 4, 4), axis=1)
    gl = jnp.sum(gl_o.reshape(L, kL, 4), axis=1)

    # per-camera blocks: gather by the camera permutation, dense sum
    pv = cam_perm_valid[..., None]
    gcg = jnp.where(pv, gc_o[cam_perm], 0.0)               # (C,kC,6)
    Ag = jnp.where(pv[..., None], A[cam_perm], 0.0)        # (C,kC,6,6)
    Hcc = jnp.sum(Ag, axis=1)
    gc = jnp.sum(gcg, axis=1)

    return cost, Hcc, Hll, gc, gl, Wb.reshape(L, kL, 6, 4)


# ---------------------------------------------------------------------------
# Matrix-free Schur solve (PCG with SCHUR_JACOBI preconditioner)
# ---------------------------------------------------------------------------

def _solve_step_cg(Hcc, Hll, gc, gl, Wb, Hoff, edge_i, edge_j, obs_cam,
                   cam_perm, cam_perm_valid, lam, cam_free_f, line_free_f,
                   cg_iters, eta):
    C = Hcc.shape[0]
    L, kL = Wb.shape[:2]
    dtype = Hcc.dtype

    diag_c = jnp.clip(jnp.diagonal(Hcc, axis1=-2, axis2=-1),
                      _MIN_DIAG, _MAX_DIAG)
    diag_l = jnp.clip(jnp.diagonal(Hll, axis1=-2, axis2=-1),
                      _MIN_DIAG, _MAX_DIAG)

    eye4 = jnp.eye(4, dtype=dtype)
    Binv = _inv4_equilibrated(Hll + lam * diag_l[..., None] * eye4)
    Hcc_d = Hcc + lam * diag_c[..., None] * jnp.eye(6, dtype=dtype)

    m = cam_free_f[:, None]                                # (C,1)
    pv = cam_perm_valid[..., None]                         # (C,kC,1)

    def cam_sum(flat6):
        """(L*kL, 6) -> (C, 6) via the camera buckets."""
        return jnp.sum(jnp.where(pv, flat6[cam_perm], 0.0), axis=1)

    have_prior = Hoff.shape[0] > 0

    def matvec(x):
        """S x with S = Hcc_d - W Binv W^T (+ the pose-prior edges'
        off-diagonal coupling — consecutive-chain AND loop edges, scatter
        -indexed by (edge_i, edge_j)), fixed cameras -> identity."""
        xm = x * m
        y = jnp.einsum("lkab,lka->lkb", Wb, xm[obs_cam])   # (L,kL,4)
        z = jnp.sum(y, axis=1)                             # (L,4)
        w = jnp.einsum("lab,lb->la", Binv, z)              # (L,4)
        u = jnp.einsum("lkab,lb->lka", Wb, w)              # (L,kL,6)
        v = cam_sum(u.reshape(L * kL, 6))                  # (C,6)
        Sx = jnp.einsum("cab,cb->ca", Hcc_d, xm) - v
        if have_prior:
            Sx = Sx.at[edge_i].add(
                jnp.einsum("eab,eb->ea", Hoff, xm[edge_j]))
            Sx = Sx.at[edge_j].add(
                jnp.einsum("eba,eb->ea", Hoff, xm[edge_i]))
        return Sx * m + x * (1.0 - m)

    # rhs = -gc + W Binv gl
    w0 = jnp.einsum("lab,lb->la", Binv, gl)                # (L,4)
    u0 = jnp.einsum("lkab,lb->lka", Wb, w0)                # (L,kL,6)
    rhs = (-gc + cam_sum(u0.reshape(L * kL, 6))) * m

    # SCHUR_JACOBI: exact 6x6 diagonal blocks of S (one obs per (cam,line)
    # pair, so only the camera's own bucket contributes)
    T = jnp.einsum("lkab,lbc,lkdc->lkad", Wb, Binv, Wb)    # (L,kL,6,6)
    Tg = jnp.where(pv[..., None], T.reshape(L * kL, 6, 6)[cam_perm], 0.0)
    P = Hcc_d - jnp.sum(Tg, axis=1)                        # (C,6,6)
    eye6 = jnp.eye(6, dtype=dtype)
    P = jnp.where(m[..., None] > 0, P, eye6)
    Minv = _inv4_equilibrated(P)                           # size-agnostic

    def precond(r):
        return jnp.einsum("cab,cb->ca", Minv, r)

    # PCG (Ceres eta forcing: stop at ||r|| <= eta * ||rhs||)
    rhs_norm2 = jnp.sum(rhs * rhs)
    tol2 = (eta * eta) * rhs_norm2

    class _CG(NamedTuple):
        x: jnp.ndarray
        r: jnp.ndarray
        p: jnp.ndarray
        rz: jnp.ndarray
        it: jnp.ndarray

    x0 = jnp.zeros_like(rhs)
    r0 = rhs
    z0 = precond(r0)
    cg0 = _CG(x0, r0, z0, jnp.sum(r0 * z0), jnp.asarray(0, jnp.int32))

    def cg_cond(s):
        return jnp.logical_and(s.it < cg_iters,
                               jnp.sum(s.r * s.r) > tol2)

    def cg_body(s):
        Ap = matvec(s.p)
        pAp = jnp.sum(s.p * Ap)
        alpha = s.rz / jnp.where(pAp > 0, pAp, 1.0)
        alpha = jnp.where(pAp > 0, alpha, 0.0)
        x = s.x + alpha * s.p
        r = s.r - alpha * Ap
        z = precond(r)
        rz = jnp.sum(r * z)
        beta = rz / jnp.where(s.rz != 0, s.rz, 1.0)
        p = z + beta * s.p
        return _CG(x, r, p, rz, s.it + 1)

    cg = jax.lax.while_loop(cg_cond, cg_body, cg0)
    dc = cg.x * m

    # back-substitute line updates
    y = jnp.einsum("lkab,lka->lkb", Wb, dc[obs_cam])
    coup = jnp.sum(y, axis=1)                              # (L,4)
    dl = -jnp.einsum("lab,lb->la", Binv, gl + coup)
    dl = dl * line_free_f[:, None]

    damp_quad = lam * (jnp.sum(diag_c * dc * dc) + jnp.sum(diag_l * dl * dl))
    g_dot_d = jnp.sum(gc * dc) + jnp.sum(gl * dl)
    return dc, dl, damp_quad, g_dot_d, cg.it


def global_ba_cg_impl(cam_wt, line_orth, obs, obs_cam, obs_valid, cam_perm,
                      cam_perm_valid, cam_free, line_free, baseline,
                      huber_delta, robust=True, max_iters=25, cg_iters=100,
                      eta=1e-2, line_param="orth", prior_c=None,
                      prior_sigma_rot=0.02, prior_sigma_t=0.1,
                      prior_edges=None):
    """LM bundle adjustment on the bucketed layout with matrix-free Schur.

    Args mirror ops.schur_ba.local_ba_impl with the bucketed observation
    layout from pack_line_major:
      obs (L, kL, 8), obs_cam (L, kL), obs_valid (L, kL),
      cam_perm (C, kC), cam_perm_valid (C, kC).

    prior_c: optional (C-1, 6) odometry-chain constraints C_i (pose of
    camera i+1 relative to camera i) fused as weighted pose-graph
    residuals on consecutive cameras.  A global BA frees every pose
    against line observations alone; trajectories with band-local
    visibility (a survey ring, an outward-looking orbit) have weakly
    observable low-frequency bending modes where the ML estimate wanders
    (measured: the village-400 refine WORSENS ATE as cost decreases).
    The odometry chain carries exactly that missing information — the
    reference's sliding window preserves it implicitly by freezing old
    edges (slam.cpp:1374-1416); fusing it as a weak prior (sigma per
    edge: prior_sigma_rot rad / prior_sigma_t m) pins the null modes
    without fighting the observations in well-constrained ones.

    prior_edges: optional (ei (E,), ej (E,), c (E, 6)) GENERAL pose
    constraints — loop-closure edges in the deferred pipeline — fused
    with the same sigmas; the 4-tuple form (ei, ej, c, sig (E, 2))
    carries per-edge (sigma_rot, sigma_t) instead.  With both priors the refine is the full MAP
    over observations + odometry measurements + loop constraints, so a
    noisy loop edge is one weak term among thousands instead of the
    pose-graph-only solve's dominant one.

    Returns (cam', line', BAStats).
    """
    dtype = cam_wt.dtype
    ftol, ptol = _tolerances(dtype)
    cam_free_f = cam_free.astype(dtype)
    line_free_f = line_free.astype(dtype)
    w_valid = obs_valid.astype(dtype)

    # unify chain + general edges into one (ei, ej, c, scale) block
    C = cam_wt.shape[0]
    # sigmas are traced (NOT static jit args): a sigma sweep
    # (tools/param_study.py) must not retrace the kernel per value
    sr = jnp.asarray(prior_sigma_rot, dtype)
    st = jnp.asarray(prior_sigma_t, dtype)
    eis, ejs, ecs, esc = [], [], [], []
    if prior_c is not None:
        n = C - 1
        eis.append(jnp.arange(C - 1, dtype=jnp.int32))
        ejs.append(jnp.arange(1, C, dtype=jnp.int32))
        ecs.append(jnp.asarray(prior_c, dtype))
        esc.append(jnp.concatenate([
            jnp.full((n, 3), 1.0, dtype) / sr,
            jnp.full((n, 3), 1.0, dtype) / st], axis=1))
    if prior_edges is not None:
        # (ei, ej, c) uses the scalar sigmas; (ei, ej, c, sig) carries
        # per-edge (sigma_rot, sigma_t) pairs (E, 2) — the deferred LC
        # joint span re-solve mixes strong in-group odometry edges with
        # a weak cross-group anchor in one solve
        if len(prior_edges) == 4:
            ei_x, ej_x, c_x, sig_x = prior_edges
            sig_x = jnp.asarray(sig_x, dtype)
            esc.append(jnp.concatenate([
                1.0 / jnp.repeat(sig_x[:, 0:1], 3, axis=1),
                1.0 / jnp.repeat(sig_x[:, 1:2], 3, axis=1)], axis=1))
        else:
            ei_x, ej_x, c_x = prior_edges
            n = len(ei_x)
            esc.append(jnp.concatenate([
                jnp.full((n, 3), 1.0, dtype) / sr,
                jnp.full((n, 3), 1.0, dtype) / st], axis=1))
        eis.append(jnp.asarray(ei_x, jnp.int32))
        ejs.append(jnp.asarray(ej_x, jnp.int32))
        ecs.append(jnp.asarray(c_x, dtype))
    have_prior = bool(eis)
    if have_prior:
        edge_i = jnp.concatenate(eis)
        edge_j = jnp.concatenate(ejs)
        edge_c = jnp.concatenate(ecs)
        pscale = jnp.concatenate(esc)          # (E, 6)
        from .pose_graph import _edge_rj_batch
    else:
        edge_i = jnp.zeros((0,), jnp.int32)
        edge_j = jnp.zeros((0,), jnp.int32)

    def evaluate(cw, lo):
        cost, Hcc, Hll, gc, gl, Wb = _eval_system_lm(
            cw, lo, obs, obs_cam, w_valid, cam_perm, cam_perm_valid,
            cam_free_f, line_free_f, baseline, huber_delta, robust,
            line_param)
        if not have_prior:
            Hoff = jnp.zeros((0, 6, 6), dtype)
            return cost, Hcc, Hll, gc, gl, Wb, Hoff, None, None
        r, J1, J2 = _edge_rj_batch(cw[edge_i], cw[edge_j], edge_c)
        r = r * pscale
        J1 = J1 * pscale[:, :, None] * cam_free_f[edge_i, None, None]
        J2 = J2 * pscale[:, :, None] * cam_free_f[edge_j, None, None]
        cost = cost + 0.5 * jnp.sum(r * r)
        gc = gc.at[edge_i].add(jnp.einsum("eki,ek->ei", J1, r))
        gc = gc.at[edge_j].add(jnp.einsum("eki,ek->ei", J2, r))
        Hcc = Hcc.at[edge_i].add(jnp.einsum("eki,ekj->eij", J1, J1))
        Hcc = Hcc.at[edge_j].add(jnp.einsum("eki,ekj->eij", J2, J2))
        Hoff = jnp.einsum("eki,ekj->eij", J1, J2)     # couples (ei, ej)
        return cost, Hcc, Hll, gc, gl, Wb, Hoff, J1, J2

    # Trial points are scored with a residual-only cost; the full system
    # (Jacobians + blocks) is evaluated once per iteration at the current
    # accepted point, INSIDE the loop body only — one instance of the
    # dominant evaluate-HLO instead of two, and no (L,kL,6,4) Wb in the
    # while-loop carry (same restructure as ops/schur_ba.py; compile wall
    # and HBM both shrink, the accepted-step sequence is unchanged).
    def cost_only(cw, lo):
        L, kL = obs.shape[:2]
        r = lba_residual_batch(cw[obs_cam.reshape(-1)],
                               jnp.repeat(lo, kL, axis=0),
                               obs.reshape(-1, 8), baseline,
                               line_param=line_param)
        _, cost_i = _robust_weights(r, huber_delta, robust)
        cost = jnp.sum(jnp.where(w_valid.reshape(-1) > 0, cost_i, 0.0))
        if have_prior:
            from .pose_graph import edge_residual
            re = jax.vmap(edge_residual)(cw[edge_i], cw[edge_j], edge_c)
            cost = cost + 0.5 * jnp.sum((re * pscale) ** 2)
        return cost

    cost0 = cost_only(cam_wt, line_orth)

    class _S(NamedTuple):
        cam: jnp.ndarray
        line: jnp.ndarray
        cost: jnp.ndarray
        radius: jnp.ndarray
        decrease_factor: jnp.ndarray
        it: jnp.ndarray
        done: jnp.ndarray

    state = _S(cam_wt, line_orth, cost0,
               jnp.asarray(_INIT_RADIUS, dtype), jnp.asarray(2.0, dtype),
               jnp.asarray(0, jnp.int32), jnp.asarray(False))

    def cond(s):
        # isfinite guard: garbage lanes exit immediately instead of
        # holding every lane of a vmapped solve at the iteration cap
        # (see ops/schur_ba.py local_ba_impl cond)
        return jnp.logical_and(
            jnp.logical_and(s.it < max_iters, jnp.logical_not(s.done)),
            jnp.isfinite(s.cost))

    def body(s):
        lam = 1.0 / s.radius
        _, Hcc, Hll, gc, gl, Wb, Hoff, _, _ = evaluate(s.cam, s.line)
        dc, dl, damp_quad, g_dot_d, _ = _solve_step_cg(
            Hcc, Hll, gc, gl, Wb, Hoff, edge_i, edge_j,
            obs_cam, cam_perm, cam_perm_valid, lam, cam_free_f,
            line_free_f, cg_iters, eta)

        cam_new = s.cam + dc
        line_new = s.line + dl
        cost_new = cost_only(cam_new, line_new)

        model_change = 0.5 * (damp_quad - g_dot_d)
        rho = (s.cost - cost_new) / jnp.maximum(model_change, 1e-300)
        accept = jnp.logical_and(model_change > 0,
                                 rho > _MIN_RELATIVE_DECREASE)
        accept = jnp.logical_and(accept, jnp.isfinite(cost_new))

        tmp = 2.0 * rho - 1.0
        radius = jnp.where(
            accept,
            jnp.minimum(s.radius / jnp.maximum(1.0 / 3.0, 1.0 - tmp ** 3),
                        1e16),
            jnp.maximum(s.radius / s.decrease_factor, 1e-32))
        dec = jnp.where(accept, 2.0, s.decrease_factor * 2.0)

        fconv = jnp.abs(s.cost - cost_new) <= ftol * s.cost
        xnorm = jnp.sqrt(jnp.sum(s.cam * s.cam) + jnp.sum(s.line * s.line))
        snorm = jnp.sqrt(jnp.sum(dc * dc) + jnp.sum(dl * dl))
        pconv = snorm <= ptol * (xnorm + ptol)
        converged = jnp.logical_and(accept, jnp.logical_or(fconv, pconv))
        # all-zero/non-finite step: no progress is possible (see
        # ops/schur_ba.py local_ba_impl `dead`)
        converged = jnp.logical_or(converged, jnp.logical_not(snorm > 0))

        return _S(jnp.where(accept, cam_new, s.cam),
                  jnp.where(accept, line_new, s.line),
                  jnp.where(accept, cost_new, s.cost),
                  radius, dec, s.it + 1, converged)

    out = jax.lax.while_loop(cond, body, state)
    return out.cam, out.line, BAStats(out.it, cost0, out.cost)


global_ba_cg = jax.jit(global_ba_cg_impl,
                       static_argnames=("robust", "max_iters", "cg_iters",
                                        "eta", "line_param"))
