"""Windowed local bundle adjustment: batched Schur-complement LM.

The device replacement for the reference's Ceres solve
(SLAM::bundle_adjustment packing at /root/reference/src/slam.cpp:795-975 and
ceres::LBAProblem at src/lba_problem.{h,cpp}).  One jitted fixed-shape kernel
runs the whole Levenberg–Marquardt loop:

  * residuals + exact Jacobians for every observation in one fused batch
    (the autodiff evaluation Ceres does per residual block,
    lba_problem.cpp:62-92);
  * Huber robustification with delta = 1/focal_length
    (lba_problem.cpp:78-80); Ceres's Corrector reduces to plain
    sqrt(rho') scaling for Huber (rho'' <= 0), which is what we apply;
  * normal-equation assembly as segment-sums and a dense cam-line coupling
    block (the assembly mode is chosen in default_assembly);
  * Schur complement eliminating the 4x4 line blocks (batched inverses),
    dense Cholesky on the reduced camera system — note the reference's
    SPARSE_SCHUR switch falls through to SPARSE_NORMAL_CHOLESKY
    (lba_problem.cpp:96-101) and its ordering is degenerate, so the
    reference never actually ran a Schur solver; we implement the real
    thing;
  * Ceres-compatible trust-region LM: damping (JtJ + D^2/radius) with
    D = clamp(sqrt(diag JtJ)), step acceptance rho > 1e-3, radius update
    r /= max(1/3, 1-(2*rho-1)^3) on success, r /= k, k *= 2 on failure,
    function_tolerance 1e-6, iteration cap from --max_num_iter.

Fixed parameter blocks (SetParameterBlockConstant, lba_problem.cpp:88-91)
are handled with masks: their Jacobian columns are zeroed and their rows in
the reduced system replaced by identity.

Shapes are static; callers pad to capacity buckets (config.bucket_for).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .residuals import (lba_residual_batch, lba_residual_jac_batch,
                        lba_residual_jac_cam_batch)

_MIN_DIAG = 1e-6
_MAX_DIAG = 1e32
_INIT_RADIUS = 1e4
_MIN_RELATIVE_DECREASE = 1e-3
_FUNCTION_TOL = 1e-6
_PARAM_TOL = 1e-8

# The solver choices that depend on the backend, each decided by a
# measurement on that backend (PERF.md, "Assembly and refine method").
# On the H100 scatter won standalone at the window and a refine shape and
# end to end in the house-400 replay; CG won the 100-keyframe refine.
_ASSEMBLY = {"cpu": "scatter", "gpu": "scatter"}
# Whether the exact dense-W solver runs small global refines (else the
# matrix-free CG Schur solver, ops/schur_cg.py, runs every size).
_REFINE_DENSE_WHEN_SMALL = {"cpu": True, "gpu": False}
_DENSE_W_LIMIT = 400_000   # C*L above this -> CG (dense W is (C, L, 6, 4))
_DENSE_CAM_LIMIT = 128     # cameras above this -> CG (the dense reduced
                           # system is (6C)^2 and its Cholesky is (6C)^3)


def _platform_entry(table, platform):
    if platform not in table:
        raise ValueError(f"no measured solver choice for platform "
                         f"{platform!r}; known: {sorted(table)}")
    return table[platform]


def default_assembly(platform: str) -> str:
    """Normal-equation assembly mode of _eval_system for a JAX platform.

    Modes: "scatter" (XLA scatter-add; atomics on the GPU), "onehot"
    (matmuls against one-hot index matrices) and "blocked" (per-camera
    reshape-sums plus one batched matmul per camera; needs the
    camera-major layout ``obs_cam == repeat(arange(C), O // C)``).
    """
    return _platform_entry(_ASSEMBLY, platform)


def default_refine_method(platform: str, num_cams: int, num_lines: int,
                          has_prior: bool) -> str:
    """Global-refine solver: "dense" (this module's exact Schur LM) or
    "cg" (ops/schur_cg.py).  Pose priors exist on the CG path only."""
    small = (num_cams * num_lines <= _DENSE_W_LIMIT
             and num_cams <= _DENSE_CAM_LIMIT)
    dense = _platform_entry(_REFINE_DENSE_WHEN_SMALL, platform)
    return "dense" if dense and small and not has_prior else "cg"


def _tolerances(dtype, ftol_floor=64.0):
    """Ceres tolerances, floored at the dtype's resolution.

    Ceres defaults: function_tolerance 1e-6, parameter_tolerance 1e-8 —
    both below f32 epsilon (1.2e-7), so in f32 they can never fire and
    every solve runs to the iteration cap (measured: steady-state 7.6
    avg iterations in f32 vs 3 in f64 on the house replay).  A relative
    cost change below ~64 eps is numerical noise in any dtype, so floor
    the tolerances there; in f64 the Ceres values are unchanged.

    A looser floor (256 eps) was measured r4 and REJECTED: it cut the
    average iterations 7.1 -> 6.0 at LM cap 50, but a weak-mode bench
    seed's refined ATE went 0.0024 -> 0.0124 m — the
    "sub-noise" late iterations carry real signal along the
    weakly-observed modes that the refine then needs in its init.
    """
    eps = float(jnp.finfo(dtype).eps)
    ftol = max(_FUNCTION_TOL, ftol_floor * eps)
    ptol = max(_PARAM_TOL, 8.0 * eps)
    return ftol, ptol


class BAStats(NamedTuple):
    iterations: jnp.ndarray       # successful + unsuccessful LM steps
    initial_cost: jnp.ndarray
    final_cost: jnp.ndarray


def _robust_weights(r, huber_delta, robust):
    """Ceres Huber loss: cost = 1/2 rho(|r|^2); residual scaling sqrt(rho')."""
    s = jnp.sum(r * r, axis=-1)
    if not robust:
        return jnp.ones_like(s), 0.5 * s
    d2 = huber_delta * huber_delta
    out = s > d2
    rho = jnp.where(out, 2.0 * huber_delta * jnp.sqrt(jnp.maximum(s, 1e-300))
                    - d2, s)
    rho1 = jnp.where(out, huber_delta / jnp.sqrt(jnp.maximum(s, 1e-300)), 1.0)
    return jnp.sqrt(rho1), 0.5 * rho


def _obs_blocks(cam_wt, line_orth, obs, obs_cam, obs_line, w_valid,
                cam_free_f, line_free_f, baseline, huber_delta, robust,
                line_param="orth"):
    """Robustified cost and the per-observation normal-equation blocks
    (A (O,6,6), B (O,4,4), Wb (O,6,4), gc_o (O,6), gl_o (O,4)); rows with
    w_valid == 0 contribute exact zeros."""
    cw = cam_wt[obs_cam]
    lo = line_orth[obs_line]
    r, Jc, Jl = lba_residual_jac_batch(cw, lo, obs, baseline,
                                       line_param=line_param)

    w_r, cost_i = _robust_weights(r, huber_delta, robust)
    cost = jnp.sum(jnp.where(w_valid > 0, cost_i, 0.0))

    # NaN-proof masking: padded observations may hold garbage that evaluates
    # to NaN/Inf — select-zero them rather than multiply (0 * NaN = NaN).
    valid = w_valid[:, None] > 0
    scale = w_r[:, None]
    r = jnp.where(valid, r * scale, 0.0)
    Jc = jnp.where(valid[..., None],
                   Jc * scale[..., None] * cam_free_f[obs_cam][:, None, None],
                   0.0)
    Jl = jnp.where(valid[..., None],
                   Jl * scale[..., None] * line_free_f[obs_line][:, None, None],
                   0.0)

    A = jnp.einsum("oki,okj->oij", Jc, Jc)          # (O,6,6)
    B = jnp.einsum("oki,okj->oij", Jl, Jl)          # (O,4,4)
    Wb = jnp.einsum("oki,okj->oij", Jc, Jl)         # (O,6,4)
    gc_o = jnp.einsum("oki,ok->oi", Jc, r)          # (O,6)
    gl_o = jnp.einsum("oki,ok->oi", Jl, r)          # (O,4)
    return cost, A, B, Wb, gc_o, gl_o


def assemble(A, B, Wb, gc_o, gl_o, obs_cam, obs_line, C, L, assembly):
    """Sum per-observation blocks into Hcc (C,6,6), Hll (L,4,4), gc (C,6),
    gl (L,4) and the cam-line coupling W (C,L,6,4).

    Each (cam, line) pair has at most one valid observation, so every W
    block sums one term.  The modes are compared in default_assembly.
    """
    dtype = A.dtype
    if assembly == "blocked":
        # CALLER CONTRACT: obs_cam == repeat(arange(C), O//C) — the
        # camera-major contiguous layout the batch engine's window
        # packing produces (engine/batch.py: ob = win_obs.reshape(...)).
        # Per-camera sums become plain reshapes, and the cam-line
        # coupling W a batched (Om x L) matmul per camera instead of the
        # "onehot" mode's (O, C*L) one-hot, which is ~C x larger.
        Hcc = jnp.sum(A.reshape(C, -1, 6, 6), axis=1)
        gc = jnp.sum(gc_o.reshape(C, -1, 6), axis=1)
        ol1h = jax.nn.one_hot(obs_line, L, dtype=dtype)       # (O, L)
        Hll = jnp.einsum("ol,oij->lij", ol1h, B)
        gl = ol1h.T @ gl_o
        W = jnp.einsum("col,cox->clx", ol1h.reshape(C, -1, L),
                       Wb.reshape(C, -1, 24)).reshape(C, L, 6, 4)
    elif assembly == "onehot":
        oc1h = jax.nn.one_hot(obs_cam, C, dtype=dtype)        # (O, C)
        ol1h = jax.nn.one_hot(obs_line, L, dtype=dtype)       # (O, L)
        Hcc = jnp.einsum("oc,oij->cij", oc1h, A)
        Hll = jnp.einsum("ol,oij->lij", ol1h, B)
        gc = oc1h.T @ gc_o
        gl = ol1h.T @ gl_o
        pair = obs_cam * L + obs_line
        p1h = jax.nn.one_hot(pair, C * L, dtype=dtype)        # (O, C*L)
        W = (p1h.T @ Wb.reshape(-1, 24)).reshape(C, L, 6, 4)
    elif assembly == "scatter":
        Hcc = jnp.zeros((C, 6, 6), dtype).at[obs_cam].add(A)
        Hll = jnp.zeros((L, 4, 4), dtype).at[obs_line].add(B)
        gc = jnp.zeros((C, 6), dtype).at[obs_cam].add(gc_o)
        gl = jnp.zeros((L, 4), dtype).at[obs_line].add(gl_o)
        W = jnp.zeros((C, L, 6, 4), dtype).at[obs_cam, obs_line].add(Wb)
    else:
        raise ValueError(f"unknown assembly mode {assembly!r}")
    return Hcc, Hll, gc, gl, W


def _eval_system(cam_wt, line_orth, obs, obs_cam, obs_line, w_valid,
                 cam_free_f, line_free_f, baseline, huber_delta, robust,
                 line_param="orth", assembly="scatter"):
    """Residuals, robustified cost, and all normal-equation blocks.

    Memory note: this materializes the dense (C, L, 6, 4) coupling W —
    exact and fast at window scale.  For global solves past C*L ~ 1e6 use
    ops/schur_cg.py (matrix-free Schur, linear memory).
    """
    cost, A, B, Wb, gc_o, gl_o = _obs_blocks(
        cam_wt, line_orth, obs, obs_cam, obs_line, w_valid, cam_free_f,
        line_free_f, baseline, huber_delta, robust, line_param=line_param)
    Hcc, Hll, gc, gl, W = assemble(A, B, Wb, gc_o, gl_o, obs_cam, obs_line,
                                   cam_wt.shape[0], line_orth.shape[0],
                                   assembly)
    return cost, Hcc, Hll, gc, gl, W


def _eval_pose_system(cam_wt, line_orth, obs, obs_cam, obs_line, w_valid,
                      cam_free_f, baseline, huber_delta, robust,
                      line_param="orth", assembly="scatter"):
    """Camera-only normal equations: the motion-only-BA special case
    (slam.cpp:578-675 — every line fixed).  Numerically identical to
    _eval_system with line_free_f = 0 (all line terms vanish exactly),
    but the line-Jacobian / coupling / Schur HLO never exists — the
    dominant compile-time term of the batch engine's per-frame moBA."""
    C = cam_wt.shape[0]
    cw = cam_wt[obs_cam]
    lo = line_orth[obs_line]
    r, Jc = lba_residual_jac_cam_batch(cw, lo, obs, baseline,
                                       line_param=line_param)
    w_r, cost_i = _robust_weights(r, huber_delta, robust)
    cost = jnp.sum(jnp.where(w_valid > 0, cost_i, 0.0))
    valid = w_valid[:, None] > 0
    scale = w_r[:, None]
    r = jnp.where(valid, r * scale, 0.0)
    Jc = jnp.where(valid[..., None],
                   Jc * scale[..., None] * cam_free_f[obs_cam][:, None, None],
                   0.0)
    A = jnp.einsum("oki,okj->oij", Jc, Jc)          # (O,6,6)
    gc_o = jnp.einsum("oki,ok->oi", Jc, r)          # (O,6)
    if assembly == "onehot":
        oc1h = jax.nn.one_hot(obs_cam, C, dtype=r.dtype)
        Hcc = jnp.einsum("oc,oij->cij", oc1h, A)
        gc = oc1h.T @ gc_o
    else:
        Hcc = jnp.zeros((C, 6, 6), r.dtype).at[obs_cam].add(A)
        gc = jnp.zeros((C, 6), r.dtype).at[obs_cam].add(gc_o)
    return cost, Hcc, gc


def _solve_step_pose(Hcc, gc, lam, cam_free_f):
    """Damped camera-block solve — _solve_step with every line fixed
    (block-diagonal reduced system, solved batched per camera)."""
    dtype = Hcc.dtype
    diag_c = jnp.clip(jnp.diagonal(Hcc, axis1=-2, axis2=-1),
                      _MIN_DIAG, _MAX_DIAG)                  # (C,6)
    eye6 = jnp.eye(6, dtype=dtype)
    Hcc_d = Hcc + lam * diag_c[..., None] * eye6
    f = cam_free_f[:, None, None]
    Hm = Hcc_d * f + eye6 * (1.0 - f)      # fixed cameras: identity block
    rhs = -gc * cam_free_f[:, None]
    d = jnp.sqrt(jnp.clip(jnp.diagonal(Hm, axis1=-2, axis2=-1),
                          1e-12, None))
    di = 1.0 / d
    Hn = Hm * di[..., :, None] * di[..., None, :]
    # batched equilibrated CHOLESKY, matching _cho_solve_equilibrated: an
    # LU solve here differed by 10+ units along near-null directions of
    # ill-conditioned f32 windows (equal cost, wild pose) and corrupted
    # the interactive engine's moBA polish
    def _cho1(Hb, rb):
        cf = jax.scipy.linalg.cho_factor(Hb)
        return jax.scipy.linalg.cho_solve(cf, rb)
    dc = jax.vmap(_cho1)(Hn, rhs * di) * di
    dc = dc * cam_free_f[:, None]
    damp_quad = lam * jnp.sum(diag_c * dc * dc)
    g_dot_d = jnp.sum(gc * dc)
    return dc, damp_quad, g_dot_d


def lines_gn_impl(cam_wt, line_orth, obs, obs_cam, obs_line, obs_valid,
                  line_free, baseline, huber_delta, robust=True,
                  iters=4, line_param="orth", assembly=None):
    """Lines-only damped Gauss-Newton: cameras fixed, every line an
    independent 4x4 block (no Schur, no camera system, no while_loop).

    The staged-solve trick of engine/refine.py applied per window: a new
    line enters the map triangulated from ONE stereo pair, whose depth
    noise at outdoor scale (z^2/(b f), meters at 10+ m) starts it far
    outside its basin; the joint window LM then spends its whole
    iteration budget dragging lines in (the myungdong/olympic proxies
    pinned avg_num_iterations at the cap, with seed-dependent multi-
    meter drift).  A few damped GN steps on the line blocks alone land
    them in the basin first, so the joint solve polishes instead of
    rescuing.  Steps that do not reduce a line's own robust cost are
    rejected per line (parallel trust-region-lite).
    """
    if assembly is None:
        assembly = default_assembly(jax.default_backend())
    from .residuals import lba_residual_jac_line_batch

    L = line_orth.shape[0]
    dtype = cam_wt.dtype
    w_valid = obs_valid.astype(dtype)
    line_free_f = line_free.astype(dtype)
    cw = cam_wt[obs_cam]

    def eval_lines(lo):
        r, Jl = lba_residual_jac_line_batch(cw, lo[obs_line], obs,
                                            baseline,
                                            line_param=line_param)
        w_r, cost_i = _robust_weights(r, huber_delta, robust)
        valid = w_valid[:, None] > 0
        scale = w_r[:, None]
        r = jnp.where(valid, r * scale, 0.0)
        Jl = jnp.where(valid[..., None], Jl * scale[..., None]
                       * line_free_f[obs_line][:, None, None], 0.0)
        B = jnp.einsum("oki,okj->oij", Jl, Jl)
        gl_o = jnp.einsum("oki,ok->oi", Jl, r)
        cost_o = jnp.where(w_valid > 0, cost_i, 0.0)
        if assembly == "onehot":
            ol1h = jax.nn.one_hot(obs_line, L, dtype=r.dtype)
            Hll = jnp.einsum("ol,oij->lij", ol1h, B)
            gl = ol1h.T @ gl_o
            cost_l = ol1h.T @ cost_o
        else:
            Hll = jnp.zeros((L, 4, 4), r.dtype).at[obs_line].add(B)
            gl = jnp.zeros((L, 4), r.dtype).at[obs_line].add(gl_o)
            cost_l = jnp.zeros((L,), r.dtype).at[obs_line].add(cost_o)
        return Hll, gl, cost_l

    def cost_lines(lo):
        from .residuals import lba_residual_batch
        r = lba_residual_batch(cw, lo[obs_line], obs, baseline,
                               line_param=line_param)
        _, cost_i = _robust_weights(r, huber_delta, robust)
        cost_o = jnp.where(w_valid > 0, cost_i, 0.0)
        if assembly == "onehot":
            ol1h = jax.nn.one_hot(obs_line, L, dtype=r.dtype)
            return ol1h.T @ cost_o
        return jnp.zeros((L,), r.dtype).at[obs_line].add(cost_o)

    lam = jnp.asarray(1e-3, dtype)

    def body(lo, _):
        Hll, gl, cost_l = eval_lines(lo)
        diag_l = jnp.clip(jnp.diagonal(Hll, axis1=-2, axis2=-1),
                          _MIN_DIAG, _MAX_DIAG)
        Binv = _inv4_equilibrated(
            Hll + lam * diag_l[..., None] * jnp.eye(4, dtype=dtype))
        dl = -jnp.einsum("lab,lb->la", Binv, gl) * line_free_f[:, None]
        lo_new = lo + dl
        cost_new = cost_lines(lo_new)
        # STRICT improvement with margin: an equal-cost step is a move
        # along a null direction (measured: `<=` here drifted weakly
        # observed landmarks 0.19 m off the world on the house e2e)
        take = jnp.logical_and(jnp.isfinite(cost_new),
                               cost_new < cost_l * (1.0 - 1e-4))[:, None]
        take = jnp.logical_and(take,
                               jnp.all(jnp.isfinite(lo_new), axis=-1,
                                       keepdims=True))
        return jnp.where(take, lo_new, lo), None

    out, _ = jax.lax.scan(body, line_orth, None, length=iters)
    return out


lines_gn = jax.jit(lines_gn_impl, static_argnames=("robust", "iters",
                                                   "line_param",
                                                   "assembly"))


def _inv4_equilibrated(Hll_d):
    """Jacobi-equilibrated batched 4x4 inverse.

    inv(A) = D^-1 inv(D^-1 A D^-1) D^-1 with D = sqrt(diag A): unit-diagonal
    conditioning before the inverse.  Matters in f32, where the normal
    equations' squared conditioning otherwise eats most of the mantissa.
    """
    d = jnp.sqrt(jnp.clip(jnp.diagonal(Hll_d, axis1=-2, axis2=-1),
                          1e-12, None))
    di = 1.0 / d
    An = Hll_d * di[..., :, None] * di[..., None, :]
    return jnp.linalg.inv(An) * di[..., :, None] * di[..., None, :]


def _cho_solve_equilibrated(S, rhs):
    """Jacobi-equilibrated dense Cholesky solve (same rationale)."""
    d = jnp.sqrt(jnp.clip(jnp.diagonal(S), 1e-12, None))
    di = 1.0 / d
    Sn = S * di[:, None] * di[None, :]
    cf = jax.scipy.linalg.cho_factor(Sn)
    return jax.scipy.linalg.cho_solve(cf, rhs * di) * di


def _solve_step(Hcc, Hll, gc, gl, W, lam, cam_free_f, line_free_f,
                Hoff=None, edge_i=None, edge_j=None):
    """Solve (H + lam * D^2) delta = -g by Schur elimination of lines.

    Hoff (E, 6, 6) with (edge_i, edge_j): off-diagonal camera-camera
    coupling blocks from pose-prior edges (local_ba_impl prior_edges) —
    scattered straight into the dense reduced system."""
    C = Hcc.shape[0]
    L = Hll.shape[0]
    dtype = Hcc.dtype

    diag_c = jnp.clip(jnp.diagonal(Hcc, axis1=-2, axis2=-1),
                      _MIN_DIAG, _MAX_DIAG)                  # (C,6)
    diag_l = jnp.clip(jnp.diagonal(Hll, axis1=-2, axis2=-1),
                      _MIN_DIAG, _MAX_DIAG)                  # (L,4)

    eye4 = jnp.eye(4, dtype=dtype)
    Hll_d = Hll + lam * diag_l[..., None] * eye4
    Binv = _inv4_equilibrated(Hll_d)                         # (L,4,4)

    # Reduced camera system S (6C x 6C).
    Wm = jnp.transpose(W, (0, 2, 1, 3)).reshape(C * 6, L * 4)
    X = jnp.einsum("clab,lbd->clad", W, Binv)
    Xm = jnp.transpose(X, (0, 2, 1, 3)).reshape(C * 6, L * 4)
    S = -Xm @ Wm.T
    Hcc_d = Hcc + lam * diag_c[..., None] * jnp.eye(6, dtype=dtype)
    S = S.reshape(C, 6, C, 6).at[jnp.arange(C), :, jnp.arange(C), :].add(
        Hcc_d)
    if Hoff is not None:
        S = S.at[edge_i, :, edge_j, :].add(Hoff)
        S = S.at[edge_j, :, edge_i, :].add(
            jnp.transpose(Hoff, (0, 2, 1)))
    S = S.reshape(C * 6, C * 6)

    rhs = (-gc.reshape(-1) + Xm @ gl.reshape(-1))

    # Fixed cameras: identity rows/cols, zero rhs.
    m = jnp.repeat(cam_free_f, 6)
    S = S * m[:, None] * m[None, :] + jnp.diag(1.0 - m)
    rhs = rhs * m

    dc = _cho_solve_equilibrated(S, rhs).reshape(C, 6)

    # Back-substitute line updates.
    coup = jnp.einsum("clab,ca->lb", W, dc)                  # (L,4)
    dl = -jnp.einsum("lab,lb->la", Binv, gl + coup)
    dl = dl * line_free_f[:, None]
    dc = dc * cam_free_f[:, None]

    # lam * delta^T D^2 delta (for the model-cost change).
    damp_quad = lam * (jnp.sum(diag_c * dc * dc) + jnp.sum(diag_l * dl * dl))
    g_dot_d = jnp.sum(gc * dc) + jnp.sum(gl * dl)
    return dc, dl, damp_quad, g_dot_d


def local_ba_impl(cam_wt, line_orth, obs, obs_cam, obs_line, obs_valid,
                  cam_free, line_free, baseline, huber_delta,
                  robust=True, max_iters=10,
                  line_param="orth", assembly=None, pose_only=False,
                  cam_anchor_sigmas=None, prior_edges=None):
    """Run windowed local BA.  All shapes static (padded).

    Args:
      cam_wt:    (C, 6) camera poses (angle-axis, translation), world->cam.
      line_orth: (L, 4) line parameters (orthonormal).
      obs:       (O, 8) normalized stereo endpoint observations.
      obs_cam:   (O,) camera index per observation.
      obs_line:  (O,) line index per observation.
      obs_valid: (O,) validity mask (False for padding).
      cam_free:  (C,) True if the camera pose is optimized.
      line_free: (L,) True if the line is optimized.
      baseline, huber_delta: scalars.
      robust: apply Huber loss (FLAGS_robust, main.cpp:27).
      max_iters: LM iteration cap (FLAGS_max_num_iter, main.cpp:23).
      pose_only: static; every line is treated as fixed (line_free
        ignored) and the line-Jacobian/Schur machinery is never built —
        the motion-only-BA instantiation (slam.cpp:578-675).  Identical
        math to the full path with line_free all-False.
      prior_edges: optional (ei (E,), ej (E,), c (E, 6), sig (E, 2)) —
        pairwise pose constraints ``T_j ~ c . T_i`` with per-edge
        (sigma_rot, sigma_t), fused into the normal equations exactly as
        the CG path's prior_edges (ops/schur_cg.py) but with the
        off-diagonal coupling blocks scattered into the DENSE reduced
        camera system.  Built for the deferred-LC joint span confirms
        (engine/batch_lc.py): their problems are window-sized, and the
        dense solver runs ONE device step per LM iteration where the
        matrix-free CG path runs a nested while_loop of tiny latency-
        bound matvecs — which, vmapped across confirm lanes, inflated to
        max-over-lanes steps at BOTH nesting levels (r5 measurement: the
        1000-keyframe confirm wall).  Pad with zero-weight self-edges
        (sig ~ 1e9).
      cam_anchor_sigmas: optional (sigma_rot, sigma_t) — a weak Gaussian
        anchor of every free camera at its INITIAL pose, fused into the
        normal equations.  Outdoor windows (distant lines, 0.12 m stereo
        baseline) have near-null pose modes along which LM descends a
        flat robust-cost valley indefinitely (measured on captured
        myungdong windows: cost still falling 1%/iteration at 80
        iterations with ~0.1 m of pose wander; final accuracy was a
        chaotic function of the iteration cap — 1.7/6.8/1.0 m ATE at
        caps 10/25/50).  The anchor is a standard motion-model prior:
        strong directions (sigma-dominated by the observations) converge
        unchanged, null directions stay at the odometry prediction.  No
        reference analog (documented deviation, PARITY.md).

    Returns:
      (cam_wt', line_orth', BAStats)
    """
    if assembly is None:
        assembly = default_assembly(jax.default_backend())
    dtype = cam_wt.dtype
    ftol, ptol = _tolerances(dtype)
    cam_free_f = cam_free.astype(dtype)
    line_free_f = line_free.astype(dtype)
    w_valid = obs_valid.astype(dtype)

    if cam_anchor_sigmas is not None:
        sr, st = cam_anchor_sigmas
        aw = jnp.concatenate([jnp.full(3, 1.0, dtype) / sr,
                              jnp.full(3, 1.0, dtype) / st])   # (6,)
        anchor = cam_wt

    def _anchor_terms(cw):
        d = (cw - anchor) * cam_free_f[:, None]
        cost_a = 0.5 * jnp.sum((d * aw) ** 2)
        g_a = d * (aw * aw)                                    # (C,6)
        return cost_a, g_a

    if prior_edges is not None:
        assert not pose_only, "prior_edges needs the full solve path"
        edge_i, edge_j, edge_c, edge_sig = prior_edges
        edge_sig = jnp.asarray(edge_sig, dtype)
        pscale = jnp.concatenate(
            [1.0 / jnp.repeat(edge_sig[:, 0:1], 3, axis=1),
             1.0 / jnp.repeat(edge_sig[:, 1:2], 3, axis=1)], axis=1)

    def _edge_terms(cw):
        """(cost_e, gc_e (C,6), Hcc_e (C,6,6), Hoff (E,6,6))."""
        from .pose_graph import _edge_rj_batch
        r, J1, J2 = _edge_rj_batch(cw[edge_i], cw[edge_j], edge_c)
        r = r * pscale
        J1 = J1 * pscale[:, :, None] * cam_free_f[edge_i, None, None]
        J2 = J2 * pscale[:, :, None] * cam_free_f[edge_j, None, None]
        cost_e = 0.5 * jnp.sum(r * r)
        C = cw.shape[0]
        gc_e = jnp.zeros((C, 6), dtype)
        gc_e = gc_e.at[edge_i].add(jnp.einsum("eki,ek->ei", J1, r))
        gc_e = gc_e.at[edge_j].add(jnp.einsum("eki,ek->ei", J2, r))
        Hcc_e = jnp.zeros((C, 6, 6), dtype)
        Hcc_e = Hcc_e.at[edge_i].add(jnp.einsum("eki,ekj->eij", J1, J1))
        Hcc_e = Hcc_e.at[edge_j].add(jnp.einsum("eki,ekj->eij", J2, J2))
        Hoff = jnp.einsum("eki,ekj->eij", J1, J2)
        return cost_e, gc_e, Hcc_e, Hoff

    # The full system (residuals + Jacobians + assembly) is evaluated
    # INSIDE the loop body only, at the current accepted point; the trial
    # point is scored with a residual-only cost.  One instance of the
    # dominant evaluate-HLO instead of two (the r3 layout evaluated the
    # full system at the trial point and carried H across iterations —
    # same accepted-step sequence, but the big HLO appeared both before
    # and inside the loop, and the (C,L,6,4) coupling W sat in the carry).
    def evaluate(cw, lo):
        if pose_only:
            out = _eval_pose_system(cw, lo, obs, obs_cam, obs_line,
                                    w_valid, cam_free_f, baseline,
                                    huber_delta, robust,
                                    line_param=line_param,
                                    assembly=assembly)
        else:
            out = _eval_system(cw, lo, obs, obs_cam, obs_line, w_valid,
                               cam_free_f, line_free_f, baseline,
                               huber_delta, robust,
                               line_param=line_param, assembly=assembly)
        if cam_anchor_sigmas is not None:
            cost_a, g_a = _anchor_terms(cw)
            H_a = jnp.diag(aw * aw)[None] * cam_free_f[:, None, None]
            if pose_only:
                cost, Hcc, gc = out
                out = (cost + cost_a, Hcc + H_a, gc + g_a)
            else:
                cost, Hcc, Hll, gc, gl, W = out
                out = (cost + cost_a, Hcc + H_a, Hll, gc + g_a, gl, W)
        if prior_edges is None:
            return out
        cost, Hcc, Hll, gc, gl, W = out
        cost_e, gc_e, Hcc_e, Hoff = _edge_terms(cw)
        return cost + cost_e, Hcc + Hcc_e, Hll, gc + gc_e, gl, W, Hoff

    def cost_only(cw, lo):
        r = lba_residual_batch(cw[obs_cam], lo[obs_line], obs, baseline,
                               line_param=line_param)
        _, cost_i = _robust_weights(r, huber_delta, robust)
        cost = jnp.sum(jnp.where(w_valid > 0, cost_i, 0.0))
        if cam_anchor_sigmas is not None:
            cost = cost + _anchor_terms(cw)[0]
        if prior_edges is not None:
            # full (unmasked) residual, matching _edge_terms' cost — the
            # trial/accepted costs must be the same function for rho
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
        # the isfinite guard terminates garbage lanes immediately: under
        # vmap (batched multi-sequence replay, engine/batch.py
        # dispatch_many) BOTH branches of the engine's keyframe lax.cond
        # execute for every lane, so this solver runs on empty/NaN
        # problems whose lanes must not drag every other lane through the
        # full iteration cap (a vmapped while_loop runs until ALL lanes
        # exit)
        return jnp.logical_and(
            jnp.logical_and(s.it < max_iters, jnp.logical_not(s.done)),
            jnp.isfinite(s.cost))

    def body(s):
        lam = 1.0 / s.radius
        if pose_only:
            _, Hcc, gc = evaluate(s.cam, s.line)
            dc, damp_quad, g_dot_d = _solve_step_pose(Hcc, gc, lam,
                                                      cam_free_f)
            dl = jnp.zeros_like(s.line)
        elif prior_edges is not None:
            _, Hcc, Hll, gc, gl, W, Hoff = evaluate(s.cam, s.line)
            dc, dl, damp_quad, g_dot_d = _solve_step(
                Hcc, Hll, gc, gl, W, lam, cam_free_f, line_free_f,
                Hoff=Hoff, edge_i=edge_i, edge_j=edge_j)
        else:
            _, Hcc, Hll, gc, gl, W = evaluate(s.cam, s.line)
            dc, dl, damp_quad, g_dot_d = _solve_step(
                Hcc, Hll, gc, gl, W, lam, cam_free_f, line_free_f)

        cam_new = s.cam + dc
        line_new = s.line + dl
        cost_new = cost_only(cam_new, line_new)

        # model_cost_change = 1/2 d^T (lam D^2 d - g)  (see module docstring)
        model_change = 0.5 * (damp_quad - g_dot_d)
        rho = (s.cost - cost_new) / jnp.maximum(model_change, 1e-300)
        accept = jnp.logical_and(model_change > 0,
                                 rho > _MIN_RELATIVE_DECREASE)
        accept = jnp.logical_and(accept, jnp.isfinite(cost_new))

        # Trust-region update (Ceres LevenbergMarquardtStrategy).
        tmp = 2.0 * rho - 1.0
        radius_acc = s.radius / jnp.maximum(1.0 / 3.0, 1.0 - tmp ** 3)
        radius_rej = s.radius / s.decrease_factor
        radius = jnp.where(accept, jnp.minimum(radius_acc, 1e16),
                           jnp.maximum(radius_rej, 1e-32))
        dec = jnp.where(accept, 2.0, s.decrease_factor * 2.0)

        # Ceres termination: function tolerance on the accepted cost change
        # and parameter tolerance on the step size (dtype-floored; see
        # _tolerances).
        fconv = jnp.abs(s.cost - cost_new) <= ftol * s.cost
        xnorm = jnp.sqrt(jnp.sum(s.cam * s.cam) + jnp.sum(s.line * s.line))
        snorm = jnp.sqrt(jnp.sum(dc * dc) + jnp.sum(dl * dl))
        pconv = snorm <= ptol * (xnorm + ptol)
        converged = jnp.logical_and(accept, jnp.logical_or(fconv, pconv))
        # degenerate lanes (all-zero system: H = g = 0 so the step is
        # exactly zero, or a non-finite step) can never make progress —
        # stop instead of rejecting the null step until the cap (see the
        # vmap note on `cond`; a real problem never produces an exactly
        # zero step)
        dead = jnp.logical_not(snorm > 0)
        converged = jnp.logical_or(converged, dead)

        return _S(
            jnp.where(accept, cam_new, s.cam),
            jnp.where(accept, line_new, s.line),
            jnp.where(accept, cost_new, s.cost),
            radius, dec, s.it + 1, converged)

    out = jax.lax.while_loop(cond, body, state)
    stats = BAStats(out.it, cost0, out.cost)
    return out.cam, out.line, stats


local_ba = jax.jit(local_ba_impl, static_argnames=("robust", "max_iters",
                                                   "line_param",
                                                   "assembly", "pose_only"))


def staged_local_ba_impl(cam_wt, line_orth, obs, obs_cam, obs_line,
                         obs_valid, cam_free, line_free, baseline,
                         huber_delta, robust=True, max_iters=10,
                         line_param="orth", assembly=None, gn_iters=4,
                         cam_anchor_sigmas=None, gn_free=None):
    """lines_gn pre-stage + local_ba as ONE traced body (one dispatch on
    the interactive per-frame path; see SlamConfig.lines_gn_iters).
    ``gn_free`` restricts the pre-stage to a subset of lines (the
    new-to-BA ones); default = line_free."""
    if gn_iters > 0:
        line_orth = lines_gn_impl(cam_wt, line_orth, obs, obs_cam,
                                  obs_line, obs_valid,
                                  line_free if gn_free is None
                                  else gn_free,
                                  baseline, huber_delta, robust=robust,
                                  iters=gn_iters, line_param=line_param,
                                  assembly=assembly)
    return local_ba_impl(cam_wt, line_orth, obs, obs_cam, obs_line,
                         obs_valid, cam_free, line_free, baseline,
                         huber_delta, robust=robust, max_iters=max_iters,
                         line_param=line_param, assembly=assembly,
                         cam_anchor_sigmas=cam_anchor_sigmas)


staged_local_ba = jax.jit(
    staged_local_ba_impl,
    static_argnames=("robust", "max_iters", "line_param", "assembly",
                     "gn_iters"))


# ---------------------------------------------------------------------------
# Line-sharded distributed solver
# ---------------------------------------------------------------------------

def _solve_step_sharded(Hcc, Hll, gc, gl, W, lam, cam_free_f, line_free_f,
                        axis_name):
    """_solve_step with lines (and W columns) sharded over `axis_name`.

    Each shard eliminates its own 4x4 line blocks and contributes a partial
    reduced camera system; one psum of the (6C x 6C) coupling + rhs per
    iteration is the only communication — the Schur reduction itself rides
    the shards.
    """
    C = Hcc.shape[0]
    dtype = Hcc.dtype

    diag_c = jnp.clip(jnp.diagonal(Hcc, axis1=-2, axis2=-1),
                      _MIN_DIAG, _MAX_DIAG)
    diag_l = jnp.clip(jnp.diagonal(Hll, axis1=-2, axis2=-1),
                      _MIN_DIAG, _MAX_DIAG)

    L_loc = Hll.shape[0]
    eye4 = jnp.eye(4, dtype=dtype)
    Hll_d = Hll + lam * diag_l[..., None] * eye4
    Binv = _inv4_equilibrated(Hll_d)                   # local lines

    Wm = jnp.transpose(W, (0, 2, 1, 3)).reshape(C * 6, L_loc * 4)
    X = jnp.einsum("clab,lbd->clad", W, Binv)
    Xm = jnp.transpose(X, (0, 2, 1, 3)).reshape(C * 6, L_loc * 4)
    S_coup = jax.lax.psum(Xm @ Wm.T, axis_name)
    rhs_coup = jax.lax.psum(Xm @ gl.reshape(-1), axis_name)

    Hcc_d = Hcc + lam * diag_c[..., None] * jnp.eye(6, dtype=dtype)
    S = (-S_coup).reshape(C, 6, C, 6).at[
        jnp.arange(C), :, jnp.arange(C), :].add(Hcc_d).reshape(C * 6, C * 6)
    rhs = -gc.reshape(-1) + rhs_coup

    m = jnp.repeat(cam_free_f, 6)
    S = S * m[:, None] * m[None, :] + jnp.diag(1.0 - m)
    rhs = rhs * m

    dc = _cho_solve_equilibrated(S, rhs).reshape(C, 6)

    coup = jnp.einsum("clab,ca->lb", W, dc)
    dl = -jnp.einsum("lab,lb->la", Binv, gl + coup) * line_free_f[:, None]
    dc = dc * cam_free_f[:, None]

    damp_quad = (lam * jnp.sum(diag_c * dc * dc)
                 + jax.lax.psum(lam * jnp.sum(diag_l * dl * dl), axis_name))
    g_dot_d = (jnp.sum(gc * dc)
               + jax.lax.psum(jnp.sum(gl * dl), axis_name))
    return dc, dl, damp_quad, g_dot_d


def local_ba_sharded_impl(cam_wt, line_orth, obs, obs_cam, obs_line,
                          obs_valid, cam_free, line_free, baseline,
                          huber_delta, robust=True, max_iters=10,
                          axis_name="shard", line_param="orth",
                          assembly=None):
    """Line-sharded local BA body (runs inside shard_map).

    Per-shard arguments hold that shard's lines and the observations of
    those lines (obs_line indexes the LOCAL line array); cameras are
    replicated.  Communication per LM iteration: one psum of
    {cost, Hcc, gc} at evaluation and one psum of the (6C x 6C) coupling at
    the solve — independent of the number of lines/observations.
    """
    if assembly is None:
        assembly = default_assembly(jax.default_backend())
    dtype = cam_wt.dtype
    ftol, ptol = _tolerances(dtype)
    cam_free_f = cam_free.astype(dtype)
    line_free_f = line_free.astype(dtype)
    w_valid = obs_valid.astype(dtype)

    def evaluate(cw, lo):
        cost, Hcc, Hll, gc, gl, W = _eval_system(
            cw, lo, obs, obs_cam, obs_line, w_valid, cam_free_f,
            line_free_f, baseline, huber_delta, robust,
            line_param=line_param, assembly=assembly)
        cost, Hcc, gc = jax.lax.psum((cost, Hcc, gc), axis_name)
        return cost, Hcc, Hll, gc, gl, W

    cost0, Hcc, Hll, gc, gl, W = evaluate(cam_wt, line_orth)

    class _S(NamedTuple):
        cam: jnp.ndarray
        line: jnp.ndarray
        cost: jnp.ndarray
        Hcc: jnp.ndarray
        Hll: jnp.ndarray
        gc: jnp.ndarray
        gl: jnp.ndarray
        W: jnp.ndarray
        radius: jnp.ndarray
        decrease_factor: jnp.ndarray
        it: jnp.ndarray
        done: jnp.ndarray

    state = _S(cam_wt, line_orth, cost0, Hcc, Hll, gc, gl, W,
               jnp.asarray(_INIT_RADIUS, dtype), jnp.asarray(2.0, dtype),
               jnp.asarray(0, jnp.int32), jnp.asarray(False))

    def cond(s):
        return jnp.logical_and(s.it < max_iters, jnp.logical_not(s.done))

    def body(s):
        lam = 1.0 / s.radius
        dc, dl, damp_quad, g_dot_d = _solve_step_sharded(
            s.Hcc, s.Hll, s.gc, s.gl, s.W, lam, cam_free_f, line_free_f,
            axis_name)

        cam_new = s.cam + dc
        line_new = s.line + dl
        cost_new, Hcc_n, Hll_n, gc_n, gl_n, W_n = evaluate(cam_new, line_new)

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
        # norms of the sharded line blocks reduce over the mesh axis
        xnorm = jnp.sqrt(jnp.sum(s.cam * s.cam)
                         + jax.lax.psum(jnp.sum(s.line * s.line), axis_name))
        snorm = jnp.sqrt(jnp.sum(dc * dc)
                         + jax.lax.psum(jnp.sum(dl * dl), axis_name))
        pconv = snorm <= ptol * (xnorm + ptol)
        converged = jnp.logical_and(accept, jnp.logical_or(fconv, pconv))

        return _S(jnp.where(accept, cam_new, s.cam),
                  jnp.where(accept, line_new, s.line),
                  jnp.where(accept, cost_new, s.cost),
                  jnp.where(accept, Hcc_n, s.Hcc),
                  jnp.where(accept, Hll_n, s.Hll),
                  jnp.where(accept, gc_n, s.gc),
                  jnp.where(accept, gl_n, s.gl),
                  jnp.where(accept, W_n, s.W),
                  radius, dec, s.it + 1, converged)

    out = jax.lax.while_loop(cond, body, state)
    return out.cam, out.line, BAStats(out.it, cost0, out.cost)
