"""Line reprojection residuals and Jacobians.

Two flavors, matching the reference exactly:

* ``lba_residual`` — the bundle-adjustment residual of
  ceres::LineReprojectionError (/root/reference/src/lba_problem.h:41-121):
  4 signed point-to-infinite-line distances (2 endpoints x 2 cameras) of a
  line given in orthonormal (alpha, beta, gamma, theta) parameters, observed
  by a camera given as an angle-axis 6-vector.  The first residual pair uses
  the camera pose as-is, the second shifts the transformed closest point by
  -baseline along x (the stereo pair; lba_problem.h:78-115 — note the
  reference hard-codes baseline 0.12 at lba_problem.h:101, we take it as an
  argument).

* ``score_error`` — the RANSAC scoring error of SLAM::reprojection_error
  (/root/reference/src/slam.cpp:691-726): mean of the 4 absolute distances,
  with the line given in (cp, dv) form in the source frame and a candidate
  motion.

Jacobians come from ``jax.jacfwd`` over the scalar residual — under jit this
produces exact, fused derivative code (the compiled equivalent of the
reference's Ceres autodiff, AutoDiffCostFunction<.,4,6,4> at
lba_problem.cpp:66) with no runtime autodiff overhead.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import geometry as geo

_EPS = 1e-12


_LINE_PARAM_DECODERS = {
    # production parameterization (lba_problem.h:50-72)
    "orth": geo.orth_to_av,
    # angle-axis frame + inverse depth — the MATLAB study's `aid`
    # (gc.cpp:188-261); included to reproduce the parameterization
    # comparison (BASELINE.md §1)
    "aid": geo.aid_to_av,
    # experimental sigmoid depth (gc.cpp:265-356)
    "asd": geo.asd_to_av,
}


def lba_residual(cam_wt, line_param4, obs, baseline, line_param="orth"):
    """BA residual. cam_wt: (6,), line_param4: (4,), obs: (8,) -> (4,).

    obs layout: (x0 y0 x1 y1 | x2 y2 x3 y3), left-image endpoint pair first
    (the loader contract, slam.cpp:85-95,121-128).  `line_param` selects the
    4-DoF line decoding (static under jit).
    """
    av = _LINE_PARAM_DECODERS[line_param](line_param4)
    cp, dv = av[..., :3], av[..., 3:]
    R = geo.rodrigues(cam_wt[..., :3])
    pc = jnp.einsum("...ij,...j->...i", R, cp) + cam_wt[..., 3:]
    dc = jnp.einsum("...ij,...j->...i", R, dv)

    def segment_residuals(p, x_a, y_a, x_b, y_b):
        n = jnp.cross(p, dc)
        sql = jnp.sqrt(n[..., 0] ** 2 + n[..., 1] ** 2)
        n = n / jnp.maximum(sql, _EPS)[..., None]
        r_a = -(x_a * n[..., 0] + y_a * n[..., 1] + n[..., 2])
        r_b = -(x_b * n[..., 0] + y_b * n[..., 1] + n[..., 2])
        return r_a, r_b

    r0, r1 = segment_residuals(pc, obs[..., 0], obs[..., 1],
                               obs[..., 2], obs[..., 3])
    pc_r = pc.at[..., 0].add(-baseline)
    r2, r3 = segment_residuals(pc_r, obs[..., 4], obs[..., 5],
                               obs[..., 6], obs[..., 7])
    return jnp.stack([r0, r1, r2, r3], axis=-1)


def lba_residual_jac(cam_wt, line_param4, obs, baseline, line_param="orth"):
    """Residual plus Jacobians d r / d cam (4, 6) and d r / d line (4, 4)."""
    r = lba_residual(cam_wt, line_param4, obs, baseline, line_param)
    j_cam = jax.jacfwd(lba_residual, argnums=0)(cam_wt, line_param4, obs,
                                                baseline, line_param)
    j_line = jax.jacfwd(lba_residual, argnums=1)(cam_wt, line_param4, obs,
                                                 baseline, line_param)
    return r, j_cam, j_line


def lba_residual_jac_cam(cam_wt, line_param4, obs, baseline,
                         line_param="orth"):
    """Residual plus camera Jacobian only — the motion-only BA variant
    (slam.cpp:578-675: all lines fixed), which skips the line-Jacobian
    HLO entirely."""
    r = lba_residual(cam_wt, line_param4, obs, baseline, line_param)
    j_cam = jax.jacfwd(lba_residual, argnums=0)(cam_wt, line_param4, obs,
                                                baseline, line_param)
    return r, j_cam


def lba_residual_jac_line(cam_wt, line_param4, obs, baseline,
                          line_param="orth"):
    """Residual plus line Jacobian only — the lines-only staged solve
    (cameras fixed), which skips the camera-Jacobian HLO."""
    r = lba_residual(cam_wt, line_param4, obs, baseline, line_param)
    j_line = jax.jacfwd(lba_residual, argnums=1)(cam_wt, line_param4, obs,
                                                 baseline, line_param)
    return r, j_line


def score_error(obs, R, t, line_av, baseline):
    """RANSAC scoring error (slam.cpp:691-726). Scalar per observation.

    obs: (8,), R/t: candidate motion source->target, line_av: (6,) (cp, dv)
    in the source frame.  Returns mean of 4 absolute normalized distances.
    """
    cp, dv = line_av[..., :3], line_av[..., 3:]

    def one_cam(shift):
        # shift may be a traced scalar; build the offset arithmetically
        tc = t + shift * jnp.array([1.0, 0.0, 0.0], dtype=t.dtype)
        cpc = jnp.einsum("...ij,...j->...i", R, cp) + tc
        dvc = jnp.einsum("...ij,...j->...i", R, dv)
        n = jnp.cross(cpc, dvc)
        sql = jnp.sqrt(n[..., 0] ** 2 + n[..., 1] ** 2)
        return n / jnp.maximum(sql, _EPS)[..., None]

    n_l = one_cam(0.0)
    n_r = one_cam(-baseline)

    def dist(n, x, y):
        return jnp.abs(x * n[..., 0] + y * n[..., 1] + n[..., 2])

    err = (dist(n_l, obs[..., 0], obs[..., 1])
           + dist(n_l, obs[..., 2], obs[..., 3])
           + dist(n_r, obs[..., 4], obs[..., 5])
           + dist(n_r, obs[..., 6], obs[..., 7]))
    return err / 4.0


# Batched variants ----------------------------------------------------------

# residual+jacobians over a batch of observations, each with its own camera
# and line parameters (already gathered): (O,6),(O,4),(O,8) -> (O,4),(O,4,6),(O,4,4)
@functools.lru_cache(maxsize=None)
def _jac_batch_for(line_param):
    fn = functools.partial(lba_residual_jac, line_param=line_param)
    return jax.vmap(fn, in_axes=(0, 0, 0, None))


def lba_residual_jac_batch(cam_wt, line_param4, obs, baseline,
                           line_param="orth"):
    return _jac_batch_for(line_param)(cam_wt, line_param4, obs, baseline)


@functools.lru_cache(maxsize=None)
def _jac_cam_batch_for(line_param):
    fn = functools.partial(lba_residual_jac_cam, line_param=line_param)
    return jax.vmap(fn, in_axes=(0, 0, 0, None))


def lba_residual_jac_cam_batch(cam_wt, line_param4, obs, baseline,
                               line_param="orth"):
    return _jac_cam_batch_for(line_param)(cam_wt, line_param4, obs,
                                          baseline)


@functools.lru_cache(maxsize=None)
def _jac_line_batch_for(line_param):
    fn = functools.partial(lba_residual_jac_line, line_param=line_param)
    return jax.vmap(fn, in_axes=(0, 0, 0, None))


def lba_residual_jac_line_batch(cam_wt, line_param4, obs, baseline,
                                line_param="orth"):
    return _jac_line_batch_for(line_param)(cam_wt, line_param4, obs,
                                           baseline)


# residual-only batch, jitted: callers that only score (e.g. the refine
# line-init candidate pick) must not pay eager jacfwd tracing per call
@functools.lru_cache(maxsize=None)
def _res_batch_for(line_param):
    fn = functools.partial(lba_residual, line_param=line_param)
    return jax.jit(jax.vmap(fn, in_axes=(0, 0, 0, None)))


def lba_residual_batch(cam_wt, line_param4, obs, baseline,
                       line_param="orth"):
    return _res_batch_for(line_param)(cam_wt, line_param4, obs, baseline)

# scoring over (hypotheses H, observations N): R (H,3,3), t (H,3) vs
# obs (N,8), lines (N,6) -> (H, N) errors
score_error_hyp_obs = jax.vmap(
    jax.vmap(score_error, in_axes=(0, None, None, 0, None)),
    in_axes=(None, 0, 0, None, None))
