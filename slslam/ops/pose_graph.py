"""Pose-graph optimization: batched Gauss-Newton/LM over SE(3) constraints.

Device replacement for SLAM::pose_optimization + ceres::POProblem
(/root/reference/src/slam.cpp:1236-1313, src/po_problem.{h,cpp}).  Residual
per edge (i, j) with constraint C (the stored relative pose i->j):

    Te = T2^-1 * (C * T1),  residual = 6-vector log of Te
    (po_problem.h:73-105)

All edge residuals and their 6x6 Jacobians are evaluated in one fused batch;
the normal equations are scattered into a dense 6V x 6V system (V <= a few
hundred keyframes — dense Cholesky is one batched kernel and far below the
crossover where sparsity would pay); the first edge's pose1 is gauge-fixed
(po_problem.cpp:62-63).  LM trust-region strategy identical to the BA kernel
(Ceres defaults), 10 iterations (po_problem set_options + slam.cpp:1283).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import geometry as geo


class PGOStats(NamedTuple):
    iterations: jnp.ndarray
    initial_cost: jnp.ndarray
    final_cost: jnp.ndarray


def edge_residual(pose1, pose2, constraint):
    """po_problem.h:73-105: Te = T2^-1 * C * T1 as a 6-vector.

    Composed in matrix form with ONE log at the end: the reference chains
    angle-axis compositions (quaternion helpers, po_problem.h:27-64),
    which materializes the intermediate C*T1 as an angle-axis vector —
    differentiating through that log is singular when the intermediate
    rotation angle hits pi (any trajectory that turns 180 degrees from
    the gauge frame).  The error transform Te itself is near identity for
    a sane graph, so the single final log is smooth where it matters.
    """
    Rc, tc = geo.wt_to_Rt(constraint)
    R1, t1 = geo.wt_to_Rt(pose1)
    R2, t2 = geo.wt_to_Rt(pose2)
    R = Rc @ R1                    # C * T1
    t = Rc @ t1 + tc
    Re = R2.T @ R                  # T2^-1 * (C * T1)
    te = R2.T @ (t - t2)
    return jnp.concatenate([geo.so3_log(Re), te])


def _edge_residual_jac(pose1, pose2, constraint):
    r = edge_residual(pose1, pose2, constraint)
    j1 = jax.jacfwd(edge_residual, argnums=0)(pose1, pose2, constraint)
    j2 = jax.jacfwd(edge_residual, argnums=1)(pose1, pose2, constraint)
    return r, j1, j2


_edge_rj_batch = jax.vmap(_edge_residual_jac, in_axes=(0, 0, 0))

_MIN_DIAG = 1e-6
_MAX_DIAG = 1e32
_INIT_RADIUS = 1e4
_MIN_RELATIVE_DECREASE = 1e-3
_FUNCTION_TOL = 1e-6


def _assemble(poses, edges_i, edges_j, constraints, e_valid, free_f,
              axis_name=None, huber_delta=None):
    V = poses.shape[0]
    p1 = poses[edges_i]
    p2 = poses[edges_j]
    r, j1, j2 = _edge_rj_batch(p1, p2, constraints)

    vmask = e_valid[:, None] > 0
    r = jnp.where(vmask, r, 0.0)
    j1 = jnp.where(vmask[..., None], j1 * free_f[edges_i][:, None, None], 0.0)
    j2 = jnp.where(vmask[..., None], j2 * free_f[edges_j][:, None, None], 0.0)

    if huber_delta is not None:
        # Huber on the edge residual norm: caps a wrong loop edge's
        # influence (no reference analog — its PGO is quadratic,
        # po_problem.h:68-108 — but the reference also never ran live
        # loop closure; the deferred batch-LC stitch wants robustness)
        from .schur_ba import _robust_weights
        w_r, cost_e = _robust_weights(r, huber_delta, True)
        cost = jnp.sum(jnp.where(e_valid > 0, cost_e, 0.0))
        r = r * w_r[:, None]
        j1 = j1 * w_r[:, None, None]
        j2 = j2 * w_r[:, None, None]
    else:
        cost = 0.5 * jnp.sum(r * r)

    H = jnp.zeros((V, 6, V, 6), poses.dtype)
    H = H.at[edges_i, :, edges_i, :].add(
        jnp.einsum("eki,ekj->eij", j1, j1))
    H = H.at[edges_j, :, edges_j, :].add(
        jnp.einsum("eki,ekj->eij", j2, j2))
    H = H.at[edges_i, :, edges_j, :].add(
        jnp.einsum("eki,ekj->eij", j1, j2))
    H = H.at[edges_j, :, edges_i, :].add(
        jnp.einsum("eki,ekj->eij", j2, j1))
    H = H.reshape(V * 6, V * 6)

    g = jnp.zeros((V, 6), poses.dtype)
    g = g.at[edges_i].add(jnp.einsum("eki,ek->ei", j1, r))
    g = g.at[edges_j].add(jnp.einsum("eki,ek->ei", j2, r))
    g = g.reshape(-1)
    if axis_name is not None:
        # edge-sharded distributed PGO: partial normal equations reduced
        # over the mesh axis (one psum per LM iteration)
        cost, H, g = jax.lax.psum((cost, H, g), axis_name)
    return cost, H, g


def pose_graph_opt_impl(poses, edges_i, edges_j, constraints, e_valid,
                        pose_free, max_iters=10, axis_name=None,
                        huber_delta=None):
    """Optimize keyframe poses against relative-pose constraints.

    Args:
      poses: (V, 6) keyframe poses as (angle-axis, t), world->cam.
      edges_i, edges_j: (E,) endpoint indices per edge.
      constraints: (E, 6) stored constraint C (pose of j relative to i).
      e_valid: (E,) mask (False for padding).
      pose_free: (V,) False for gauge-fixed poses (the reference fixes the
        first edge's pose1, po_problem.cpp:62-63) and padding.
      max_iters: LM cap (10 in the reference, slam.cpp:1283).

    Returns (poses', PGOStats).
    """
    dtype = poses.dtype
    free_f = pose_free.astype(dtype)
    ev = e_valid.astype(dtype)

    cost0, H, g = _assemble(poses, edges_i, edges_j, constraints, ev, free_f,
                            axis_name=axis_name, huber_delta=huber_delta)

    class _S(NamedTuple):
        poses: jnp.ndarray
        cost: jnp.ndarray
        H: jnp.ndarray
        g: jnp.ndarray
        radius: jnp.ndarray
        decrease_factor: jnp.ndarray
        it: jnp.ndarray
        done: jnp.ndarray

    state = _S(poses, cost0, H, g, jnp.asarray(_INIT_RADIUS, dtype),
               jnp.asarray(2.0, dtype), jnp.asarray(0, jnp.int32),
               jnp.asarray(False))

    m = jnp.repeat(free_f, 6)

    def cond(s):
        return jnp.logical_and(s.it < max_iters, jnp.logical_not(s.done))

    def body(s):
        lam = 1.0 / s.radius
        diag = jnp.clip(jnp.diagonal(s.H), _MIN_DIAG, _MAX_DIAG)
        A = s.H + jnp.diag(lam * diag)
        A = A * m[:, None] * m[None, :] + jnp.diag(1.0 - m)
        rhs = -s.g * m
        from .schur_ba import _cho_solve_equilibrated
        dx = _cho_solve_equilibrated(A, rhs) * m

        poses_new = s.poses + dx.reshape(-1, 6)
        cost_new, H_n, g_n = _assemble(poses_new, edges_i, edges_j,
                                       constraints, ev, free_f,
                                       axis_name=axis_name,
                                       huber_delta=huber_delta)

        model_change = 0.5 * (lam * jnp.sum(diag * dx * dx)
                              - jnp.sum(s.g * dx))
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
        converged = jnp.logical_and(
            accept, jnp.abs(s.cost - cost_new) <= _FUNCTION_TOL * s.cost)

        return _S(jnp.where(accept, poses_new, s.poses),
                  jnp.where(accept, cost_new, s.cost),
                  jnp.where(accept, H_n, s.H),
                  jnp.where(accept, g_n, s.g),
                  radius, dec, s.it + 1, converged)

    out = jax.lax.while_loop(cond, body, state)
    return out.poses, PGOStats(out.it, cost0, out.cost)


pose_graph_opt = jax.jit(pose_graph_opt_impl,
                         static_argnames=("max_iters", "axis_name",
                                          "huber_delta"))
