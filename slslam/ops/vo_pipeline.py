"""Fused visual-odometry pipeline: RANSAC + motion-only BA + final scoring.

One jitted kernel for the whole of SLAM::pose_estimation's device work
(slam.cpp:244-319): hypothesis sampling/solving/scoring (ransac.py), the
Ceres motion polish (motion_only_ba, slam.cpp:578-675) as a 2-camera
fixed-line instance of the Schur-LM solver, and the final inlier scoring
under the polished motion (slam.cpp:305-314).

Fusing lets XLA see the whole pipeline (no host round-trips between
stages), and the host pays one dispatch instead of three.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import geometry as geo
from .ransac import ransac_stage
from .residuals import score_error_hyp_obs
from .schur_ba import local_ba_impl


class VOResult(NamedTuple):
    wt: jnp.ndarray            # (6,) polished motion prev->curr
    ransac_score: jnp.ndarray  # inlier count of the RANSAC winner
    ransac_wt: jnp.ndarray     # (6,) pre-polish winner
    final_errors: jnp.ndarray  # (N,) errors under the polished motion
    num_inliers_used: jnp.ndarray


def vo_body(obs0, obs1, lines_av, valid, key, baseline, error_thr,
            huber_delta, max_t_norm=1.0, num_hyp=256, sample_size=5,
            robust=True, max_iters=10, line_param="orth", relin_iters=1):
    """Traced body of the VO solve; also reused inside the device-resident
    batch engine's scan step (engine/batch.py).  The caller thresholds
    final_errors on the host to form the final inlier set and applies the
    keyframe decision."""
    N = obs0.shape[0]
    dtype = obs0.dtype

    # ---- RANSAC: the shared stage (ops/ransac.py ransac_stage — single
    # small-angle hypotheses, guarded winner re-linearization; see its
    # docstring for the outlier-robustness measurements) ----
    rr = ransac_stage(obs0, obs1, lines_av, valid, key, baseline,
                      error_thr, max_t_norm=max_t_norm, num_hyp=num_hyp,
                      sample_size=sample_size, relin_iters=relin_iters)
    best_wt = rr.best_wt
    best_score = rr.best_score
    inliers = rr.inliers

    # ---- motion-only BA (slam.cpp:578-675): cam0 free, cam1 fixed,
    # all lines fixed, observations = inliers only (via validity mask) ----
    encoders = {"orth": geo.av_to_orth, "aid": geo.av_to_aid,
                "asd": geo.av_to_asd}
    line_orth = encoders[line_param](lines_av)
    cam = jnp.zeros((4, 6), dtype).at[0].set(best_wt)
    cam_free = jnp.array([True, False, False, False])
    obs_cat = jnp.concatenate([obs1, obs0], axis=0)
    ocam = jnp.concatenate([jnp.zeros(N, jnp.int32),
                            jnp.ones(N, jnp.int32)])
    olin = jnp.concatenate([jnp.arange(N, dtype=jnp.int32)] * 2)
    ovalid = jnp.concatenate([inliers, inliers])

    cam_out, _, _ = local_ba_impl(
        cam, line_orth, obs_cat, ocam, olin, ovalid, cam_free,
        jnp.zeros(N, bool), baseline, huber_delta,
        robust=robust, max_iters=max_iters, line_param=line_param,
        pose_only=True)
    wt = cam_out[0]

    # ---- final scoring under the polished motion (slam.cpp:305-314) ----
    Rf = geo.rodrigues(wt[None, :3])
    final_errors = score_error_hyp_obs(obs1, Rf, wt[None, 3:], lines_av,
                                       baseline)[0]

    return VOResult(wt, best_score, best_wt, final_errors,
                    jnp.sum(inliers.astype(jnp.int32)))


vo_pipeline = jax.jit(
    vo_body, static_argnames=("num_hyp", "sample_size", "robust",
                              "max_iters", "line_param", "relin_iters"))
