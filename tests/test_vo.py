"""Tests for the vectorized RANSAC visual odometry."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slslam import geometry as geo
from slslam.config import CameraConfig, SlamConfig
from slslam.hostgeom import Pose, line_from_pose
from slslam.ops.ransac import minimal_motion, ransac_vo
from slslam.sim import StereoLineRenderer, house_segments, wave_trajectory

CAM = CameraConfig()
CFG = SlamConfig()


def two_frame_setup(noise_px=0.0, step=4, seed=0):
    # 160-frame wave: ~0.27 m / 1.7 deg per step — the inter-frame motion
    # regime the (small-angle) reference solver is designed for.
    segs = house_segments()
    poses = wave_trajectory(num_frames=160)
    T0, T1 = poses[0], poses[step]
    ren = StereoLineRenderer(segs, CAM, noise_px=noise_px, seed=seed)
    f0, f1 = ren.observe(T0), ren.observe(T1)
    comm = sorted(set(f0) & set(f1))
    obs0 = np.stack([f0[i] for i in comm])
    obs1 = np.stack([f1[i] for i in comm])
    # landmark lines in the T0 frame (ground truth)
    lines = []
    for sid in comm:
        p1 = T0.R @ segs[sid][:3] + T0.t
        p2 = T0.R @ segs[sid][3:] + T0.t
        v = p2 - p1
        n = np.cross(p1, p2)
        cp = np.cross(v, n) / (v @ v)
        lines.append(np.concatenate([cp, v]))
    motion_gt = T1 @ T0.inv()       # T0 frame -> T1 frame
    return obs0, obs1, np.stack(lines), motion_gt, comm


class TestMinimalSolver:
    def test_recovers_small_motion(self):
        obs0, obs1, lines, motion_gt, _ = two_frame_setup(step=1)
        wt_gt = motion_gt.wt()
        # best estimate over a few random 5-samples (RANSAC does the same)
        rng = np.random.default_rng(0)
        best = None
        for _ in range(8):
            idx = rng.choice(len(obs0), 5, replace=False)
            wt, ok = minimal_motion(jnp.asarray(obs0[idx]),
                                    jnp.asarray(obs1[idx]), -CAM.baseline)
            err = np.abs(np.asarray(wt) - wt_gt).max()
            best = err if best is None else min(best, err)
        # small-angle approximation: good samples recover ~0.27 m / 1.7 deg
        # motion to a few percent
        assert best < 0.03, best


class TestRansac:
    def _run(self, noise_px, outlier_frac=0.0, step=3, seed=0):
        obs0, obs1, lines, motion_gt, comm = two_frame_setup(
            noise_px=noise_px, step=step, seed=seed)
        N = len(obs0)
        rng = np.random.default_rng(seed + 100)
        if outlier_frac > 0:
            n_out = int(N * outlier_frac)
            idx = rng.choice(N, n_out, replace=False)
            obs1 = obs1.copy()
            obs1[idx] += rng.standard_normal((n_out, 8)) * 0.1

        Nb = 128
        o0 = np.zeros((Nb, 8)); o0[:N] = obs0
        o1 = np.zeros((Nb, 8)); o1[:N] = obs1
        ln = np.zeros((Nb, 6)); ln[:, 5] = 1.0; ln[:N] = lines
        valid = np.zeros(Nb, bool); valid[:N] = True

        res = ransac_vo(jnp.asarray(o0), jnp.asarray(o1), jnp.asarray(ln),
                        jnp.asarray(valid), jax.random.PRNGKey(seed),
                        CAM.baseline, CFG.error_thr,
                        num_hyp=256, sample_size=5)
        return res, motion_gt, N

    def test_noiseless_exact(self):
        res, motion_gt, N = self._run(noise_px=0.0)
        assert int(res.best_score) > 0.8 * N
        np.testing.assert_allclose(np.asarray(res.best_wt), motion_gt.wt(),
                                   atol=0.03)

    def test_with_noise_and_outliers(self):
        res, motion_gt, N = self._run(noise_px=0.5, outlier_frac=0.3,
                                      step=2)
        assert int(res.best_score) >= 5
        # the pre-polish winner is a small-angle estimate; moBA polishes it
        # (engine test covers the full path).  Rotation is well recovered;
        # translation within the coarse-estimate band.
        np.testing.assert_allclose(np.asarray(res.best_wt)[:3],
                                   motion_gt.wt()[:3], atol=0.05)
        np.testing.assert_allclose(np.asarray(res.best_wt)[3:],
                                   motion_gt.wt()[3:], atol=0.35)
        # outliers must be excluded
        assert int(res.best_score) < N

    def test_deterministic_under_same_key(self):
        r1, _, _ = self._run(noise_px=0.3, seed=5)
        r2, _, _ = self._run(noise_px=0.3, seed=5)
        np.testing.assert_array_equal(np.asarray(r1.best_wt),
                                      np.asarray(r2.best_wt))

    def test_padding_inert(self):
        # padded entries must never be sampled or counted as inliers
        obs0, obs1, lines, motion_gt, comm = two_frame_setup(noise_px=0.2,
                                                             step=2)
        N = len(obs0)
        Nb = 256
        o0 = np.zeros((Nb, 8)); o0[:N] = obs0
        o1 = np.zeros((Nb, 8)); o1[:N] = obs1
        ln = np.zeros((Nb, 6)); ln[:, 5] = 1.0; ln[:N] = lines
        valid = np.zeros(Nb, bool); valid[:N] = True
        res_b = ransac_vo(jnp.asarray(o0), jnp.asarray(o1), jnp.asarray(ln),
                          jnp.asarray(valid), jax.random.PRNGKey(0),
                          CAM.baseline, CFG.error_thr)
        np.testing.assert_allclose(np.asarray(res_b.best_wt)[:3],
                                   motion_gt.wt()[:3], atol=0.05)
        assert not bool(np.asarray(res_b.inliers)[N:].any())
        assert int(res_b.best_score) <= N
