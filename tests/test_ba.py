"""Tests for the Schur-complement LM bundle adjustment kernel."""

import jax.numpy as jnp
import numpy as np
import pytest

from slslam import geometry as geo
from slslam.config import CameraConfig
from slslam.hostgeom import Pose
from slslam.ops.residuals import lba_residual, score_error
from slslam.ops.schur_ba import local_ba
from slslam.sim import StereoLineRenderer, house_segments, wave_trajectory

CAM = CameraConfig()
BL = CAM.baseline

_ENGINE_ITERS_CACHE = {}


def _engine_avg_iters(line_param, frames_n=80):
    """Batch-engine replay of the study workload; per-frame BA iteration
    stats (cached per parameterization — the compile dominates)."""
    if line_param in _ENGINE_ITERS_CACHE:
        return _ENGINE_ITERS_CACHE[line_param]
    import dataclasses
    from slslam.config import SlamConfig
    from slslam.engine.batch import BatchSlam

    cfg = dataclasses.replace(SlamConfig(), compute_dtype="float64",
                              kf_rot_thr=1e-9, kf_tr_thr=1e-9,
                              line_param=line_param)
    segs = house_segments()
    poses = wave_trajectory(num_frames=400)[:frames_n]
    ren = StereoLineRenderer(segs, cfg.camera, noise_px=0.2, seed=4)
    res = BatchSlam(cfg).run([ren.observe(T) for T in poses])
    it = res.per_frame["ba_iters"]
    out = {"avg": float(it[1:].mean()),
           "steady": float(it[frames_n // 2:].mean())}
    _ENGINE_ITERS_CACHE[line_param] = out
    return out


def make_problem(num_cams=4, noise_px=0.0, seed=0, frame_step=6):
    """Build a BA problem from the house sim with ground truth."""
    segs = house_segments()
    poses = wave_trajectory(num_frames=60)[::frame_step][:num_cams]
    ren = StereoLineRenderer(segs, CAM, noise_px=noise_px, seed=seed)

    frames = [ren.observe(T) for T in poses]
    # lines seen by >= 2 cameras
    seen = {}
    for f in frames:
        for sid in f:
            seen[sid] = seen.get(sid, 0) + 1
    lm_ids = sorted(sid for sid, c in seen.items() if c >= 2)

    # ground-truth lines in world frame (cp, dv), world = first GT camera?
    # Use the raw world frame; cameras are world->cam poses.
    gt_lines = []
    for sid in lm_ids:
        p1, p2 = segs[sid][:3], segs[sid][3:]
        v = p2 - p1
        n = np.cross(p1, p2)
        cp = np.cross(v, n) / (v @ v)
        gt_lines.append(np.concatenate([cp, v]))
    gt_lines = np.stack(gt_lines)

    obs_list, obs_cam, obs_line = [], [], []
    for ci, f in enumerate(frames):
        for li, sid in enumerate(lm_ids):
            if sid in f:
                obs_list.append(f[sid])
                obs_cam.append(ci)
                obs_line.append(li)

    cam_wt = np.stack([T.wt() for T in poses])
    return (cam_wt, gt_lines, np.stack(obs_list), np.array(obs_cam),
            np.array(obs_line), lm_ids)


class TestResidual:
    def test_zero_at_ground_truth(self):
        cam_wt, gt_lines, obs, obs_cam, obs_line, _ = make_problem()
        orth = geo.av_to_orth(jnp.asarray(gt_lines))
        r = jnp.stack([
            lba_residual(jnp.asarray(cam_wt[c]), orth[l],
                         jnp.asarray(o), BL)
            for c, l, o in zip(obs_cam, obs_line, obs)
        ])
        assert float(jnp.abs(r).max()) < 1e-9

    def test_matches_score_error(self):
        # mean |lba residuals| must equal the RANSAC scoring error for the
        # same configuration (slam.cpp:691-726 vs lba_problem.h:78-115).
        rng = np.random.default_rng(3)
        for _ in range(10):
            v = rng.standard_normal(3)
            p = rng.standard_normal(3) + np.array([0, 0, 5.0])
            cp = np.cross(v, np.cross(p, v)) / (v @ v)
            av = jnp.asarray(np.concatenate([cp, v]))
            wt = jnp.asarray(rng.standard_normal(6) * 0.1)
            obs = jnp.asarray(rng.standard_normal(8) * 0.3)
            r = lba_residual(wt, geo.av_to_orth(av), obs, BL)
            R, t = geo.wt_to_Rt(wt)
            s = score_error(obs, R, t, av, BL)
            np.testing.assert_allclose(float(jnp.mean(jnp.abs(r))), float(s),
                                       atol=1e-10)


class TestLocalBA:
    def _run(self, noise_px, cam_sigma, line_sigma, num_cams=4,
             gauge_fix=1, robust=True, max_iters=10):
        cam_wt, gt_lines, obs, obs_cam, obs_line, _ = make_problem(
            num_cams=num_cams, noise_px=noise_px, seed=1)
        rng = np.random.default_rng(42)
        L = len(gt_lines)
        O = len(obs)
        C = num_cams

        cam0 = cam_wt.copy()
        cam0[gauge_fix:] += rng.standard_normal((C - gauge_fix, 6)) * cam_sigma
        orth_gt = np.asarray(geo.av_to_orth(jnp.asarray(gt_lines)))
        orth0 = orth_gt + rng.standard_normal((L, 4)) * line_sigma

        cam_free = np.ones(C, bool)
        cam_free[:gauge_fix] = False

        cam_out, line_out, stats = local_ba(
            jnp.asarray(cam0), jnp.asarray(orth0), jnp.asarray(obs),
            jnp.asarray(obs_cam), jnp.asarray(obs_line),
            jnp.ones(O, bool), jnp.asarray(cam_free), jnp.ones(L, bool),
            BL, 1.0 / CAM.focal_length, robust=robust, max_iters=max_iters)
        return (np.asarray(cam_out), np.asarray(line_out), stats, cam_wt,
                orth_gt)

    def test_recovers_perturbed_poses_noiseless(self):
        cam, line, stats, cam_gt, orth_gt = self._run(
            noise_px=0.0, cam_sigma=0.03, line_sigma=0.01, max_iters=30)
        np.testing.assert_allclose(cam, cam_gt, atol=1e-5)
        assert float(stats.final_cost) < 1e-14
        assert float(stats.initial_cost) > 1e-4

    def test_converges_with_noise(self):
        cam, line, stats, cam_gt, orth_gt = self._run(
            noise_px=0.5, cam_sigma=0.02, line_sigma=0.005)
        # recovery is noise-limited: with 0.5 px endpoint noise the poses
        # come back to a few cm / tens of mrad, far below the 2 cm / 20 mrad
        # injected perturbation
        assert np.abs(cam - cam_gt).max() < 0.05
        assert float(stats.final_cost) < float(stats.initial_cost) * 0.5

    def test_iteration_counts_in_family(self):
        """BASELINE.md §1 (the paper's core claim): the orthonormal
        parameterization converges in ~2-6 LM iterations per windowed
        solve, where alternatives run toward the cap.

        Measured at the engine level on the study workload (house world,
        0.2 px noise, every frame a keyframe): the first ~35 solves are
        the window-filling transient (weakly observable, runs to the cap,
        like the reference's own early frames); steady state must sit in
        the 2-6 family.  The aid parameterization converges slower
        (measured steady ~5.5 vs orth ~3.2), matching the paper's
        ordering; asd diverges (experimental in the reference too,
        gc.cpp:265-356).
        """
        orth = _engine_avg_iters("orth")
        assert orth["steady"] <= 6.0, orth
        assert orth["steady"] >= 1.0, orth

    def test_orth_converges_faster_than_aid(self):
        """Param-study regression: orth needs fewer steady-state LM
        iterations than aid on the same replay (BASELINE.md §1 family
        ordering; the reference's slow param there is ancdir, which was
        never released — aid is its in-repo stand-in)."""
        orth = _engine_avg_iters("orth")
        aid = _engine_avg_iters("aid")
        assert orth["steady"] < aid["steady"], (orth, aid)

    def test_fixed_cameras_stay_fixed(self):
        cam, line, stats, cam_gt, orth_gt = self._run(
            noise_px=0.2, cam_sigma=0.02, line_sigma=0.005, gauge_fix=2)
        np.testing.assert_allclose(cam[:2], cam_gt[:2], atol=0)

    def test_all_lines_fixed_is_motion_only(self):
        # motion-only BA: lines fixed at ground truth, one free camera
        cam_wt, gt_lines, obs, obs_cam, obs_line, _ = make_problem(
            num_cams=2, noise_px=0.0, seed=2)
        rng = np.random.default_rng(7)
        orth_gt = np.asarray(geo.av_to_orth(jnp.asarray(gt_lines)))
        cam0 = cam_wt.copy()
        cam0[1] += rng.standard_normal(6) * 0.05

        cam_out, _, stats = local_ba(
            jnp.asarray(cam0), jnp.asarray(orth_gt), jnp.asarray(obs),
            jnp.asarray(obs_cam), jnp.asarray(obs_line),
            jnp.ones(len(obs), bool),
            jnp.asarray(np.array([False, True])),
            jnp.zeros(len(orth_gt), bool),
            BL, 1.0 / CAM.focal_length, robust=True, max_iters=30)
        np.testing.assert_allclose(np.asarray(cam_out)[1], cam_wt[1],
                                   atol=1e-6)

    def test_prior_edges_matches_cg_path(self):
        # the dense solver's pose-prior edges (r5, built for the
        # deferred-LC joint confirms) must agree with the CG path's
        # established prior_edges implementation on the same problem
        from slslam.ops.schur_cg import global_ba_cg, pack_line_major

        cam_wt, gt_lines, obs, obs_cam, obs_line, _ = make_problem(
            num_cams=4, noise_px=0.3, seed=6)
        rng = np.random.default_rng(8)
        L = len(gt_lines)
        orth0 = np.array(geo.av_to_orth(jnp.asarray(gt_lines)))
        orth0 += rng.standard_normal(orth0.shape) * 0.003
        cam0 = cam_wt + rng.standard_normal(cam_wt.shape) * 0.02
        cam0[0] = cam_wt[0]
        cam_free = np.array([False, True, True, True])
        # consecutive odometry-style edges with per-edge sigmas + one
        # zero-weight padding self-edge
        ei = np.array([0, 1, 2, 0], np.int32)
        ej = np.array([1, 2, 3, 0], np.int32)
        ec = np.stack([
            (Pose.from_wt(cam_wt[j]) @ Pose.from_wt(cam_wt[i]).inv()).wt()
            for i, j in zip(ei[:3], ej[:3])] + [np.zeros(6)])
        sig = np.array([[0.02, 0.1]] * 3 + [[1e9, 1e9]])

        cam_d, line_d, st_d = local_ba(
            jnp.asarray(cam0), jnp.asarray(orth0), jnp.asarray(obs),
            jnp.asarray(obs_cam), jnp.asarray(obs_line),
            jnp.ones(len(obs), bool), jnp.asarray(cam_free),
            jnp.ones(L, bool), BL, 1.0 / CAM.focal_length,
            robust=True, max_iters=25,
            prior_edges=(jnp.asarray(ei), jnp.asarray(ej),
                         jnp.asarray(ec), jnp.asarray(sig)))

        p = pack_line_major(obs, obs_cam, obs_line, 4, L)
        cam_c, line_c, st_c = global_ba_cg(
            jnp.asarray(cam0), jnp.asarray(orth0), jnp.asarray(p.obs),
            jnp.asarray(p.obs_cam), jnp.asarray(p.obs_valid),
            jnp.asarray(p.cam_perm), jnp.asarray(p.cam_perm_valid),
            jnp.asarray(cam_free), jnp.ones(L, bool),
            BL, 1.0 / CAM.focal_length, robust=True, max_iters=25,
            prior_edges=(ei, ej, ec, sig))

        # same optimum (solvers differ in path; CG is inexact by eta)
        np.testing.assert_allclose(np.asarray(cam_d), np.asarray(cam_c),
                                   rtol=1e-3, atol=5e-4)
        np.testing.assert_allclose(np.asarray(line_d), np.asarray(line_c),
                                   rtol=1e-3, atol=2e-3)
        # the prior is ACTIVE: solution differs from the prior-free one
        cam_n, _, _ = local_ba(
            jnp.asarray(cam0), jnp.asarray(orth0), jnp.asarray(obs),
            jnp.asarray(obs_cam), jnp.asarray(obs_line),
            jnp.ones(len(obs), bool), jnp.asarray(cam_free),
            jnp.ones(L, bool), BL, 1.0 / CAM.focal_length,
            robust=True, max_iters=25)
        assert np.abs(np.asarray(cam_d) - np.asarray(cam_n)).max() > 1e-7

    def test_blocked_assembly_matches_scatter(self):
        # assembly="blocked" (camera-major contiguous layout, the batch
        # engine's window packing) must reproduce the scatter assembly's
        # solution exactly up to summation order
        cam_wt, gt_lines, obs, obs_cam, obs_line, _ = make_problem(
            num_cams=3, noise_px=0.3, seed=5)
        rng = np.random.default_rng(3)
        L = len(gt_lines)
        orth0 = np.array(geo.av_to_orth(jnp.asarray(gt_lines)))
        orth0 += rng.standard_normal(orth0.shape) * 0.003
        cam0 = cam_wt + rng.standard_normal(cam_wt.shape) * 0.01
        cam0[0] = cam_wt[0]
        # re-pack into the blocked layout: C blocks of equal size
        C, Om = 3, L
        obs_b = np.zeros((C * Om, 8))
        ol_b = np.zeros(C * Om, np.int32)
        valid_b = np.zeros(C * Om, bool)
        oc_b = np.repeat(np.arange(C, dtype=np.int32), Om)
        fill = np.zeros(C, np.int32)
        for o, c, l in zip(obs, obs_cam, obs_line):
            i = c * Om + fill[c]
            fill[c] += 1
            obs_b[i], ol_b[i], valid_b[i] = o, l, True
        args = (jnp.asarray(cam0), jnp.asarray(orth0), jnp.asarray(obs_b),
                jnp.asarray(oc_b), jnp.asarray(ol_b), jnp.asarray(valid_b),
                jnp.asarray(np.array([False, True, True])),
                jnp.ones(L, bool), BL, 1.0 / CAM.focal_length)
        cam_a, line_a, st_a = local_ba(*args, assembly="scatter")
        cam_b, line_b, st_b = local_ba(*args, assembly="blocked")
        np.testing.assert_allclose(np.asarray(cam_b), np.asarray(cam_a),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(np.asarray(line_b), np.asarray(line_a),
                                   rtol=1e-6, atol=1e-9)

    def test_pose_only_mirrors_full_path(self):
        # pose_only=True claims 'identical math to the full path with
        # line_free all-False' (ops/schur_ba.py; the VO polish routes
        # through it, ops/vo_pipeline.py:68-72) — assert it directly on
        # a noisy problem rather than only via e2e ATE (ADVICE r4)
        cam_wt, gt_lines, obs, obs_cam, obs_line, _ = make_problem(
            num_cams=2, noise_px=0.4, seed=11)
        rng = np.random.default_rng(13)
        orth_gt = np.asarray(geo.av_to_orth(jnp.asarray(gt_lines)))
        cam0 = cam_wt.copy()
        cam0[1] += rng.standard_normal(6) * 0.05
        args = (jnp.asarray(cam0), jnp.asarray(orth_gt), jnp.asarray(obs),
                jnp.asarray(obs_cam), jnp.asarray(obs_line),
                jnp.ones(len(obs), bool),
                jnp.asarray(np.array([False, True])),
                jnp.zeros(len(orth_gt), bool),
                BL, 1.0 / CAM.focal_length)
        cam_full, _, stats_full = local_ba(*args, robust=True,
                                           max_iters=30)
        cam_po, _, stats_po = local_ba(*args, robust=True, max_iters=30,
                                       pose_only=True)
        np.testing.assert_allclose(np.asarray(cam_po), np.asarray(cam_full),
                                   rtol=1e-9, atol=1e-12)
        assert int(stats_po.iterations) == int(stats_full.iterations)

    def test_padding_is_inert(self):
        # padded observations/lines/cameras must not change the solution
        cam_wt, gt_lines, obs, obs_cam, obs_line, _ = make_problem(
            num_cams=3, noise_px=0.3, seed=3)
        rng = np.random.default_rng(9)
        C, L, O = 3, len(gt_lines), len(obs)
        orth_gt = np.asarray(geo.av_to_orth(jnp.asarray(gt_lines)))
        cam0 = cam_wt + rng.standard_normal((C, 6)) * 0.01
        cam0[0] = cam_wt[0]
        orth0 = orth_gt + rng.standard_normal((L, 4)) * 0.003
        cam_free = np.array([False, True, True])

        args = (jnp.asarray(cam0), jnp.asarray(orth0), jnp.asarray(obs),
                jnp.asarray(obs_cam), jnp.asarray(obs_line),
                jnp.ones(O, bool), jnp.asarray(cam_free),
                jnp.ones(L, bool))
        cam_a, line_a, stats_a = local_ba(*args, BL, 1.0 / CAM.focal_length)

        # pad: +2 cameras, +8 lines, +32 garbage observations
        Cp, Lp, Op = C + 2, L + 8, O + 32
        cam_p = np.zeros((Cp, 6)); cam_p[:C] = cam0
        orth_p = np.zeros((Lp, 4)); orth_p[:L] = orth0
        obs_p = np.zeros((Op, 8)); obs_p[:O] = obs
        oc_p = np.zeros(Op, int); oc_p[:O] = obs_cam
        ol_p = np.zeros(Op, int); ol_p[:O] = obs_line
        valid = np.zeros(Op, bool); valid[:O] = True
        cf_p = np.zeros(Cp, bool); cf_p[:C] = cam_free
        lf_p = np.zeros(Lp, bool); lf_p[:L] = True

        cam_b, line_b, stats_b = local_ba(
            jnp.asarray(cam_p), jnp.asarray(orth_p), jnp.asarray(obs_p),
            jnp.asarray(oc_p), jnp.asarray(ol_p), jnp.asarray(valid),
            jnp.asarray(cf_p), jnp.asarray(lf_p),
            BL, 1.0 / CAM.focal_length)

        np.testing.assert_allclose(np.asarray(cam_b)[:C], np.asarray(cam_a),
                                   rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(np.asarray(line_b)[:L], np.asarray(line_a),
                                   rtol=1e-7, atol=1e-9)
        assert not np.any(np.isnan(np.asarray(cam_b)))

    def test_huber_downweights_outliers(self):
        cam_wt, gt_lines, obs, obs_cam, obs_line, _ = make_problem(
            num_cams=3, noise_px=0.3, seed=4)
        rng = np.random.default_rng(11)
        # corrupt 10% of observations badly
        O = len(obs)
        idx = rng.choice(O, O // 10, replace=False)
        obs = obs.copy()
        obs[idx] += rng.standard_normal((len(idx), 8)) * 0.2

        orth_gt = np.asarray(geo.av_to_orth(jnp.asarray(gt_lines)))
        cam0 = cam_wt.copy()
        cam0[1:] += rng.standard_normal((2, 6)) * 0.01
        cam_free = np.array([False, True, True])

        def solve(robust):
            cam_out, _, _ = local_ba(
                jnp.asarray(cam0), jnp.asarray(orth_gt), jnp.asarray(obs),
                jnp.asarray(obs_cam), jnp.asarray(obs_line),
                jnp.ones(O, bool), jnp.asarray(cam_free),
                jnp.ones(len(orth_gt), bool),
                BL, 1.0 / CAM.focal_length, robust=robust, max_iters=15)
            return np.abs(np.asarray(cam_out) - cam_wt).max()

        assert solve(True) < solve(False)
