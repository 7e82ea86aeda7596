"""Device-resident batch engine (engine/batch.py) vs the interactive engine.

The batch engine replays a whole sequence in one lax.scan; semantics must
match the per-frame interactive engine (and through it the reference main
loop, /root/reference/src/main.cpp:45-80) up to RANSAC key schedules.
"""

import dataclasses

import numpy as np
import pytest

from slslam.config import SlamConfig
from slslam.engine import Slam
from slslam.engine.batch import BatchSlam, pack_frames
from slslam.sim import StereoLineRenderer, house_segments, wave_trajectory


def _house_frames(n, noise=0.2, seed=4, cfg=None):
    cfg = cfg or SlamConfig()
    segs = house_segments()
    poses = wave_trajectory(num_frames=400)[:n]
    ren = StereoLineRenderer(segs, cfg.camera, noise_px=noise, seed=seed)
    return [ren.observe(T) for T in poses], poses


@pytest.fixture(scope="module")
def cfg():
    return dataclasses.replace(
        SlamConfig(), compute_dtype="float64",
        kf_rot_thr=1e-9, kf_tr_thr=1e-9)


@pytest.fixture(scope="module")
def house_run(cfg):
    frames, poses = _house_frames(40)
    eng = BatchSlam(cfg)
    res = eng.run(frames)
    slam = Slam(cfg)
    for i, f in enumerate(frames):
        slam.process_frame(f, i)
    return frames, poses, res, slam


class TestPackFrames:
    def test_slot_stability(self):
        frames = [{1: np.zeros(8), 2: np.ones(8)},
                  {2: np.ones(8), 3: np.full(8, 2.0)}]
        pack = pack_frames(frames)
        # feature 2 keeps its slot across frames
        s2_f0 = pack.slot[0][np.where(pack.obs[0, :, 0] == 1.0)[0][0]]
        s2_f1 = pack.slot[1][np.where(pack.obs[1, :, 0] == 1.0)[0][0]]
        assert s2_f0 == s2_f1
        assert pack.num_slots == 3

    def test_slot_recycling(self):
        # two features with disjoint live ranges share a slot
        F = 200
        frames = [{} for _ in range(F)]
        frames[0][10] = np.zeros(8)
        frames[199][20] = np.zeros(8)
        pack = pack_frames(frames, lifetime=10)
        assert pack.num_slots == 1
        assert pack.retire_valid.any()

    def test_no_recycling_while_live(self):
        frames = [{1: np.zeros(8), 2: np.ones(8)} for _ in range(50)]
        pack = pack_frames(frames, lifetime=10)
        assert pack.num_slots == 2
        assert not pack.retire_valid.any()  # live until the end


class TestBatchVsInteractive:
    def test_same_keyframes(self, house_run):
        frames, _, res, slam = house_run
        assert res.kf_count == len(slam.state.kfs)
        assert bool(res.is_kf.all())

    def test_trajectory_agreement(self, house_run):
        """Different RANSAC key schedules -> small numeric divergence, but
        the trajectories must agree to well under the observation noise
        scale accumulated over the run."""
        _, _, res, slam = house_run
        ti = slam.trajectory()
        tb = res.trajectory
        assert len(ti) == len(tb)
        d = [np.linalg.norm(a.t - b.t) for a, b in zip(ti, tb)]
        assert np.mean(d) < 0.2
        # rotation agreement
        for a, b in zip(ti, tb):
            cos = (np.trace(a.R.T @ b.R) - 1.0) / 2.0
            assert np.arccos(np.clip(cos, -1, 1)) < 0.1

    def test_ate_parity(self, house_run):
        """Both engines track the ground-truth wave to similar accuracy."""
        _, poses, res, slam = house_run

        def ate(traj):
            err = []
            for T_est, T_gt in zip(traj, poses):
                # ground truth poses are world->cam; estimated trajectory is
                # cam->world rooted at KF0. Compare relative to frame 0.
                T0 = poses[0]
                gt_cw = (T_gt @ T0.inv()).inv()
                err.append(np.linalg.norm(T_est.t - gt_cw.t))
            return float(np.mean(err))

        ai = ate(slam.trajectory())
        ab = ate(res.trajectory)
        assert ab < max(2.0 * ai, 0.05)

    def test_landmark_counts(self, house_run):
        _, _, res, slam = house_run
        assert res.stats["num_landmarks"] == len(slam.state.lms)
        twice_b = sum(1 for lm in res.landmarks if lm.twice_observed)
        twice_i = sum(1 for lm in slam.state.lms.values()
                      if lm.twice_observed)
        assert twice_b == twice_i

    def test_world_segments(self, house_run):
        """Mapped segments land near the true house geometry."""
        _, poses, res, slam = house_run
        segs = res.world_segments(min_len=0.5)
        assert len(segs) > 20
        gt = house_segments()
        gt_pts = np.concatenate([np.asarray(gt)[:, :3],
                                 np.asarray(gt)[:, 3:]])
        # world frame of the run is KF0's camera = poses[0]; move ground
        # truth into it
        T0 = poses[0]
        gt_cam0 = (T0.R @ gt_pts.T).T + T0.t
        for s in segs[:10]:
            for p in (s[:3], s[3:]):
                dmin = np.min(np.linalg.norm(gt_cam0 - p, axis=1))
                assert dmin < 1.5


class TestBatchEdgeCases:
    def test_empty_frames_skipped(self, cfg):
        frames, _ = _house_frames(12)
        frames[3] = {}
        frames[7] = {}
        eng = BatchSlam(cfg)
        res = eng.run(frames)
        assert not res.is_kf[3] and not res.is_kf[7]
        assert res.kf_count == 10

    def test_keyframe_gating(self):
        """With real thresholds, slow motion is gated exactly as in the
        interactive engine."""
        cfg = dataclasses.replace(SlamConfig(), compute_dtype="float64")
        frames, _ = _house_frames(30)
        eng = BatchSlam(cfg)
        res = eng.run(frames)
        slam = Slam(cfg)
        for i, f in enumerate(frames):
            slam.process_frame(f, i)
        assert res.kf_count == len(slam.state.kfs)

    def test_deterministic(self, cfg):
        frames, _ = _house_frames(15)
        eng = BatchSlam(cfg)
        r1 = eng.run(frames)
        r2 = eng.run(frames)
        for a, b in zip(r1.trajectory, r2.trajectory):
            np.testing.assert_array_equal(a.t, b.t)

    def test_retirement_emission(self, cfg):
        """Track-id churn: half the features are re-keyed mid-run; the dead
        tracks retire, their slots recycle, and all generations are still
        reported."""
        frames, _ = _house_frames(100)
        # re-key the odd feature ids after frame 60 (VO survives on evens)
        frames = [({(fid + 10000 if fid % 2 else fid): o
                    for fid, o in fr.items()} if i >= 60 else fr)
                  for i, fr in enumerate(frames)]
        eng = BatchSlam(cfg)
        res = eng.run(frames, lifetime=25)
        pack = pack_frames(frames, lifetime=25)
        assert pack.retire_valid.any()          # recycling exercised
        assert res.kf_count == 100
        n_feat = len({fid for fr in frames for fid in fr})
        assert res.stats["num_landmarks"] == n_feat
