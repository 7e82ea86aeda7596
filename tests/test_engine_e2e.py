"""End-to-end engine test on the synthetic house world.

The analog of the reference authors' simulation validation
(SURVEY.md §4): replay rendered stereo line tracks through the full
pipeline (VO -> keyframes -> triangulation -> windowed BA) and check the
estimated trajectory against ground truth with the calc_traj_err metric.
"""

import dataclasses

import numpy as np
import pytest

from slslam.config import SlamConfig
from slslam.engine import Slam
from slslam.evalio.traj import ate_position_error
from slslam.evalio.writers import trajectory_rows
from slslam.hostgeom import Pose
from slslam.sim import StereoLineRenderer, house_segments, wave_trajectory


def run_sim(num_frames=100, noise_px=0.3, seed=1, **cfg_overrides):
    cfg = dataclasses.replace(SlamConfig(), compute_dtype="float64",
                              **cfg_overrides)
    segs = house_segments()
    poses_gt = wave_trajectory(num_frames=num_frames)
    ren = StereoLineRenderer(segs, cfg.camera, noise_px=noise_px, seed=seed)
    slam = Slam(cfg)
    kf_frames = []
    for i, T in enumerate(poses_gt):
        if slam.process_frame(ren.observe(T), i):
            kf_frames.append(i)
    return slam, poses_gt, kf_frames


def gt_relative_rows(poses_gt, kf_frames):
    """GT trajectory in the engine's output frame (rooted at first KF)."""
    T0 = poses_gt[kf_frames[0]]
    rows = []
    for i in kf_frames:
        # camera-to-world in the first-KF frame:
        # T_rel = T_i * T_0^-1 maps kf0-frame -> cam_i; invert for c2w
        T_rel = poses_gt[i] @ T0.inv()
        rows.append(T_rel.inv())
    return trajectory_rows(rows)


@pytest.fixture(scope="module")
def sim_run():
    # 100 frames -> ~0.43 m / 2.7 deg per step, within the VO solver's
    # small-angle regime and the reference's |t| <= 1 hypothesis gate.
    return run_sim(num_frames=100, noise_px=0.3, seed=1)


class TestEndToEnd:
    def test_produces_keyframes(self, sim_run):
        slam, poses_gt, kf_frames = sim_run
        assert len(kf_frames) >= 10
        assert len(slam.state.kfs) == len(kf_frames)
        # odometry chain edges exist
        assert len(slam.state.edge_set) == len(kf_frames) - 1

    def test_trajectory_matches_ground_truth(self, sim_run):
        slam, poses_gt, kf_frames = sim_run
        est = trajectory_rows(slam.trajectory())
        gt = gt_relative_rows(poses_gt, kf_frames)
        ate = ate_position_error(est, gt)
        # ~19 m of travel with 0.3 px noise: windowed BA holds drift to cm
        assert ate < 0.08, f"ATE {ate}"

    def test_landmarks_have_endpoints(self, sim_run):
        slam, _, _ = sim_run
        segs = slam._landmark_world_segments(min_len=0.5)
        assert len(segs) >= 20

    def test_map_landmarks_match_world(self, sim_run):
        # mapped line segments must lie on true house lines (after alignment
        # to the first-KF frame)
        slam, poses_gt, kf_frames = sim_run
        T0 = poses_gt[kf_frames[0]]
        house = house_segments()
        segs = slam._landmark_world_segments(min_len=1.0)
        dists = []
        for s in segs:
            # transform endpoints from engine world (first-KF frame) to
            # house world
            p1 = T0.inv().R @ s[:3] + T0.inv().t
            p2 = T0.inv().R @ s[3:] + T0.inv().t
            # distance to the nearest true line
            best = np.inf
            for h in house:
                v = h[3:] - h[:3]
                vn = v / np.linalg.norm(v)
                d1 = np.linalg.norm(np.cross(p1 - h[:3], vn))
                d2 = np.linalg.norm(np.cross(p2 - h[:3], vn))
                best = min(best, max(d1, d2))
            dists.append(best)
        # majority of mapped segments within 10 cm of a true line
        assert np.median(dists) < 0.1, f"median {np.median(dists)}"

    def test_empty_frame_skipped(self):
        cfg = dataclasses.replace(SlamConfig(), compute_dtype="float64")
        slam = Slam(cfg)
        assert not slam.process_frame({}, 0)
        assert len(slam.state.kfs) == 0

    def test_stats_reported(self, sim_run):
        slam, _, _ = sim_run
        stats = slam.post_processing()
        assert stats["num_keyframes"] >= 10
        assert stats["avg_num_iterations"] > 0
        assert stats["proc_local_ba_mean_s"] > 0
