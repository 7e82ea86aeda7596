"""Checkpoint/resume: a resumed run must continue identically."""

import dataclasses

import numpy as np

from slslam.checkpoint import load_checkpoint, save_checkpoint
from slslam.config import SlamConfig
from slslam.engine import Slam
from slslam.evalio.writers import trajectory_rows
from slslam.sim import StereoLineRenderer, house_segments, wave_trajectory


def test_save_load_resume(tmp_path):
    cfg = dataclasses.replace(SlamConfig(), compute_dtype="float64")
    segs = house_segments()
    poses = wave_trajectory(num_frames=40)
    ren = StereoLineRenderer(segs, cfg.camera, noise_px=0.3, seed=1)
    frames = [ren.observe(T) for T in poses]

    # run A: all frames straight through
    slam_a = Slam(cfg)
    for i, obs in enumerate(frames):
        slam_a.process_frame(obs, i)

    # run B: checkpoint at frame 20, resume into a fresh engine
    slam_b = Slam(cfg)
    for i in range(20):
        slam_b.process_frame(frames[i], i)
    ckpt = str(tmp_path / "ckpt.npz")
    save_checkpoint(slam_b, ckpt)

    slam_c = Slam(cfg)
    load_checkpoint(slam_c, ckpt)
    # resumed state equals the donor state
    assert len(slam_c.state.kfs) == len(slam_b.state.kfs)
    assert len(slam_c.state.lms) == len(slam_b.state.lms)
    assert slam_c.state.edge_set == slam_b.state.edge_set
    for k in slam_b.state.lms:
        np.testing.assert_array_equal(slam_c.state.lms[k].line,
                                      slam_b.state.lms[k].line)
        assert (slam_c.state.lms[k].obs_vec[0][0]
                == slam_b.state.lms[k].obs_vec[0][0])

    for i in range(20, 40):
        slam_c.process_frame(frames[i], i)

    # identical trajectories (same RNG key stream + same state)
    traj_a = trajectory_rows(slam_a.trajectory())
    traj_c = trajectory_rows(slam_c.trajectory())
    assert len(traj_a) == len(traj_c)
    np.testing.assert_allclose(traj_c, traj_a, atol=1e-9)
