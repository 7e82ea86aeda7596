"""Real-sequence proxy validation (sim/street.py).

The reference's datasets were never released; these tests replay its
committed keyframe trajectories (matlab_script/traj_slslam_*_basize10_wolc
.txt, the real sequences' exact motion) through matched-scale synthetic
worlds and run the full device-resident pipeline against ground truth.
"""

import dataclasses

import numpy as np
import pytest

from slslam.config import SlamConfig
from slslam.sim.street import (OutlierInjector, SEQUENCES,
                               load_reference_poses, real_proxy_workload)

REF_DIR = "/root/reference/matlab_script"


def _cfg():
    return dataclasses.replace(SlamConfig(), compute_dtype="float64",
                               kf_rot_thr=1e-9, kf_tr_thr=1e-9)


def _ate(traj, poses_gt):
    T0 = poses_gt[0]
    return float(np.mean([np.linalg.norm(T.t - (Tg @ T0.inv()).inv().t)
                          for T, Tg in zip(traj, poses_gt)]))


def test_loader_matches_writer_roundtrip(tmp_path):
    """load_reference_poses inverts evalio.writers.write_trajectory."""
    from slslam.evalio.writers import write_trajectory

    poses_wc = load_reference_poses(
        f"{REF_DIR}/traj_slslam_itbt3f_basize10_wolc.txt")
    assert len(poses_wc) == 102          # BASELINE.md section 2
    p = tmp_path / "t.txt"
    write_trajectory(str(p), [T.inv() for T in poses_wc])
    again = load_reference_poses(str(p))
    for a, b in zip(poses_wc, again):
        np.testing.assert_allclose(a.R, b.R, atol=1e-9)
        np.testing.assert_allclose(a.t, b.t, atol=1e-9)


def test_workload_statistics_match_real_motion():
    """The proxy workload carries the real sequences' motion statistics."""
    frames, poses, segs, stats = real_proxy_workload("myungdong",
                                                     max_frames=80)
    pos = np.stack([T.inv().t for T in poses])
    d = np.linalg.norm(np.diff(pos, axis=0), axis=1)
    assert 0.6 < np.median(d) < 0.9      # the 0.75 m keyframe gate
    assert stats["obs_per_frame_min"] >= 5
    assert stats["obs_per_frame_mean"] > 20
    # track churn: lines leave the FOV and new tracks appear every frame
    assert stats["new_tracks_per_frame"] > 0.5
    assert stats["track_len_median"] >= 3


def test_outlier_injector_swaps_ids():
    rng = np.random.default_rng(0)
    obs = {i: rng.standard_normal(8) for i in range(40)}
    inj = OutlierInjector(frac=0.2, seed=1)
    out = inj(obs)
    assert set(out) == set(obs)
    moved = [i for i in obs if not np.array_equal(obs[i], out[i])]
    assert 2 <= len(moved) <= 16
    # swapped, not corrupted: every observation still present somewhere
    vals = {tuple(v) for v in obs.values()}
    assert {tuple(v) for v in out.values()} == vals


def test_full_pipeline_on_itbt3f_slice_with_outliers():
    """End-to-end stress: real itbt3f motion replayed RAW (15-degree
    keyframe jumps), occluded world, 0.5 px noise, 5% association
    outliers.  The slice crosses a sparse stretch (16-20 obs/frame)
    where RANSAC falls below the 5-inlier floor for several consecutive
    frames — without VO failure containment the replay dies there
    (kf_count 24/48, the r3 regression this test now guards): the
    recovery path (SlamConfig.vo_fail_recovery) must carry tracking
    through, and accuracy must stay bounded on the covered section."""
    from slslam.engine.batch import BatchSlam

    frames, poses_gt, segs, stats = real_proxy_workload(
        "itbt3f", max_frames=48, noise_px=0.5, outlier_frac=0.05)
    # pinned to the reference's LM cap: this test guards the VO-failure
    # recovery machinery, and on this SHORT contaminated slice the
    # default cap 50 over-fits the 5% id-swap outliers (measured:
    # 0.63 m at cap 10 vs 1.19 m at cap 50 — early stopping acts as
    # regularization here, while full sequences need the iterations;
    # see SlamConfig.max_num_iter)
    cfg = dataclasses.replace(_cfg(), max_num_iter=10)
    res = BatchSlam(cfg).run(frames)
    kfi = np.flatnonzero(res.is_kf)
    assert res.kf_count >= 33, res.kf_count
    assert kfi[-1] >= 40, "recovery must reach the end of the slice"
    T0 = poses_gt[kfi[0]]
    gt = [(poses_gt[i] @ T0.inv()).inv() for i in kfi]
    ate = float(np.mean([np.linalg.norm(a.t - b.t)
                         for a, b in zip(res.trajectory, gt)]))
    assert ate < 0.9, f"proxy ATE {ate}"

    # companion at the SHIPPED default cap (ADVICE r4): the default's
    # behavior on this contaminated short slice is also CI-guarded —
    # loosely, since cap 50 over-fits the id-swap outliers here
    # (measured 1.19 m vs 0.63 m at cap 10; the trade is documented at
    # SlamConfig.max_num_iter and in PARITY.md) — recovery must still
    # carry tracking to the end and drift must stay bounded
    res_d = BatchSlam(_cfg()).run(frames)
    kfi_d = np.flatnonzero(res_d.is_kf)
    assert res_d.kf_count >= 33, res_d.kf_count
    assert kfi_d[-1] >= 40
    gt_d = [(poses_gt[i] @ poses_gt[kfi_d[0]].inv()).inv() for i in kfi_d]
    ate_d = float(np.mean([np.linalg.norm(a.t - b.t)
                           for a, b in zip(res_d.trajectory, gt_d)]))
    assert ate_d < 2.0, f"default-cap proxy ATE {ate_d}"


def test_all_sequences_have_valid_workloads():
    for seq in SEQUENCES:
        frames, poses, segs, stats = real_proxy_workload(seq, max_frames=30)
        assert stats["obs_per_frame_min"] >= 3, (seq, stats)
        assert len(frames) == 30
