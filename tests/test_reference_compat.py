"""Drop-in compatibility with the reference's committed artifacts.

The real datasets are not shipped, but the reference repo commits result
trajectories (matlab_script/traj_*.txt) — these tests prove our IO layer
reads them and our writers produce byte-compatible structure, so the MATLAB
evaluation scripts and our eval module are interchangeable.
"""

import os

import numpy as np
import pytest

from slslam.evalio.traj import (ate_matlab_literal, ate_position_error,
                                load_trajectory)
from slslam.evalio.writers import trajectory_rows, write_trajectory
from slslam.hostgeom import Pose, rodrigues

REF = "/root/reference/matlab_script"

needs_ref = pytest.mark.skipif(not os.path.isdir(REF),
                               reason="reference not mounted")


@needs_ref
class TestReferenceTrajectories:
    def test_loads_all_committed_trajectories(self):
        for seq in ("itbt3f", "olympic4f", "myungdong"):
            for lc in ("wolc", "wlc"):
                t = load_trajectory(
                    f"{REF}/traj_slslam_{seq}_basize10_{lc}.txt")
                assert t.ndim == 2 and t.shape[1] == 7
                # first row is the origin keyframe
                np.testing.assert_allclose(t[0, 1:], 0.0, atol=1e-12)
                # index column is 0..N-1
                np.testing.assert_array_equal(t[:, 0], np.arange(len(t)))

    def test_keyframe_counts_match_baseline(self):
        # BASELINE.md §2 row counts
        expected = {("itbt3f", "wolc"): 102, ("itbt3f", "wlc"): 109,
                    ("olympic4f", "wolc"): 310, ("olympic4f", "wlc"): 319,
                    ("myungdong", "wolc"): 253, ("myungdong", "wlc"): 261}
        for (seq, lc), n in expected.items():
            t = load_trajectory(f"{REF}/traj_slslam_{seq}_basize10_{lc}.txt")
            assert len(t) == n, (seq, lc, len(t))

    def test_slslam_vs_scavislam_comparative_ate(self):
        # the reference's own evaluation is comparative plotting vs
        # ScaViSLAM; our metric must produce finite, plausible numbers on
        # those exact files
        a = load_trajectory(f"{REF}/traj_slslam_itbt3f_basize10_wolc.txt")
        b = load_trajectory(f"{REF}/traj_scavislam_itbt3f_wolc.txt")
        ate = ate_position_error(a, b)
        assert np.isfinite(ate)
        assert 0.0 < ate < 50.0

    def test_sim_result_files_parse(self):
        d = f"{REF}/result_comp_ancdir_orthonorm"
        t = load_trajectory(
            f"{d}/trajectory_orthonorm_err0.2_basize10_maxnumiter10.txt")
        assert t.shape == (400, 6)
        ate = ate_matlab_literal(t, t)
        assert ate == 0.0


class TestWriterFormat:
    def test_writer_matches_reference_layout(self, tmp_path):
        rng = np.random.default_rng(0)
        poses = [Pose(rodrigues(rng.standard_normal(3) * 0.2),
                      rng.standard_normal(3)) for _ in range(5)]
        p = str(tmp_path / "traj.txt")
        write_trajectory(p, poses)
        t = load_trajectory(p)
        assert t.shape == (5, 7)
        rows = trajectory_rows(poses)
        np.testing.assert_allclose(t, rows, atol=1e-12)
        # axis remap semantics (slam.cpp:1492-1493): row = i, t_z, -t_x, -t_y
        np.testing.assert_allclose(t[2, 1], poses[2].t[2], atol=1e-12)
        np.testing.assert_allclose(t[2, 2], -poses[2].t[0], atol=1e-12)
        np.testing.assert_allclose(t[2, 3], -poses[2].t[1], atol=1e-12)
