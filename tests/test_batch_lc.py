"""Loop closure on the device-resident path (engine/batch_lc.py).

The batch replay path alone cannot close loops.  These tests drive the
full deferred pipeline — batch replay -> voctree recognition -> device
relative-pose -> pose-graph stitch -> merged global refine — on the
village world, plus unit coverage of the stitch and edge-gating stages.
"""

import dataclasses

import numpy as np
import pytest

from slslam.config import SlamConfig
from slslam.engine.batch import BatchResult
from slslam.engine.batch_lc import (BatchSlamLC, _pose_graph_stitch)
from slslam.hostgeom import Pose
from slslam.loopclosure import PlaceRecognizer, VocTree, build_vocabulary
from slslam.loopclosure.voctree import VocTreeParams
from slslam.sim import (SegmentDescriptorSource, StereoLineRenderer,
                        TrackIdAssigner, village_segments,
                        village_trajectory)


def _ate(traj, gt):
    return float(np.mean([np.linalg.norm(a.t - b.t)
                          for a, b in zip(traj, gt)]))


class TestPoseGraphStitch:
    def _chain(self, K=24, drift=0.02, seed=0):
        """Odometry chain around a circle with systematic drift; ground
        truth closes the loop."""
        rng = np.random.default_rng(seed)
        gt = []
        for i in range(K):
            ang = 2 * np.pi * i / K
            gt.append(Pose(np.array([
                [np.cos(ang), 0, np.sin(ang)],
                [0, 1, 0],
                [-np.sin(ang), 0, np.cos(ang)]]),
                np.array([3 * np.sin(ang), 0.0, 3 - 3 * np.cos(ang)])))
        # noisy odometry edges C_g = T_{g+1} T_g^-1 (+ drift)
        edges = []
        for g in range(K - 1):
            rel = gt[g + 1] @ gt[g].inv()
            w = rel.wt()
            w[3:] += drift * (rng.standard_normal(3) * 0.2 + 1.0) * 0.1
            edges.append(w)
        edges = np.stack(edges)
        # integrate the noisy chain -> drifted trajectory (cam->world)
        T = Pose()
        traj = [T.inv()]
        for g in range(K - 1):
            T = Pose.from_wt(edges[g]) @ T
            traj.append(T.inv())
        gt_cw = [(g_ @ gt[0].inv()).inv() for g_ in gt]
        return gt, gt_cw, edges, traj

    def _result(self, traj, edges):
        return BatchResult(trajectory=traj, edges_wt=edges,
                           is_kf=np.ones(len(traj), bool),
                           kf_count=len(traj), landmarks=[], stats={},
                           per_frame={})

    def test_loop_edge_corrects_drift(self):
        import jax.numpy as jnp
        cfg = dataclasses.replace(SlamConfig(), compute_dtype="float64")
        # drift large enough to break the consistency check (0.75 m)
        gt, gt_cw, edges, traj = self._chain(drift=0.5)
        res = self._result(traj, edges)
        # perfect loop edge 0 -> K-1: C = T_{K-1} * T_0^-1 (gt)
        loop = [(0, len(traj) - 1, (gt[-1] @ gt[0].inv()).wt())]
        stitched, stats = _pose_graph_stitch(res, loop, cfg, jnp.float64)
        assert stats is not None, "consistency check must trigger PGO"
        assert _ate(stitched, gt_cw) < 0.5 * _ate(traj, gt_cw)

    def test_consistent_graph_skips_pgo(self):
        import jax.numpy as jnp
        cfg = dataclasses.replace(SlamConfig(), compute_dtype="float64")
        gt, gt_cw, edges, traj = self._chain(drift=0.0)
        res = self._result(traj, edges)
        loop = [(0, len(traj) - 1, (gt[-1] @ gt[0].inv()).wt())]
        stitched, stats = _pose_graph_stitch(res, loop, cfg, jnp.float64)
        assert stats is None          # slam.cpp:1215-1232 semantics
        for a, b in zip(stitched, traj):
            np.testing.assert_array_equal(a.t, b.t)


@pytest.mark.parametrize("seed", [1])
def test_village_batch_lc_end_to_end(seed):
    """Deferred LC on the batch path: >=1 accepted closure, all merges
    map to the true world segment, and the final trajectory beats the
    odometry-only replay (accuracy only; speed is measured by bench.py
    and chip_smoke.py on a GPU)."""
    cfg = dataclasses.replace(SlamConfig(), compute_dtype="float64")
    segs = village_segments(n_houses=6, ring_radius=9.0)
    poses_gt = village_trajectory(num_frames=170, arc=2.7 * np.pi,
                                  orbit_radius=3.8)
    ren = StereoLineRenderer(segs, cfg.camera, noise_px=0.3, seed=seed)
    assigner = TrackIdAssigner(max_gap=5)
    desc_src = SegmentDescriptorSource(assigner, len(segs), noise=0.01,
                                       seed=7)
    rng0 = np.random.default_rng(0)
    samples = np.concatenate([
        desc_src.base + rng0.standard_normal(
            desc_src.base.shape).astype(np.float32) * 0.02
        for _ in range(3)])
    samples /= np.linalg.norm(samples, axis=1, keepdims=True)
    vocab = build_vocabulary(samples, seed=0, kmeans_iters=2)
    params = VocTreeParams(non_consider_recent=10, consider_seq_length=4,
                           threshold=0.25, num_avg_words=30)
    frames = [assigner.assign(i, ren.observe(T))
              for i, T in enumerate(poses_gt)]

    rec = PlaceRecognizer(VocTree(vocab, params), min_matches=8,
                          min_similarity=0.8)
    eng = BatchSlamLC(cfg, recognizer=rec, descriptor_source=desc_src,
                      refine=True, refine_rounds=2)
    res = eng.run(frames)

    assert res.stats["num_loop_closures"] >= 1
    # every merged pair must identify the same physical world segment
    for a, r in res.merged_fids.items():
        assert assigner.track_to_seg[a] == assigner.track_to_seg[r]

    kfi = np.flatnonzero(res.base.is_kf)
    T0 = poses_gt[kfi[0]]
    gt_cw = [(poses_gt[i] @ T0.inv()).inv() for i in kfi]
    ate_odom = _ate(res.base.trajectory, gt_cw)
    ate_final = _ate(res.trajectory, gt_cw)
    assert ate_final < ate_odom, (ate_final, ate_odom)
