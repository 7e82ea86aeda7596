"""Real-sequence proxy validation: the reference's it(bt)3f / olympic4f /
myungdong keyframe motions replayed through matched-scale synthetic worlds.

The real datasets were never released; their committed keyframe
trajectories (matlab_script/traj_slslam_*_basize10_wolc.txt) are replayed
as exact ground-truth motion through corridor/street line worlds at each
sequence's scale (slslam/sim/street.py), with realistic track churn and
optional association outliers.  The full device-resident pipeline (batch
replay -> windowed Schur-LM BA -> global refine) runs on each and reports
ATE vs ground truth — the end-to-end validation the missing datasets
otherwise prevent.

Usage:
    python tools/real_proxy.py                     # all three, CPU f64
    python tools/real_proxy.py --seq myungdong --outlier-frac 0.05
    python tools/real_proxy.py --device            # default JAX device, f32
Prints one JSON line per sequence.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def run_sequence(seq, args):
    from slslam.config import SlamConfig
    from slslam.engine.batch import BatchSlam
    from slslam.engine.refine import global_refine
    from slslam.sim.street import real_proxy_workload

    import jax
    platform = jax.devices()[0].platform
    interp = not args.no_interp
    over = {}
    if args.max_num_iter:
        # the reference's own benchmark sweeps --max_num_iter in {10,
        # 1000} (ba_result_* files); 10 underconverges the windowed BA
        # on dense outdoor windows (avg iterations pinned at the cap)
        over["max_num_iter"] = args.max_num_iter
    if interp:
        # video-rate replay: the engine runs its own keyframe gates
        # (15 deg / 0.75 m, the reference's; slam.cpp:1374-1382)
        cfg = dataclasses.replace(
            SlamConfig(),
            compute_dtype="float64" if platform == "cpu" else "float32",
            **over)
    else:
        # raw keyframe replay: every input pose IS a keyframe
        cfg = dataclasses.replace(
            SlamConfig(),
            compute_dtype="float64" if platform == "cpu" else "float32",
            kf_rot_thr=1e-9, kf_tr_thr=1e-9, **over)

    from slslam.sim.tracks import TrackIdAssigner
    assigner = TrackIdAssigner(max_gap=5)
    frames, poses_gt, segs, stats = real_proxy_workload(
        seq, max_frames=args.max_frames, noise_px=args.noise_px,
        outlier_frac=args.outlier_frac, seed=args.seed, interpolate=interp,
        assigner=assigner)

    lc_res = None
    t0 = time.perf_counter()
    if args.lc:
        # wlc configuration: all three sequences return to their start
        # (closest early/late revisit 0.6-4.8 m) — the reason the
        # reference publishes wlc trajectories (BASELINE.md section 2)
        from slslam.engine.batch_lc import BatchSlamLC
        from slslam.loopclosure import (PlaceRecognizer, VocTree,
                                        build_vocabulary)
        from slslam.loopclosure.voctree import VocTreeParams
        from slslam.sim.tracks import SegmentDescriptorSource

        desc_src = SegmentDescriptorSource(assigner, len(segs), noise=0.01,
                                           seed=args.seed + 7)
        rng0 = np.random.default_rng(0)
        samples = np.concatenate([
            desc_src.base + rng0.standard_normal(
                desc_src.base.shape).astype(np.float32) * 0.02
            for _ in range(4)])
        samples /= np.linalg.norm(samples, axis=1, keepdims=True)
        vocab = build_vocabulary(samples, seed=0, kmeans_iters=2)
        params = VocTreeParams(non_consider_recent=30,
                               consider_seq_length=4, threshold=0.25,
                               num_avg_words=30)
        rec = PlaceRecognizer(VocTree(vocab, params), min_matches=8,
                              min_similarity=0.8)
        eng = BatchSlamLC(cfg, recognizer=rec, descriptor_source=desc_src,
                          refine=True, refine_rounds=args.refine_rounds)
        lc_res = eng.run(frames)
        res, traj_final = lc_res.base, lc_res.trajectory
    else:
        eng = BatchSlam(cfg)
        res = eng.run(frames)
        ref = global_refine(frames, res.is_kf, res.trajectory, config=cfg)
        traj_final = ref.trajectory
    wall = time.perf_counter() - t0

    kf_idx = np.flatnonzero(np.asarray(res.is_kf))

    def ate(traj):
        T0 = poses_gt[kf_idx[0]]
        gt = [(poses_gt[i] @ T0.inv()).inv() for i in kf_idx]
        return float(np.mean([np.linalg.norm(T.t - g.t)
                              for T, g in zip(traj, gt)]))

    path_len = float(np.sum(np.linalg.norm(
        np.diff(np.stack([T.inv().t for T in poses_gt]), axis=0), axis=1)))
    out = dict(stats)
    out.update(
        platform=platform,
        keyframes=res.kf_count,
        path_len_m=round(path_len, 1),
        wall_s=round(wall, 2),
        ate_raw_m=round(ate(res.trajectory), 4),
        ate_refined_m=round(ate(traj_final), 4),
        ate_refined_pct_of_path=round(
            100.0 * ate(traj_final) / path_len, 3),
        avg_ba_iterations=round(res.stats["avg_num_iterations"], 2),
    )
    if lc_res is not None:
        out.update(
            num_loop_candidates=lc_res.stats.get("num_loop_candidates"),
            num_loop_spans=lc_res.stats.get("num_loop_spans"),
            num_loop_closures=lc_res.stats["num_loop_closures"],
            num_merged_tracks=lc_res.stats["num_merged_tracks"],
            refine_pick=lc_res.stats.get("refine_pick"),
            refine_loop_frac=lc_res.stats.get("refine_loop_frac"),
            recognizer=dict(getattr(eng.recognizer, "stats", {})),
        )
    print(json.dumps(out))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", default=None,
                    help="itbt3f / olympic4f / myungdong (default: all)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--noise-px", type=float, default=0.5)
    ap.add_argument("--outlier-frac", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", action="store_true",
                    help="run on the default JAX device (a GPU) in f32")
    ap.add_argument("--max-num-iter", type=int, default=0,
                    help="windowed-BA LM iteration cap (reference sweeps "
                         "10 and 1000; 0 = config default)")
    ap.add_argument("--no-interp", action="store_true",
                    help="replay raw keyframe poses (15-degree jumps at "
                         "corners) instead of video-rate interpolation")
    ap.add_argument("--lc", action="store_true",
                    help="wlc configuration: voctree place recognition + "
                         "loop closure + PGO + merged global refine")
    ap.add_argument("--refine-rounds", type=int, default=2,
                    help="global-refine rounds on the wlc path (the wolc "
                         "path's global_refine default is 2)")
    args = ap.parse_args(argv)

    import jax
    if not args.device:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    from slslam.sim.street import SEQUENCES
    seqs = [args.seq] if args.seq else list(SEQUENCES)
    for seq in seqs:
        run_sequence(seq, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
