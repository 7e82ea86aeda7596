"""1000-keyframe deferred-LC scale evidence.

Generates a long multi-revisit synthetic (several drifting orbits of the
village world, so recognition keeps firing on every pass), runs the full
deferred pipeline (BatchSlamLC: replay scan + one-scan voctree recognition
+ batched span solves + PGO + merged refine) end-to-end, and records the
wall breakdown, peak device memory, and the recognition-scan cost curve
vs timeline length K.

Usage:
    python tools/scale_lc.py                 # the default JAX device
    python tools/scale_lc.py --cpu --frames 400
Prints one JSON line.
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--orbits", type=float, default=3.35,
                    help="orbit turns (every pass past the first revisits)")
    ap.add_argument("--no-prefixes", action="store_true",
                    help="skip the recognition-cost-vs-K prefix curve")
    args = ap.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    else:
        from slslam.utils.compcache import enable_persistent_cache
        enable_persistent_cache()
    platform = jax.devices()[0].platform

    from slslam.config import SlamConfig
    from slslam.engine.batch_lc import BatchSlamLC
    from slslam.loopclosure import VocTree, build_vocabulary
    from slslam.loopclosure.batch import (BatchPlaceRecognizer,
                                          recognize_sequence)
    from slslam.loopclosure.voctree import VocTreeParams
    from slslam.sim import (SegmentDescriptorSource, StereoLineRenderer,
                            TrackIdAssigner, village_segments,
                            village_trajectory)

    cfg = dataclasses.replace(
        SlamConfig(),
        compute_dtype="float64" if platform == "cpu" else "float32",
        kf_rot_thr=1e-9, kf_tr_thr=1e-9,
        # workload-sized obs bucket (74 obs/frame -> 80, not 128: fewer
        # padded rows per LM op; sim/workloads.py rationale); small
        # leading entries preserved for the confirm stages' per-span
        # problems
        obs_buckets=(64, 80, 128, 256, 512, 1024, 2048))

    segs = village_segments(n_houses=6, ring_radius=9.0)
    poses_gt = village_trajectory(num_frames=args.frames,
                                  arc=args.orbits * np.pi,
                                  orbit_radius=3.8)
    ren = StereoLineRenderer(segs, cfg.camera, noise_px=0.3, seed=1)
    assigner = TrackIdAssigner(max_gap=5)
    desc_src = SegmentDescriptorSource(assigner, len(segs), noise=0.01,
                                       seed=7)
    frames = [assigner.assign(i, ren.observe(T))
              for i, T in enumerate(poses_gt)]

    rng0 = np.random.default_rng(0)
    samples = np.concatenate([
        desc_src.base + rng0.standard_normal(
            desc_src.base.shape).astype(np.float32) * 0.02
        for _ in range(3)])
    samples /= np.linalg.norm(samples, axis=1, keepdims=True)
    vocab = build_vocabulary(samples, seed=0, kmeans_iters=2)
    params = VocTreeParams(non_consider_recent=10, consider_seq_length=4,
                           threshold=0.25, num_avg_words=30)

    def mem_peak():
        try:
            st = jax.devices()[0].memory_stats()
            return round(st.get("peak_bytes_in_use", 0) / 2**20, 1)
        except Exception:
            return None

    tree = VocTree(vocab, params)
    rec = BatchPlaceRecognizer(tree, min_matches=8, min_similarity=0.8)
    eng = BatchSlamLC(cfg, recognizer=rec, descriptor_source=desc_src,
                      refine=True, refine_rounds=2,
                      overlap_descriptors=True)
    t0 = time.perf_counter()
    res = eng.run(frames)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec2 = BatchPlaceRecognizer(VocTree(vocab, params), min_matches=8,
                                min_similarity=0.8)
    eng2 = BatchSlamLC(cfg, recognizer=rec2, descriptor_source=desc_src,
                       refine=True, refine_rounds=2,
                       overlap_descriptors=True)
    res = eng2.run(frames)
    warm_s = time.perf_counter() - t0

    kfi = np.flatnonzero(np.asarray(res.base.is_kf))
    T0 = poses_gt[kfi[0]]
    gt = [(poses_gt[i] @ T0.inv()).inv() for i in kfi]

    def ate(traj):
        return float(np.mean([np.linalg.norm(a.t - b.t)
                              for a, b in zip(traj, gt)]))

    # recognition-scan cost curve vs K (warm timings, one scan each)
    prefix_walls = {}
    if not args.no_prefixes:
        kf_descs = [desc_src(int(f), sorted(frames[f])) for f in kfi]
        for K in (len(kfi) // 4, len(kfi) // 2, len(kfi)):
            recognize_sequence(tree, kf_descs[:K])          # compile
            t0 = time.perf_counter()
            recognize_sequence(tree, kf_descs[:K])
            prefix_walls[K] = round(time.perf_counter() - t0, 3)

    print(json.dumps({
        "platform": platform,
        "frames": args.frames,
        "keyframes": res.base.kf_count,
        "cold_s": round(cold_s, 1),
        "warm_s": round(warm_s, 2),
        "kf_per_s_warm": round(res.base.kf_count / warm_s, 1),
        "num_loop_candidates": res.stats["num_loop_candidates"],
        "num_loop_spans": res.stats["num_loop_spans"],
        "num_loop_closures": res.stats["num_loop_closures"],
        "num_merged_tracks": res.stats["num_merged_tracks"],
        "ate_odometry_m": round(ate(res.base.trajectory), 4),
        "ate_final_m": round(ate(res.trajectory), 4),
        "wall_breakdown": {k: res.stats.get(k) for k in
                           ("wall_replay_s", "wall_recognition_s",
                            "wall_span_rounds_s",
                            "wall_joint_confirm_s", "num_joint_solves",
                            "wall_pgo_s", "wall_refine_s")},
        "recognition_scan_wall_by_K": prefix_walls,
        "peak_hbm_mib": mem_peak(),
    }))


if __name__ == "__main__":
    main()
