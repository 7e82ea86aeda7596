"""Image front-end end-to-end: rendered stereo frames -> detector ->
matcher -> tracks -> batch engine -> global refine -> ATE (VERDICT r3
item 6: the from-scratch front-end gets a recorded end-to-end run).

The reference never shipped its front-end (README:31-33); the only
contract is the obs-file format.  This bench closes the loop on synthetic
imagery (sim/images.py): per-frame detector+matcher wall gives the
front-end frames/s, and the tracked observations replay through the same
device pipeline as the oracle-track workloads.

Usage:  python tools/frontend_bench.py [--frames 60] [--cpu]
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
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--stride", type=int, default=1,
                    help="temporal stride over the wave trajectory")
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
    from slslam.engine.batch import BatchSlam, normalize_frames
    from slslam.engine.refine import global_refine
    from slslam.frontend.matcher import StereoLineMatcher
    from slslam.sim import house_segments, wave_trajectory
    from slslam.sim.images import StereoImageRenderer

    cfg = dataclasses.replace(
        SlamConfig(),
        compute_dtype="float64" if platform == "cpu" else "float32",
        kf_rot_thr=1e-9, kf_tr_thr=1e-9)

    segs = house_segments()
    poses_gt = wave_trajectory(num_frames=400)[::args.stride][:args.frames]
    matcher = StereoLineMatcher(cfg.camera)
    ren = StereoImageRenderer(segs, cfg.camera)

    frames = []
    t_match = 0.0
    n_obs = []
    for i, T in enumerate(poses_gt):
        img_l, img_r, _ = ren.render(T)
        t0 = time.perf_counter()
        obs = matcher.process(i, img_l, img_r)
        t_match += time.perf_counter() - t0
        frames.append(obs)
        n_obs.append(len(obs))
    fps = len(frames) / t_match if t_match else 0.0

    frames_n = normalize_frames(frames, cfg.camera)
    t0 = time.perf_counter()
    res = BatchSlam(cfg).run(frames_n)
    ref = global_refine(frames_n, res.is_kf, res.trajectory, config=cfg)
    t_slam = time.perf_counter() - t0

    kfi = np.flatnonzero(np.asarray(res.is_kf))
    T0 = poses_gt[kfi[0]] if len(kfi) else None

    def ate(traj):
        gt = [(poses_gt[i] @ T0.inv()).inv() for i in kfi]
        return float(np.mean([np.linalg.norm(a.t - b.t)
                              for a, b in zip(traj, gt)]))

    print(json.dumps({
        "platform": platform,
        "frames": len(frames),
        "frontend_fps": round(fps, 2),
        "mean_tracks_per_frame": round(float(np.mean(n_obs)), 1),
        "keyframes": res.kf_count,
        "slam_wall_s": round(t_slam, 2),
        "ate_raw_m": round(ate(res.trajectory), 4) if len(kfi) else None,
        "ate_refined_m": (round(ate(ref.trajectory), 4)
                          if len(kfi) else None),
    }))


if __name__ == "__main__":
    main()
