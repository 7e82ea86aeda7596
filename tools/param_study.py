"""Line-parameterization study: the reference's comp_ancdir_orthonorm analog.

Reproduces the experiment design behind
matlab_script/result_comp_ancdir_orthonorm (BASELINE.md §1): run the house
simulation across line parameterizations x noise levels x BA window sizes
and write ``ba_result_<param>_err<e>_basize<b>.txt`` files in the
reference's format (avg LM iterations / total time / avg initial cost /
avg final cost) plus ``trajectory_*.txt``.

Usage:
  python tools/param_study.py --out /tmp/study --frames 120 \
      --params orth aid --errors 0.2 0.6 --basizes 10
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_one(param, err_px, basize, frames, platform):
    import numpy as np
    from slslam.config import SlamConfig
    from slslam.engine import Slam
    from slslam.evalio.traj import ate_position_error
    from slslam.evalio.writers import trajectory_rows
    from slslam.sim import (StereoLineRenderer, house_segments,
                            wave_trajectory)

    cfg = dataclasses.replace(
        SlamConfig(),
        compute_dtype="float64" if platform == "cpu" else "float32",
        line_param=param, ba_window_size=basize)
    segs = house_segments()
    poses_gt = wave_trajectory(num_frames=frames)
    ren = StereoLineRenderer(segs, cfg.camera, noise_px=err_px, seed=4)
    slam = Slam(cfg)
    kf_frames = []
    t0 = time.time()
    for i, T in enumerate(poses_gt):
        if slam.process_frame(ren.observe(T), i):
            kf_frames.append(i)
    wall = time.time() - t0

    est = trajectory_rows(slam.trajectory())
    T0 = poses_gt[kf_frames[0]]
    gt = trajectory_rows([(poses_gt[i] @ T0.inv()).inv()
                          for i in kf_frames])
    ate = ate_position_error(est, gt)
    n = max(slam.num_frames_processed, 1)
    return {
        "avg_iters": slam.sum_num_iteration / n,
        "total_time": wall,
        "avg_init_cost": slam.sum_init_cost / n,
        "avg_final_cost": slam.sum_final_cost / n,
        "ate": ate,
        "est_rows": est,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--params", nargs="+", default=["orth", "aid"])
    ap.add_argument("--errors", nargs="+", type=float, default=[0.2])
    ap.add_argument("--basizes", nargs="+", type=int, default=[10])
    ap.add_argument("--platform", default="cpu")
    args = ap.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.platform == "cpu":
        jax.config.update("jax_enable_x64", True)
    import numpy as np

    os.makedirs(args.out, exist_ok=True)
    for param in args.params:
        for err in args.errors:
            for basize in args.basizes:
                r = run_one(param, err, basize, args.frames, args.platform)
                tag = f"{param}_err{err:.1f}_basize{basize}"
                with open(os.path.join(args.out,
                                       f"ba_result_{tag}.txt"), "w") as f:
                    f.write(f"Average number of iterations = "
                            f"{r['avg_iters']:.5f}\n")
                    f.write(f"Total time = {r['total_time']:.4f}\n")
                    f.write(f"Average initial costs = "
                            f"{r['avg_init_cost']:.6g}\n")
                    f.write(f"Average final costs = "
                            f"{r['avg_final_cost']:.6g}\n")
                np.savetxt(os.path.join(args.out, f"trajectory_{tag}.txt"),
                           r["est_rows"][:, 1:7], delimiter="\t")
                print(f"{tag}: iters {r['avg_iters']:.2f} "
                      f"time {r['total_time']:.1f}s ate {r['ate']:.4f}")


if __name__ == "__main__":
    main()
