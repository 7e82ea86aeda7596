"""Benchmark: end-to-end keyframe throughput on the house simulation.

Prints ONE JSON line:
  {"metric": "keyframes_per_s", "value": N, "unit": "kf/s", "vs_baseline": R}

Baseline: the reference's own simulation benchmark — 400 keyframes in
35.85 s (orthonormal parameterization, basize 10, single CPU core;
/root/reference/matlab_script/result_comp_ancdir_orthonorm/
ba_result_orthonorm_err0.2_basize10_maxnumiter1000.txt line 2 and the
400-row trajectory file) = 11.16 kf/s.  The workload matches that setup:
every frame a keyframe, ~70 line landmarks, basize 10, 0.2 px observation
noise, full VO + windowed Schur-LM BA per frame.

Headline path: the device-resident batch engine (engine/batch.py) — the
whole replay as one lax.scan, zero per-frame host round trips; identical
per-frame math to the interactive engine (cross-checked in
tests/test_batch_engine.py).  All 5 render seeds are packed and
dispatched up front so the in-order device queue runs them back-to-back.
Set BENCH_MODE=interactive to measure the per-frame host-loop engine
instead, BENCH_MODE=lc for the loop-closure workload alone, and
BENCH_MANY=vmap for the vmapped-lanes variant of the batch mode.  In
batch mode the loop-closure measurement is appended as a stderr
lc_keyframes_per_s line when budget remains.

It runs on a GPU only and names the device on every line; any failure
exits nonzero.  BENCH_BUDGET_S bounds the warm repetitions.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import numpy as np

BASELINE_KF_PER_S = 400.0 / 35.85
TOTAL_BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", 480))
MODE = os.environ.get("BENCH_MODE", "batch")


def device_fields():
    import jax
    devices = jax.devices()
    return {"platform": devices[0].platform,
            "device_kind": devices[0].device_kind,
            "device_count": len(devices)}


def emit(value, vs, extra):
    print(json.dumps({**device_fields(), **extra}), file=sys.stderr)
    print(json.dumps({
        "metric": "keyframes_per_s",
        "value": round(value, 3),
        "unit": "kf/s",
        "vs_baseline": round(vs, 3),
        **device_fields(),
    }))


def bench_batch(t_start):
    """Whole-sequence replay + global refine for 5 render seeds: all
    replays packed and dispatched up front so the in-order device queue
    runs them back-to-back, refines overlapping the later scans.  ATE is
    reported worst-case across seeds; each seed is a fully independent
    solve.  BENCH_MANY=vmap runs the 5 seeds as one vmapped scan
    (engine/batch.py dispatch_many)."""
    from slslam.engine.batch import BatchSlam
    from slslam.engine.refine import global_refine
    from slslam.hostgeom import Pose
    from slslam.sim.workloads import (house_replay, house_replay_config,
                                      rooted_ate)

    num_frames = 400  # the reference benchmark's own length
    seeds = [4, 5, 6, 7, 8]
    cfg = house_replay_config("float32")
    workloads = [house_replay(cfg, num_frames, seed=s) for s in seeds]
    seq_list = [w[0] for w in workloads]
    eng = BatchSlam(cfg)

    # the refine solve's shapes depend only on (frames, is_kf); every
    # frame becomes a keyframe here, so the refine compiles SPECULATIVELY
    # on a thread (identity trajectories, result discarded) while the
    # main thread compiles the replay scan
    def _warm_refine():
        global_refine(seq_list[0], np.ones(num_frames, bool),
                      [Pose() for _ in seq_list[0]], config=cfg)

    use_vmap = os.environ.get("BENCH_MANY") == "vmap"

    def one_pass():
        t0 = time.perf_counter()
        if use_vmap:
            handle = eng.dispatch_many(seq_list)
            t_disp = time.perf_counter() - t0
            results = eng.collect_many(handle)
            t_scan = time.perf_counter() - t0
            refs = [global_refine(seq_list[i], r.is_kf, r.trajectory,
                                  config=cfg, rounds=3)
                    for i, r in enumerate(results)]
            return results, refs, {
                "host_pack_s": round(t_disp, 3),
                "scan_s": round(t_scan - t_disp, 3),
                "refine_s": round(time.perf_counter() - t0 - t_scan, 3),
            }
        handles = [eng.dispatch(s) for s in seq_list]
        t_disp = time.perf_counter() - t0
        results, refs, busy = [], [], []
        for i, h in enumerate(handles):
            t1 = time.perf_counter()
            r = eng.collect(h)
            results.append(r)
            # rounds=3: at the default 2 a weak-mode seed's f32 refine is
            # run-to-run chaotic; the third re-init round settles it
            refs.append(global_refine(seq_list[i], r.is_kf,
                                      r.trajectory, config=cfg,
                                      rounds=3))
            busy.append(round(time.perf_counter() - t1, 3))
        return results, refs, {
            "host_pack_s": round(t_disp, 3),
            "per_seed_busy_s": busy,
            "total_s": round(time.perf_counter() - t0, 3),
        }

    t0 = time.perf_counter()
    warm_t = threading.Thread(target=_warm_refine, daemon=True)
    warm_t.start()
    results, refs, tm0 = one_pass()
    cold_s = time.perf_counter() - t0
    warm_t.join()
    if results[0].kf_count == 0:
        raise RuntimeError("the replay produced no keyframes")

    # warm passes: the full pipeline repeated (3 reps when budget
    # allows), each ONE wall
    walls, passes = [], []
    est = 0.15 * cold_s + 10.0
    while (time.perf_counter() - t_start) + est < TOTAL_BUDGET_S \
            and len(walls) < 3:
        t0 = time.perf_counter()
        results, refs, tm = one_pass()
        walls.append(time.perf_counter() - t0)
        passes.append(tm)
        est = 1.1 * min(walls)

    total_kf = sum(r.kf_count for r in results)
    if walls:
        wall = min(walls)
    else:
        wall, passes = cold_s, [tm0]
    per_seed = {}
    for i, s in enumerate(seeds):
        kfi = np.flatnonzero(results[i].is_kf)
        poses_gt = workloads[i][1]
        per_seed[s] = {
            "kf": results[i].kf_count,
            "ate_raw": round(rooted_ate(results[i].trajectory, poses_gt,
                                        kfi), 4),
            "ate_refined": round(rooted_ate(refs[i].trajectory, poses_gt,
                                            kfi), 4),
        }
    kf_per_s = total_kf / wall
    emit(kf_per_s, kf_per_s / BASELINE_KF_PER_S, {
        "mode": "batch+refine (vmapped seeds)" if use_vmap
                else "batch+refine (async-queued seeds)",
        "seeds_measured": len(seeds),
        "keyframes_per_run": results[0].kf_count,
        "cold_s": round(cold_s, 2),
        "warm_walls_s": [round(w, 3) for w in walls],
        "wall_breakdown": passes,
        "worst_seed_ate_refined_m": max(r["ate_refined"]
                                        for r in per_seed.values()),
        "worst_seed_ate_raw_m": max(r["ate_raw"]
                                    for r in per_seed.values()),
        "per_seed": per_seed,
        "avg_ba_iterations": round(
            float(np.mean([r.stats["avg_num_iterations"]
                           for r in results])), 2),
        "num_landmarks": results[0].stats["num_landmarks"],
    })


def bench_lc(t_start, as_extra=False):
    """Loop-closure workload on the device-resident path
    (slslam/sim/workloads.py village_lc).

    as_extra=True (batch mode's appended measurement): the result goes to
    stderr as a ``lc_keyframes_per_s`` JSON line, so the batch headline
    stays the parsed metric."""
    from slslam.sim.workloads import rooted_ate, village_lc

    # kf gates ~0 -> every frame a KF: the overlapped all-frames
    # descriptor stream is identical to the default kf-only one, and the
    # host work hides behind the replay scan
    w = village_lc("float32", overlap_descriptors=True)

    t0 = time.perf_counter()
    res = w.make_engine().run(w.frames)
    cold_s = time.perf_counter() - t0

    walls = []
    est = 0.3 * cold_s + 10.0
    while (time.perf_counter() - t_start) + est < TOTAL_BUDGET_S \
            and len(walls) < 3:
        t0 = time.perf_counter()
        res = w.make_engine().run(w.frames)
        walls.append(time.perf_counter() - t0)
        est = 1.1 * min(walls)
    warm_s = min(walls) if walls else cold_s

    kfi = np.flatnonzero(np.asarray(res.base.is_kf))
    nkf = res.base.kf_count
    kf_per_s = nkf / warm_s
    extra = {
        "mode": "lc",
        "keyframes": nkf,
        "cold_s": round(cold_s, 2),
        "warm_s": round(warm_s, 3),
        "num_loop_closures": res.stats["num_loop_closures"],
        "num_merged_tracks": res.stats["num_merged_tracks"],
        "ate_odometry_m": round(rooted_ate(res.base.trajectory,
                                           w.poses_gt, kfi), 4),
        "ate_final_m": round(rooted_ate(res.trajectory, w.poses_gt,
                                        kfi), 4),
        "wall_breakdown": {k: res.stats[k] for k in
                           ("wall_replay_s", "wall_recognition_s",
                            "wall_desc_s", "wall_recog_scan_s",
                            "wall_span_rounds_s", "wall_joint_confirm_s",
                            "wall_pgo_s", "wall_refine_s")},
        "wall_confirm_stages": res.stats["wall_confirm_stages"],
    }
    if as_extra:
        print(json.dumps({
            "metric": "lc_keyframes_per_s",
            "value": round(kf_per_s, 3),
            "unit": "kf/s",
            "vs_baseline": round(kf_per_s / BASELINE_KF_PER_S, 3),
            **device_fields(), **extra}), file=sys.stderr)
        return
    emit(kf_per_s, kf_per_s / BASELINE_KF_PER_S, extra)


def bench_interactive(t_start):
    """Per-frame host loop (the reference's operating mode)."""
    import dataclasses

    from slslam.config import SlamConfig
    from slslam.engine import Slam
    from slslam.sim.workloads import house_replay

    num_frames = 110
    warmup_frames = 25
    cfg = dataclasses.replace(
        SlamConfig(), compute_dtype="float32",
        kf_rot_thr=1e-9, kf_tr_thr=1e-9,
        obs_buckets=(2048,), cam_buckets=(48,), line_buckets=(128,),
        corr_buckets=(128,))
    frames, _ = house_replay(cfg, num_frames)

    slam = Slam(cfg)
    for i in range(warmup_frames):
        slam.process_frame(frames[i], i)
        if time.perf_counter() - t_start > 0.7 * TOTAL_BUDGET_S:
            warmup_frames = i + 1
            break

    kf0 = len(slam.state.kfs)
    frame_times = []
    measured_end = warmup_frames
    for i in range(warmup_frames, num_frames):
        t0 = time.perf_counter()
        slam.process_frame(frames[i], i)
        frame_times.append(time.perf_counter() - t0)
        measured_end = i + 1
        if time.perf_counter() - t_start > 0.95 * TOTAL_BUDGET_S:
            break
    nkf = len(slam.state.kfs) - kf0
    if nkf == 0 or not frame_times:
        raise RuntimeError("no keyframes in the measured window")

    # median frame time = steady-state rate, robust against one-time jit
    # compiles that land inside the measured window
    median_t = float(np.median(frame_times))
    kf_per_s = 1.0 / median_t
    mean_rate = nkf / float(np.sum(frame_times))
    stats = slam.post_processing()
    emit(kf_per_s, kf_per_s / BASELINE_KF_PER_S, {
        "mode": "interactive",
        "mean_rate_kf_s": round(mean_rate, 3),
        "median_frame_ms": round(median_t * 1e3, 1),
        "ba_mean_ms": stats["proc_local_ba_mean_s"] * 1e3,
        "vo_mean_ms": stats["proc_pose_estimation_mean_s"] * 1e3,
        "avg_ba_iterations": stats["avg_num_iterations"],
        "keyframes": nkf,
        "measured_frames": measured_end - warmup_frames,
    })


def main():
    t_start = time.perf_counter()
    import jax

    from slslam.utils.compcache import enable_persistent_cache

    platform = jax.devices()[0].platform
    if platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX runs on {platform!r}")
    enable_persistent_cache()

    if MODE == "interactive":
        bench_interactive(t_start)
    elif MODE == "lc":
        bench_lc(t_start)
    else:
        bench_batch(t_start)
        # the lc measurement appended to the batch run; budget-gated
        # because a fresh lc compile is long
        remaining = TOTAL_BUDGET_S - (time.perf_counter() - t_start)
        if os.environ.get("BENCH_LC", "1") != "0" and remaining > 200:
            bench_lc(t_start, as_extra=True)


if __name__ == "__main__":
    main()
