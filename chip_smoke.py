"""Smoke run of the stereo line-SLAM main path on one GPU.

Run from the repository root:

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the mesh checks only

Phases, all in this one process (a JAX process reserves most of a card's
memory, so a second one could not open it); the first failure stops the
run with a nonzero exit:

  device       the card as JAX and nvidia-smi report it; refuses anything
               but a GPU (there is no CPU fallback)
  batch        the reference's benchmark: house world, 400 frames, every
               frame a keyframe, 0.2 px noise -> BatchSlam.run +
               global_refine(rounds=3), ATE against the simulator's exact
               ground truth
  lc           village deferred loop closure, 170 frames (BatchSlamLC)
  interactive  ``cli sim --frames 60 --noise-px 0.5``, called in-process
  assembly     the three normal-equation assembly modes: standalone at the
               window and a refine shape against a NumPy float64
               np.add.at reference, and end to end inside the house-400
               replay; the refine method (dense vs cg) on a 100-keyframe
               refine

``--four-cards`` runs only the distributed solvers and the CLI's mesh
path, each against its one-card counterpart.

The last line of stdout is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``,
printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from slslam.utils.compcache import enable_persistent_cache

ASSEMBLY_MODES = ("scatter", "onehot", "blocked")
# (C, L, O, frame_step): the batch engine's window BA (20 consecutive
# keyframes) and a 128-keyframe global refine over the whole trajectory
WINDOW_SHAPE = (20, 129, 2560, 1)
REFINE_SHAPE = (128, 512, 16384, 3)


class SmokeFailure(Exception):
    """A phase missed its bound or the device is not a GPU."""


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


def ok_line(platform, kind, count):
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def require_gpu():
    """The JAX devices, which must be GPUs."""
    devices = jax.devices()
    check(devices[0].platform == "gpu",
          f"no GPU: JAX runs on {devices[0].platform!r}")
    return devices


def card_info():
    """name, power.limit of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def peak_bytes(device):
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def wall(fn):
    """(result, seconds) of fn(); fn must return host values or block."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def median_time(fn, reps):
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# ---------------------------------------------------------------------------
# batch: BatchSlam.run + global_refine on the house replay
# ---------------------------------------------------------------------------

def replay_and_refine(cfg, frames, poses_gt, assembly=None):
    from slslam.engine.batch import BatchSlam
    from slslam.engine.refine import global_refine
    from slslam.sim.workloads import rooted_ate

    eng = BatchSlam(cfg, assembly=assembly)
    res, t_replay = wall(lambda: eng.run(frames))
    ref, t_refine = wall(lambda: global_refine(
        frames, res.is_kf, res.trajectory, config=cfg, rounds=3))
    kfi = np.flatnonzero(res.is_kf)
    return {"keyframes": res.kf_count,
            "replay_s": t_replay, "refine_s": t_refine,
            "ate_raw_m": rooted_ate(res.trajectory, poses_gt, kfi),
            "ate_refined_m": rooted_ate(ref.trajectory, poses_gt, kfi),
            "avg_ba_iterations": res.stats["avg_num_iterations"]}, res


# ATE bounds of the batch phase (PERF.md, "Bounds"): the plain reference
# (CPU float64) gives seed 4 a raw ATE of 0.4841 m — the windowed BA
# freezes the early edges along a weakly observable mode, as the
# reference's own window policy does — and 0.0015 m after global_refine.
MAX_ATE_RAW = 0.6
MAX_ATE_REFINED = 0.005


def phase_batch(dtype="float32", num_frames=400, seed=4,
                max_ate_raw=MAX_ATE_RAW, max_ate_refined=MAX_ATE_REFINED):
    from slslam.sim.workloads import house_replay, house_replay_config

    cfg = house_replay_config(dtype)
    frames, poses_gt = house_replay(cfg, num_frames, seed=seed)
    cold, res = replay_and_refine(cfg, frames, poses_gt)
    warm, _ = replay_and_refine(cfg, frames, poses_gt)
    out = {"frames": num_frames, "keyframes": cold["keyframes"],
           "cold_replay_s": cold["replay_s"],
           "cold_refine_s": cold["refine_s"],
           "warm_replay_s": warm["replay_s"],
           "warm_refine_s": warm["refine_s"],
           "ate_raw_m": warm["ate_raw_m"],
           "ate_refined_m": warm["ate_refined_m"],
           "avg_ba_iterations": warm["avg_ba_iterations"],
           "peak_bytes_in_use": peak_bytes(jax.devices()[0])}
    emit("batch", **out)
    check(out["keyframes"] == num_frames,
          f"batch: {out['keyframes']} keyframes != {num_frames}")
    for r in (cold, warm):
        check(r["ate_raw_m"] <= max_ate_raw,
              f"batch: raw ATE {r['ate_raw_m']} > {max_ate_raw}")
        check(r["ate_refined_m"] <= max_ate_refined,
              f"batch: refined ATE {r['ate_refined_m']} > "
              f"{max_ate_refined}")
    return out, (cfg, frames, poses_gt, res)


# ---------------------------------------------------------------------------
# lc: deferred loop closure on the village orbit
# ---------------------------------------------------------------------------

def phase_lc(dtype="float32", num_frames=170, min_closures=7):
    from slslam.sim.workloads import rooted_ate, village_lc

    w = village_lc(dtype, num_frames=num_frames)
    res, t_run = wall(lambda: w.make_engine().run(w.frames))
    kfi = np.flatnonzero(np.asarray(res.base.is_kf))
    out = {"frames": num_frames, "keyframes": res.base.kf_count,
           "cold_s": t_run,
           "num_loop_closures": res.stats["num_loop_closures"],
           "ate_odometry_m": rooted_ate(res.base.trajectory, w.poses_gt,
                                        kfi),
           "ate_final_m": rooted_ate(res.trajectory, w.poses_gt, kfi),
           "peak_bytes_in_use": peak_bytes(jax.devices()[0])}
    emit("lc", **out)
    check(out["num_loop_closures"] >= min_closures,
          f"lc: {out['num_loop_closures']} closures < {min_closures}")
    if min_closures > 0:
        check(out["ate_final_m"] < out["ate_odometry_m"],
              f"lc: final ATE {out['ate_final_m']} not below odometry "
              f"ATE {out['ate_odometry_m']}")
    return out


# ---------------------------------------------------------------------------
# interactive: the CLI's per-frame engine, in this process
# ---------------------------------------------------------------------------

def run_cli_sim(frames, extra=()):
    """cli.main sim in-process; returns (stats, trajectory rows)."""
    from slslam import cli

    with tempfile.TemporaryDirectory() as d:
        cli.main(["sim", "--frames", str(frames), "--noise-px", "0.5",
                  "--out", d, *extra])
        with open(os.path.join(d, "stats.json")) as f:
            stats = json.load(f)
        rows = np.loadtxt(os.path.join(d, "trajectory.txt"))
    return stats, np.atleast_2d(rows)


def phase_interactive(frames=60, max_ate=0.1):
    (stats, _), t = wall(lambda: run_cli_sim(frames))
    out = {"frames": frames, "wall_s": t, "ate_m": stats.get("ate_m"),
           "keyframes": stats.get("num_keyframes")}
    emit("interactive", **out)
    check(out["ate_m"] is not None and out["ate_m"] < max_ate,
          f"interactive: ATE {out['ate_m']} not < {max_ate}")
    return out


# ---------------------------------------------------------------------------
# assembly: the three modes against NumPy float64, standalone and in-scan
# ---------------------------------------------------------------------------

def house_problem(C, L, Om, dtype, frame_step=1, noise_px=0.3, seed=0):
    """A camera-major BA problem from the house world: C cameras every
    ``frame_step`` frames of the 400-frame wave trajectory (1 = the batch
    window's consecutive keyframes), L line slots (the house's 74 lines,
    the rest padding), Om observation rows per camera.  Unused rows are
    padding with NaN garbage observations, as the engine's buckets
    produce."""
    from slslam import geometry as geo
    from slslam.config import CameraConfig
    from slslam.sim import StereoLineRenderer, house_segments
    from slslam.sim import wave_trajectory

    segs = house_segments()
    check(len(segs) <= L, f"{len(segs)} house lines > {L} line slots")
    poses = wave_trajectory(num_frames=400)[::frame_step][:C]
    check(len(poses) == C, f"{C} cameras every {frame_step} frames > 400")
    ren = StereoLineRenderer(segs, CameraConfig(), noise_px=noise_px,
                             seed=seed)
    rng = np.random.default_rng(seed)
    O = C * Om
    obs = np.full((O, 8), np.nan)
    ocam = np.repeat(np.arange(C, dtype=np.int32), Om)
    olin = (np.arange(O) % L).astype(np.int32)    # padding rows collide
    valid = np.zeros(O, bool)
    for c, T in enumerate(poses):
        seen = sorted(ren.observe(T).items())[:Om]
        for k, (sid, o) in enumerate(seen):
            obs[c * Om + k], olin[c * Om + k] = o, sid
            valid[c * Om + k] = True

    p1, p2 = segs[:, :3], segs[:, 3:]
    v = p2 - p1
    cp = np.cross(v, np.cross(p1, p2)) / np.sum(v * v, 1, keepdims=True)
    orth = np.zeros((L, 4))
    orth[:, 3] = 0.5
    orth[:len(segs)] = np.asarray(geo.av_to_orth(
        jnp.asarray(np.concatenate([cp, v], 1), jnp.float32)))
    orth[:len(segs)] += rng.standard_normal((len(segs), 4)) * 0.003
    cam = np.stack([T.wt() for T in poses])
    cam[1:] += rng.standard_normal((C - 1, 6)) * 0.01
    cam_free = np.ones(C, bool)
    cam_free[0] = False
    line_free = np.zeros(L, bool)
    line_free[:len(segs)] = True
    return tuple(jnp.asarray(a, dt) for a, dt in (
        (cam, dtype), (orth, dtype), (obs, dtype), (ocam, jnp.int32),
        (olin, jnp.int32), (valid, bool), (cam_free, bool),
        (line_free, bool)))


def assemble_reference(A, B, Wb, gc_o, gl_o, ocam, olin, C, L):
    """np.add.at in float64: the plain reference of ops/schur_ba.assemble."""
    f = lambda a: np.asarray(a, np.float64)
    ocam, olin = np.asarray(ocam), np.asarray(olin)
    Hcc = np.zeros((C, 6, 6))
    Hll = np.zeros((L, 4, 4))
    gc = np.zeros((C, 6))
    gl = np.zeros((L, 4))
    W = np.zeros((C, L, 6, 4))
    np.add.at(Hcc, ocam, f(A))
    np.add.at(Hll, olin, f(B))
    np.add.at(gc, ocam, f(gc_o))
    np.add.at(gl, olin, f(gl_o))
    np.add.at(W, (ocam, olin), f(Wb))
    return Hcc, Hll, gc, gl, W


def assembly_errors(problem, modes=ASSEMBLY_MODES, reps=20):
    """For each mode: max |error| / max |ref| of _eval_system's blocks
    against assemble_reference, and its median time per evaluation."""
    from slslam.config import CameraConfig
    from slslam.ops.schur_ba import _eval_system, _obs_blocks

    cam, orth, obs, ocam, olin, valid, cam_free, line_free = problem
    C, L = cam.shape[0], orth.shape[0]
    dt = cam.dtype
    common = (cam, orth, obs, ocam, olin, valid.astype(dt),
              cam_free.astype(dt), line_free.astype(dt),
              jnp.asarray(CameraConfig().baseline, dt),
              jnp.asarray(1.0 / CameraConfig().focal_length, dt), True)
    _, *blocks = jax.jit(_obs_blocks, static_argnums=10)(*common)
    ref = assemble_reference(*blocks, ocam, olin, C, L)
    out = {}
    for mode in modes:
        ev = jax.jit(lambda *a, m=mode: _eval_system(*a, assembly=m),
                     static_argnums=10)
        got = ev(*common)[1:]
        err = max(float(np.max(np.abs(np.asarray(g, np.float64) - r)))
                  / max(float(np.max(np.abs(r))), 1e-300)
                  for g, r in zip(got, ref))
        out[mode] = {"rel_err": err,
                     "eval_s": median_time(lambda: ev(*common), reps)}
    return out


def refine_methods(cfg, frames, trajectory, poses_gt):
    from slslam.engine.refine import global_refine
    from slslam.sim.workloads import rooted_ate

    is_kf = np.ones(len(frames), bool)
    out = {}
    for method in ("dense", "cg"):
        run = lambda: global_refine(frames, is_kf, trajectory, config=cfg,
                                    method=method)
        _, cold = wall(run)
        ref, warm = wall(run)
        out[method] = {"cold_s": cold, "warm_s": warm,
                       "ate_m": rooted_ate(ref.trajectory, poses_gt,
                                           np.arange(len(frames)))}
    return out


def phase_assembly(batch_ctx, shapes=(WINDOW_SHAPE, REFINE_SHAPE),
                   refine_frames=100, tol=1e-5, max_ate_raw=MAX_ATE_RAW):
    from slslam.engine.batch import BatchSlam
    from slslam.sim.workloads import rooted_ate

    cfg, frames, poses_gt, res = batch_ctx
    out = {"standalone": {}, "in_scan": {}}
    for C, L, O, step in shapes:
        errs = assembly_errors(house_problem(C, L, O // C, cfg.compute_dtype,
                                             frame_step=step))
        out["standalone"][f"C{C}_L{L}_O{O}"] = errs
        for mode, e in errs.items():
            check(e["rel_err"] <= tol,
                  f"assembly {mode} at C={C} L={L} O={O}: relative error "
                  f"{e['rel_err']} > {tol}")
    kfi = np.arange(len(frames))
    for mode in ASSEMBLY_MODES:
        eng = BatchSlam(cfg, assembly=mode)
        _, cold = wall(lambda: eng.run(frames))
        warm = []
        for _ in range(2):
            r, t = wall(lambda: eng.run(frames))
            warm.append(t)
        ate = rooted_ate(r.trajectory, poses_gt, kfi)
        out["in_scan"][mode] = {"cold_replay_s": cold,
                                "warm_replay_s": warm, "ate_raw_m": ate,
                                "avg_ba_iterations":
                                    r.stats["avg_num_iterations"]}
        check(r.kf_count == len(frames) and ate <= max_ate_raw,
              f"assembly {mode} in-scan: {r.kf_count} keyframes, raw ATE "
              f"{ate}")
    n = refine_frames
    out["refine_method"] = refine_methods(cfg, frames[:n],
                                          res.trajectory[:n], poses_gt[:n])
    emit("assembly", **out)
    return out


# ---------------------------------------------------------------------------
# four cards: distributed solvers against their one-card counterparts
# ---------------------------------------------------------------------------

def spans(x, devices):
    """True when x's shards sit on every one of ``devices``."""
    return {s.device for s in x.addressable_shards} == set(devices)


# float32 tolerances of the four-card checks.  The sharded solve sums in
# another order (per-shard partials, then psum), so the LM path differs in
# the last bits; four virtual CPU devices in float32 gave cameras 1.3e-6,
# lines 1.1e-3 (weakly observed lines move along flat directions at equal
# cost), cost 1e-6 relative, PGO 4.8e-7 and CLI positions 6.8e-6 m.
CAM_TOL, LINE_TOL, COST_RTOL, PGO_TOL, CLI_TOL_M = 1e-4, 1e-2, 1e-4, 1e-4, 1e-3


def dist_ba_check(devices, shape=WINDOW_SHAPE, dtype="float32",
                  cam_tol=CAM_TOL, line_tol=LINE_TOL, cost_rtol=COST_RTOL):
    from slslam.config import CameraConfig
    from slslam.ops.schur_ba import local_ba
    from slslam.parallel import (dist_local_ba_lines, make_mesh,
                                 partition_by_line)

    C, L, O, step = shape
    args = house_problem(C, L, O // C, dtype, frame_step=step)
    cam = CameraConfig()
    bl, hd = cam.baseline, 1.0 / cam.focal_length
    with jax.default_device(devices[0]):
        cam_s, line_s, st_s = local_ba(*args, bl, hd)
    lo, lf, ob, oc, ol, ov, perm = partition_by_line(
        *(np.asarray(a) for a in (args[1], args[7], args[2], args[3],
                                  args[4], args[5])), len(devices))
    cam_d, line_d, st_d = dist_local_ba_lines(
        make_mesh(devices), args[0], jnp.asarray(lo), jnp.asarray(ob),
        jnp.asarray(oc), jnp.asarray(ol), jnp.asarray(ov), args[6],
        jnp.asarray(lf), bl, hd)
    line_back = np.asarray(line_d).reshape(-1, 4)[perm]
    out = {"cam_max_abs_diff": float(np.max(np.abs(
               np.asarray(cam_d) - np.asarray(cam_s)))),
           "line_max_abs_diff": float(np.max(np.abs(
               line_back - np.asarray(line_s)))),
           "cost_single": float(st_s.final_cost),
           "cost_dist": float(st_d.final_cost),
           "iterations": [int(st_s.iterations), int(st_d.iterations)],
           "line_shards_span": spans(line_d, devices)}
    check(out["line_shards_span"], "dist BA: lines not on every device")
    check(out["cam_max_abs_diff"] <= cam_tol
          and out["line_max_abs_diff"] <= line_tol
          and abs(out["cost_dist"] - out["cost_single"])
          <= cost_rtol * out["cost_single"],
          f"dist BA differs from one card beyond ({cam_tol}, {line_tol}, "
          f"{cost_rtol}): {out}")
    return out


def ring_pgo_problem(V=32, E=64, drift=0.05, seed=0):
    from slslam.hostgeom import Pose

    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(V) / V
    gt = np.stack([np.zeros(V), ang, np.zeros(V), 3 * np.sin(ang),
                   np.zeros(V), 3 * np.cos(ang)], 1)
    ei = np.zeros(E, np.int32)
    ej = np.zeros(E, np.int32)
    ctr = np.zeros((E, 6))
    for k in range(V):                    # chain edges + the loop edge
        i, j = k, (k + 1) % V
        ei[k], ej[k] = i, j
        ctr[k] = (Pose.from_wt(gt[j]) @ Pose.from_wt(gt[i]).inv()).wt()
    ev = np.arange(E) < V
    poses0 = gt + rng.standard_normal(gt.shape) * drift
    poses0[0] = gt[0]
    free = np.ones(V, bool)
    free[0] = False
    return poses0, ei, ej, ctr, ev, free


def dist_pgo_check(devices, dtype="float32", tol=PGO_TOL):
    from slslam.ops.pose_graph import pose_graph_opt
    from slslam.parallel import dist_pose_graph_opt, make_mesh

    poses0, ei, ej, ctr, ev, free = ring_pgo_problem()
    args = (jnp.asarray(poses0, dtype), jnp.asarray(ei), jnp.asarray(ej),
            jnp.asarray(ctr, dtype), jnp.asarray(ev), jnp.asarray(free))
    with jax.default_device(devices[0]):
        out_s, _ = pose_graph_opt(*args, max_iters=10)
    out_d, _ = dist_pose_graph_opt(make_mesh(devices), *args, max_iters=10)
    out = {"max_abs_diff": float(np.max(np.abs(
               np.asarray(out_d) - np.asarray(out_s)))),
           "replicated_span": spans(out_d, devices)}
    check(out["replicated_span"], "dist PGO: result not on every device")
    check(out["max_abs_diff"] <= tol,
          f"dist PGO differs from one card beyond {tol}: {out}")
    return out


def cli_mesh_check(devices, frames=60, tol=CLI_TOL_M, max_ate=0.1):
    stats_1, rows_1 = run_cli_sim(frames, ("--mesh-devices", "0"))
    stats_n, rows_n = run_cli_sim(frames,
                                  ("--mesh-devices", str(len(devices))))
    n = min(len(rows_1), len(rows_n))
    out = {"ate_single_m": stats_1.get("ate_m"),
           "ate_mesh_m": stats_n.get("ate_m"),
           "keyframes": [len(rows_1), len(rows_n)],
           "position_max_abs_diff": float(np.max(np.abs(
               rows_n[:n, 1:4] - rows_1[:n, 1:4])))}
    check(len(rows_1) == len(rows_n), f"cli mesh: keyframes differ: {out}")
    check(out["position_max_abs_diff"] <= tol,
          f"cli mesh: trajectories differ beyond {tol} m: {out}")
    check(out["ate_mesh_m"] < max_ate, f"cli mesh: ATE {out}")
    return out


def phase_four_cards(devices):
    check(len(devices) == 4, f"--four-cards needs 4 devices, "
                             f"have {len(devices)}")
    out = {"dist_local_ba_lines": dist_ba_check(devices),
           "dist_pose_graph_opt": dist_pgo_check(devices),
           "cli_sim_mesh": cli_mesh_check(devices)}
    emit("four_cards", **out)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh checks")
    args = ap.parse_args(argv)
    try:
        devices = require_gpu()
        enable_persistent_cache()
        emit("device", kind=devices[0].device_kind, count=len(devices))
        print(card_info(), flush=True)
        if args.four_cards:
            phase_four_cards(devices)
        else:
            _, ctx = phase_batch()
            phase_lc()
            phase_interactive()
            phase_assembly(ctx)
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr, flush=True)
        return 1
    print(ok_line(devices[0].platform, devices[0].device_kind,
                  len(devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
