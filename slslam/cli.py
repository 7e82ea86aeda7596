"""Command-line driver.

Replaces the reference's per-dataset binaries + gflags
(/root/reference/src/main.cpp) with one CLI and runtime sequence configs:

  python -m slslam.cli sim   --frames 120 --noise-px 0.5 --out /tmp/run
  python -m slslam.cli run   --obs-dir data/it3f/line_tracking_result
  python -m slslam.cli gen   --frames 400 --out /tmp/house_seq

Flags mirror the reference's (--ba-window-size, --max-num-iter, --rseed,
--robust, --stopfrm; main.cpp:22-27).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def _add_engine_flags(p: argparse.ArgumentParser):
    p.add_argument("--engine", choices=("interactive", "batch"),
                   default="interactive",
                   help="interactive = per-frame host loop (supports loop "
                        "closure); batch = whole replay as one device scan "
                        "(fastest; odometry-chain sequences)")
    p.add_argument("--ba-window-size", type=int, default=10)
    p.add_argument("--max-num-iter", type=int, default=10)
    p.add_argument("--rseed", type=int, default=4)
    p.add_argument("--robust", action="store_true", default=True)
    p.add_argument("--no-robust", dest="robust", action="store_false")
    p.add_argument("--stopfrm", type=int, default=99999)
    p.add_argument("--dtype", default=None,
                   help="compute dtype (default: float32 on a GPU, "
                        "float64 on CPU)")
    p.add_argument("--platform", default=None,
                   help="jax platform override (e.g. cpu)")
    p.add_argument("--out", default=None, help="output directory")
    p.add_argument("--plot", action="store_true",
                   help="write a map.png rendering into --out")
    p.add_argument("--viz", action="store_true",
                   help="write map.html into --out: a self-contained "
                        "interactive 3D viewer (orbit/pan/zoom, top-down, "
                        "keyframe playback) — the reference's GLFW scene "
                        "viewer (cplot.cpp:417-433), exportable")
    p.add_argument("--live-dir", default=None,
                   help="interactive engine: write per-frame stereo "
                        "tracking views (tracking_%%05d.png) here — the "
                        "reference's live drawImageTracking window "
                        "(cplot.cpp:260-340)")
    p.add_argument("--live-every", type=int, default=10,
                   help="tracking-view cadence in frames (with --live-dir)")
    p.add_argument("--refine", action="store_true",
                   help="batch engine: follow the replay with one global "
                        "bundle adjustment over every keyframe (engine/"
                        "refine.py) — impossible in the reference's "
                        "sliding-window-only design")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save a resumable checkpoint into --out every N "
                        "keyframes (0 = off)")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="run BA/PGO sharded over the first N jax devices")
    p.add_argument("--multihost", action="store_true",
                   help="initialize jax.distributed before running")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--profile-dir", default=None,
                   help="write a jax.profiler trace to this directory")


def _make_config(args):
    from .config import SlamConfig
    import jax
    if getattr(args, "multihost", False):
        from .parallel.multihost import initialize_multihost
        info = initialize_multihost(args.coordinator, args.num_processes,
                                    args.process_id)
        print(f"multihost: {info}", file=sys.stderr)
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if getattr(args, "profile_dir", None):
        jax.profiler.start_trace(args.profile_dir)
    platform = jax.devices()[0].platform
    dtype = args.dtype or ("float64" if platform == "cpu" else "float32")
    if dtype == "float64" and platform == "cpu":
        jax.config.update("jax_enable_x64", True)
    return SlamConfig(
        ba_window_size=args.ba_window_size,
        max_num_iter=args.max_num_iter,
        rseed=args.rseed,
        robust=args.robust,
        compute_dtype=dtype,
        mesh_devices=getattr(args, "mesh_devices", 0),
    )


def _finish(slam, args, gt_rows=None):
    import numpy as np
    from .evalio.traj import ate_position_error
    from .evalio.writers import trajectory_rows

    stats = slam.post_processing()
    est = trajectory_rows(slam.trajectory())
    if gt_rows is not None and len(est) and len(gt_rows):
        stats["ate_m"] = ate_position_error(est, gt_rows)

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        slam.save_trajectory(os.path.join(args.out, "trajectory.txt"))
        slam.save_landmarks(os.path.join(args.out, "landmarks.txt"))
        if gt_rows is not None:
            np.savetxt(os.path.join(args.out, "gt_trajectory.txt"), gt_rows,
                       delimiter="\t")
        with open(os.path.join(args.out, "stats.json"), "w") as f:
            json.dump(stats, f, indent=2)
        if getattr(args, "plot", False):
            from .viz import plot_map
            plot_map(slam.trajectory(),
                     slam._landmark_world_segments(min_len=0.5),
                     os.path.join(args.out, "map.png"),
                     gt_trajectory=gt_rows)
        if getattr(args, "viz", False):
            from .viz_interactive import export_interactive_map
            export_interactive_map(
                os.path.join(args.out, "map.html"), slam.trajectory(),
                slam._landmark_world_segments(min_len=0.5), gt_rows=gt_rows)

    if getattr(args, "profile_dir", None):
        import jax
        jax.profiler.stop_trace()
    for k, v in stats.items():
        print(f"  {k}: {v}")
    return stats


def _refine_batch(res, frames, args, stats, cfg):
    """Run the post-replay global BA (engine/refine.py) and record stats.

    Takes the already-constructed config: _make_config has one-shot side
    effects (jax.profiler.start_trace, jax.distributed.initialize) that
    raise if run twice.
    """
    from .engine.refine import global_refine

    t0 = time.time()
    ref = global_refine(frames, res.is_kf, res.trajectory, config=cfg)
    stats["refine_wall_s"] = round(time.time() - t0, 3)
    stats["refine_iterations"] = ref.iterations
    stats["refine_initial_cost"] = ref.initial_cost
    stats["refine_final_cost"] = ref.final_cost
    stats["refine_num_cams"] = ref.num_cams
    stats["refine_num_obs"] = ref.num_obs
    return ref


def _finish_batch(res, args, wall_s, poses_gt=None, frames=None, cfg=None):
    """Write outputs + stats for a BatchSlam result (mirrors _finish)."""
    import numpy as np
    from .evalio.writers import trajectory_rows, write_landmarks

    stats = dict(res.stats)
    stats["wall_s"] = round(wall_s, 3)
    stats["kf_per_s"] = round(res.kf_count / max(wall_s, 1e-9), 3)

    ref = None
    if getattr(args, "refine", False) and frames is not None and res.kf_count:
        from .config import SlamConfig
        ref = _refine_batch(res, frames, args, stats, cfg or SlamConfig())

    gt_rows = None
    if poses_gt is not None and res.kf_count:
        kf_idx = np.flatnonzero(np.asarray(res.is_kf))
        T0 = poses_gt[kf_idx[0]]
        gt_cw = [(poses_gt[i] @ T0.inv()).inv() for i in kf_idx]
        gt_rows = trajectory_rows(gt_cw)
        err = [np.linalg.norm(a.t - b.t)
               for a, b in zip(res.trajectory, gt_cw)]
        stats["ate_m"] = float(np.mean(err))
        if ref is not None:
            err = [np.linalg.norm(a.t - b.t)
                   for a, b in zip(ref.trajectory, gt_cw)]
            stats["refine_ate_m"] = float(np.mean(err))

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        est_rows = trajectory_rows(res.trajectory)
        np.savetxt(os.path.join(args.out, "trajectory.txt"), est_rows,
                   delimiter="\t")
        write_landmarks(os.path.join(args.out, "landmarks.txt"),
                        res.world_segments(min_len=1.0))
        if ref is not None:
            np.savetxt(os.path.join(args.out, "trajectory_refined.txt"),
                       trajectory_rows(ref.trajectory), delimiter="\t")
        if gt_rows is not None:
            np.savetxt(os.path.join(args.out, "gt_trajectory.txt"), gt_rows,
                       delimiter="\t")
        with open(os.path.join(args.out, "stats.json"), "w") as f:
            json.dump(stats, f, indent=2)
        if getattr(args, "plot", False):
            from .viz import plot_map
            plot_map(res.trajectory,
                     res.world_segments(min_len=0.5),
                     os.path.join(args.out, "map.png"),
                     gt_trajectory=gt_rows)
        if getattr(args, "viz", False):
            from .viz_interactive import export_interactive_map
            export_interactive_map(
                os.path.join(args.out, "map.html"),
                ref.trajectory if ref is not None else res.trajectory,
                res.world_segments(min_len=0.5), gt_rows=gt_rows)

    if getattr(args, "profile_dir", None):
        import jax
        jax.profiler.stop_trace()
    for k, v in stats.items():
        print(f"  {k}: {v}")
    return stats


def _maybe_checkpoint(slam, args, n_kfs):
    every = getattr(args, "checkpoint_every", 0)
    if every and args.out and n_kfs % every == 0:
        from .checkpoint import save_checkpoint
        os.makedirs(args.out, exist_ok=True)
        save_checkpoint(slam, os.path.join(args.out, "checkpoint.npz"))


def cmd_sim(args):
    import numpy as np
    from .engine import Slam
    from .evalio.writers import trajectory_rows
    from .sim import StereoLineRenderer, house_segments, wave_trajectory

    cfg = _make_config(args)
    segs = house_segments()
    poses_gt = wave_trajectory(num_frames=args.frames)
    ren = StereoLineRenderer(segs, cfg.camera, noise_px=args.noise_px,
                             seed=args.rseed)

    if args.engine == "batch":
        from .engine.batch import BatchSlam
        nf = min(len(poses_gt), args.stopfrm + 1)
        poses_gt = poses_gt[:nf]
        frames = [ren.observe(T) for T in poses_gt]
        t0 = time.time()
        res = BatchSlam(cfg).run(frames)
        wall = time.time() - t0
        print(f"batch-replayed {nf} frames -> {res.kf_count} keyframes "
              f"in {wall:.1f}s (incl. compile)")
        _finish_batch(res, args, wall, poses_gt, frames=frames, cfg=cfg)
        return

    if getattr(args, "refine", False):
        print("warning: --refine only applies to --engine batch; ignored "
              "on the interactive engine", file=sys.stderr)
    slam = Slam(cfg)
    slam.verbose = args.verbose

    kf_frames = []
    t0 = time.time()
    for i, T in enumerate(poses_gt):
        if i > args.stopfrm:
            break
        if getattr(args, "live_dir", None) and i % args.live_every == 0:
            from .viz import plot_observations
            plot_observations(
                None, None, ren.observe_pixels(T),
                os.path.join(args.live_dir, f"tracking_{i:05d}.png"),
                image_size=(cfg.camera.image_width, cfg.camera.image_height),
                title=f"frame {i}")
        if slam.process_frame(ren.observe(T), i):
            kf_frames.append(i)
            _maybe_checkpoint(slam, args, len(kf_frames))
        if args.verbose and i % 20 == 0:
            print(f"frame {i}: kfs={len(kf_frames)} "
                  f"lms={len(slam.state.lms)}", file=sys.stderr)
    wall = time.time() - t0
    print(f"processed {len(poses_gt)} frames -> {len(kf_frames)} keyframes "
          f"in {wall:.1f}s ({len(kf_frames) / wall:.2f} kf/s)")

    if kf_frames:
        T0 = poses_gt[kf_frames[0]]
        gt_rows = trajectory_rows(
            [(poses_gt[i] @ T0.inv()).inv() for i in kf_frames])
    else:
        gt_rows = None
    _finish(slam, args, gt_rows)


def cmd_run(args):
    from .engine import Slam
    from .frontend.io import ObsFileLoader

    cfg = _make_config(args)

    if args.engine == "batch":
        from .engine.batch import BatchSlam
        frames, ids = [], []
        for frame_id, obs in ObsFileLoader(args.obs_dir):
            if frame_id > args.stopfrm:
                break
            frames.append(obs)
            ids.append(frame_id)
        from .engine.batch import normalize_frames
        frames = normalize_frames(frames, cfg.camera)
        t0 = time.time()
        res = BatchSlam(cfg).run(frames, frame_ids=ids)
        wall = time.time() - t0
        print(f"batch-replayed {len(frames)} frames -> {res.kf_count} "
              f"keyframes in {wall:.1f}s (incl. compile)")
        _finish_batch(res, args, wall, frames=frames, cfg=cfg)
        return

    if getattr(args, "refine", False):
        print("warning: --refine only applies to --engine batch; ignored "
              "on the interactive engine", file=sys.stderr)
    slam = Slam(cfg)
    loader = ObsFileLoader(args.obs_dir)

    t0 = time.time()
    n = 0
    for frame_id, obs in loader:
        if frame_id > args.stopfrm:
            break
        slam.process_frame(obs, frame_id, normalized=False)
        n += 1
    wall = time.time() - t0
    print(f"processed {n} frames, {len(slam.state.kfs)} keyframes "
          f"in {wall:.1f}s")
    _finish(slam, args)


def cmd_track(args):
    """Full pipeline on raw stereo imagery: detector -> matcher ->
    descriptors -> (voctree place recognition) -> SLAM.

    Replaces the reference's unreleased front-end; images are %04d.(png|jpg)
    under --left-dir / --right-dir (the reference's left_rect/right_rect
    layout, parameter.h:28-41).  With --vocab, the matcher's computed
    descriptors feed the voctree place recognizer and loop closure runs
    live (the reference's wlc configuration, with the front-end the
    authors never released).  A missing --vocab file is trained from the
    sequence's own descriptors in a pre-pass and saved (the reference
    loads prebuilt binaries from a trees/ dir).
    """
    import numpy as np
    from PIL import Image

    from .engine import Slam
    from .frontend.matcher import StereoLineMatcher

    cfg = _make_config(args)
    slam = Slam(cfg)
    matcher = StereoLineMatcher(cfg.camera)

    def frames():
        i = args.start
        while True:
            hits = []
            for d in (args.left_dir, args.right_dir):
                found = None
                for ext in ("png", "jpg", "jpeg", "pgm", "bmp"):
                    p = os.path.join(d, f"{i:04d}.{ext}")
                    if os.path.exists(p):
                        found = p
                        break
                hits.append(found)
            if None in hits:
                return
            yield i, hits
            i += 1

    def load(pl_, pr_):
        img_l = np.asarray(Image.open(pl_).convert("L"), np.float32)
        img_r = np.asarray(Image.open(pr_).convert("L"), np.float32)
        return img_l, img_r

    if getattr(args, "vocab", None):
        from .loopclosure import PlaceRecognizer, VocTree, build_vocabulary
        from .loopclosure.voctree import VocTreeParams
        params = (VocTreeParams.outdoor() if args.vocab_preset == "outdoor"
                  else VocTreeParams.outdoor_long_loop()
                  if args.vocab_preset == "outdoor-long"
                  else VocTreeParams())
        if not os.path.exists(args.vocab):
            print(f"training vocabulary -> {args.vocab}", file=sys.stderr)
            pre = StereoLineMatcher(cfg.camera)
            bank = []
            for frame_id, (pl_, pr_) in frames():
                if frame_id > args.stopfrm or len(bank) > 200:
                    break
                pre.process(frame_id, *load(pl_, pr_))
                bank.extend(t.desc for t in pre.tracks.values())
            vocab = build_vocabulary(np.asarray(bank, np.float32))
            VocTree(vocab, params).save(args.vocab)
        tree = VocTree.load(args.vocab, params)
        slam.place_recognizer = PlaceRecognizer(tree)
        slam.descriptor_source = matcher.descriptors

    t0 = time.time()
    n = 0
    for frame_id, (pl_, pr_) in frames():
        if frame_id > args.stopfrm:
            break
        img_l, img_r = load(pl_, pr_)
        obs = matcher.process(frame_id, img_l, img_r)
        if getattr(args, "live_dir", None) \
                and frame_id % args.live_every == 0:
            from .viz import plot_observations
            plot_observations(
                img_l, img_r, obs,
                os.path.join(args.live_dir,
                             f"tracking_{frame_id:05d}.png"),
                title=f"frame {frame_id}")
        slam.process_frame(obs, frame_id, normalized=False)
        n += 1
    print(f"processed {n} stereo frames, {len(slam.state.kfs)} keyframes, "
          f"{slam.lc_cnt} loop closures in {time.time() - t0:.1f}s")
    _finish(slam, args)


def cmd_view(args):
    """Build the interactive HTML viewer from a finished run directory
    (trajectory.txt + landmarks.txt [+ gt_trajectory.txt, stats.json])."""
    import numpy as np
    from .hostgeom import Pose, rodrigues
    from .viz_interactive import export_interactive_map

    run = args.run
    rows = np.loadtxt(os.path.join(run, args.trajectory))
    rows = np.atleast_2d(rows)
    traj = [Pose(rodrigues(np.asarray(r[4:7], float)),
                 np.array([-r[2], -r[3], r[1]])) for r in rows]
    segs = np.zeros((0, 6))
    lm_path = os.path.join(run, "landmarks.txt")
    if os.path.exists(lm_path):
        lm = np.atleast_2d(np.loadtxt(lm_path))
        if lm.size:
            # landmark rows are (z1 -y1 x1 z2 -y2 x2), writers.py
            segs = np.stack([lm[:, 2], -lm[:, 1], lm[:, 0],
                             lm[:, 5], -lm[:, 4], lm[:, 3]], axis=1)
    gt = None
    gt_path = os.path.join(run, "gt_trajectory.txt")
    if os.path.exists(gt_path):
        gt = np.atleast_2d(np.loadtxt(gt_path))
    out = args.out or os.path.join(run, "map.html")
    export_interactive_map(out, traj, segs, gt_rows=gt,
                           title=os.path.basename(os.path.abspath(run)))
    print(f"wrote {out}")


def cmd_gen(args):
    from .config import CameraConfig
    from .sim import StereoLineRenderer, house_segments, wave_trajectory
    from .evalio.writers import trajectory_rows
    import numpy as np

    segs = house_segments()
    poses = wave_trajectory(num_frames=args.frames)
    ren = StereoLineRenderer(segs, CameraConfig(), noise_px=args.noise_px,
                             seed=args.rseed)
    out = args.out or "house_seq"
    ren.write_sequence(out, poses)
    gt_rows = trajectory_rows([(T @ poses[0].inv()).inv() for T in poses])
    np.savetxt(os.path.join(out, "gt_trajectory.txt"), gt_rows,
               delimiter="\t")
    print(f"wrote {args.frames} frames to {out}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="slslam",
                                description="stereo line SLAM")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("sim", help="run the house-world simulation")
    ps.add_argument("--frames", type=int, default=120)
    ps.add_argument("--noise-px", type=float, default=0.5)
    ps.add_argument("--verbose", action="store_true")
    _add_engine_flags(ps)
    ps.set_defaults(fn=cmd_sim)

    pr = sub.add_parser("run", help="replay a line-track sequence directory")
    pr.add_argument("--obs-dir", required=True)
    _add_engine_flags(pr)
    pr.set_defaults(fn=cmd_run)

    pt = sub.add_parser("track",
                        help="full pipeline on raw stereo imagery")
    pt.add_argument("--left-dir", required=True)
    pt.add_argument("--right-dir", required=True)
    pt.add_argument("--start", type=int, default=0)
    pt.add_argument("--vocab", default=None,
                    help="voctree vocabulary file: enables live place "
                         "recognition + loop closure; trained from the "
                         "sequence itself if the file does not exist")
    pt.add_argument("--vocab-preset",
                    choices=("indoor", "outdoor", "outdoor-long"),
                    default="indoor",
                    help="voctree parameter preset (voctree_bf.h:24-43)")
    _add_engine_flags(pt)
    pt.set_defaults(fn=cmd_track)

    pv = sub.add_parser("view",
                        help="build the interactive HTML map viewer from a "
                             "run directory")
    pv.add_argument("--run", required=True, help="run output directory")
    pv.add_argument("--trajectory", default="trajectory.txt",
                    help="trajectory file within --run (e.g. "
                         "trajectory_refined.txt)")
    pv.add_argument("--out", default=None,
                    help="output html path (default <run>/map.html)")
    pv.set_defaults(fn=cmd_view)

    pg = sub.add_parser("gen", help="generate a sim sequence to disk")
    pg.add_argument("--frames", type=int, default=400)
    pg.add_argument("--noise-px", type=float, default=0.5)
    pg.add_argument("--rseed", type=int, default=4)
    pg.add_argument("--out", default=None)
    pg.set_defaults(fn=cmd_gen)

    args = p.parse_args(argv)
    from .utils.compcache import enable_persistent_cache
    enable_persistent_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
