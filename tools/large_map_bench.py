"""Large-map global bundle adjustment benchmark (matrix-free PCG Schur).

VERDICT r01 item 2: demonstrate that the scalable solver (ops/schur_cg.py,
the ITERATIVE_SCHUR analog of Ceres's sparse normal Cholesky at
/root/reference/src/lba_problem.cpp:96-131) handles a city-scale map —
thousands of keyframes, tens of thousands of line landmarks, >=100k
observations — on one chip, with memory linear in observations and the
wall-clock + achieved-FLOPs recorded.

The workload is a synthetic survey loop: cameras on a long circuit, line
landmarks anchored along the path (band-diagonal visibility like a real
sequence — each camera sees only nearby lines, each line is seen by ~a
dozen consecutive cameras).  Observations are exact projections of the
ground-truth lines plus pixel noise; the initial estimate perturbs every
camera (but the gauge-fixing first one) and every line, and the solver has
to pull the map back.

Usage:
    python tools/large_map_bench.py                 # default ~214k obs
    python tools/large_map_bench.py --cams 512 --lines-per-cam 4  # smaller
Prints one JSON dict with problem size, memory, wall-clock, FLOPs, and
accuracy: cost drop vs the noise-floor cost evaluated at ground truth, and
relative (consecutive-camera) pose recovery — the locally observable
quantity on a band-visibility survey loop.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

HALF_W = 327.783 / 406.05   # normalized image half-extent (parameter.h:43-52)
HALF_H = 237.172 / 406.05


def _path_poses(C: int, spacing: float = 0.78):
    """C world->cam poses on a circle, camera z along the tangent.

    The radius scales with C so consecutive cameras stay ``spacing`` apart
    — 0.78 m is the reference's real-sequence median keyframe spacing
    (traj_slslam_*_basize10 files; the 0.75 m keyframe gate).
    """
    radius = C * spacing / (2.0 * np.pi)
    th = np.linspace(0.0, 2.0 * np.pi, C, endpoint=False)
    pos = np.stack([radius * np.cos(th), np.zeros(C), radius * np.sin(th)],
                   axis=1)                                   # (C, 3) world
    z = np.stack([-np.sin(th), np.zeros(C), np.cos(th)], axis=1)  # tangent
    y = np.tile(np.array([0.0, 1.0, 0.0]), (C, 1))
    x = np.cross(y, z)
    R_cw = np.stack([x, y, z], axis=1)                       # rows = cam axes
    t = -np.einsum("cij,cj->ci", R_cw, pos)
    return R_cw, t, pos, z


def make_survey_problem(C=2048, lines_per_anchor=8, band_m=10.0,
                        noise_px=0.3, spacing=0.78, seed=0):
    """Synthesize the survey-loop BA problem (all vectorized numpy).

    band_m: metric look-ahead — camera c sees lines anchored within
    +-band_m meters along the path (so the track length in keyframes is
    independent of C).  Returns dict with GT cams/lines, observations, and
    index arrays.
    """
    rng = np.random.default_rng(seed)
    R_cw, t_wc, pos, tangent = _path_poses(C, spacing)
    band = max(1, int(round(band_m / spacing)))
    L = C * lines_per_anchor

    # landmarks: anchored at path point, lateral offset 3-9 m, random dir
    anchor = np.repeat(np.arange(C), lines_per_anchor)        # (L,)
    lateral = np.cross(np.array([0.0, 1.0, 0.0]), tangent)    # outward-ish
    off_r = rng.uniform(3.0, 9.0, L)[:, None]
    off_s = rng.choice([-1.0, 1.0], L)[:, None]
    off_h = rng.uniform(-2.0, 2.0, L)[:, None]
    p_on = (pos[anchor] + off_s * off_r * lateral[anchor]
            + off_h * np.array([0.0, 1.0, 0.0])
            + rng.uniform(-1.0, 1.0, (L, 3)))                 # point on line
    dv = rng.standard_normal((L, 3))
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    # closest point to origin of the infinite line through p_on along dv
    cp = p_on - (np.einsum("lj,lj->l", p_on, dv))[:, None] * dv
    lines_w = np.concatenate([cp, dv], axis=1)                # (L, 6)

    # visibility band: camera c sees lines with anchor in [c-band, c+band]
    # (wraparound on the loop)
    offs = np.arange(-band, band + 1)
    cam_of = (np.arange(C)[:, None, None] + offs[None, :, None]) % C  # C,B,1
    line_of = (cam_of * lines_per_anchor
               + np.arange(lines_per_anchor)[None, None, :])   # C,B,A
    obs_cam = np.repeat(np.arange(C), offs.size * lines_per_anchor)
    obs_line = line_of.reshape(-1)

    # project: line -> camera frame
    Rc = R_cw[obs_cam]                                        # (O,3,3)
    tc = t_wc[obs_cam]
    cpc = np.einsum("oij,oj->oi", Rc, lines_w[obs_line, :3]) + tc
    dvc = np.einsum("oij,oj->oi", Rc, lines_w[obs_line, 3:])

    def endpoints(n, s_mid, s_len):
        d2 = np.sqrt(n[:, 0] ** 2 + n[:, 1] ** 2)
        # RELATIVE degeneracy cut: n scales with the line's camera-frame
        # distance, so an absolute d2 floor admits rows whose residual
        # normalization amplifies f32 rounding ~1e4x (measured as a 165x
        # inflated cost-at-GT on the 2048-camera f32 run)
        nrm = np.linalg.norm(n, axis=1)
        ok = d2 > np.maximum(1e-3, 2e-2 * nrm)
        n = n / np.maximum(d2, 1e-12)[:, None]
        p0 = -n[:, 2:3] * n[:, :2]                            # foot point
        dir2 = np.stack([-n[:, 1], n[:, 0]], axis=1)
        a = p0 + (s_mid - 0.5 * s_len)[:, None] * dir2
        b = p0 + (s_mid + 0.5 * s_len)[:, None] * dir2
        inside = ((np.abs(a[:, 0]) < HALF_W) & (np.abs(a[:, 1]) < HALF_H)
                  & (np.abs(b[:, 0]) < HALF_W) & (np.abs(b[:, 1]) < HALF_H))
        return a, b, ok & inside

    O = len(obs_cam)
    s_mid = rng.uniform(-0.15, 0.15, O)
    s_len = rng.uniform(0.1, 0.4, O)
    n_l = np.cross(cpc, dvc)
    aL, bL, okL = endpoints(n_l, s_mid, s_len)
    cpr = cpc - np.array([0.12, 0.0, 0.0])
    n_r = np.cross(cpr, dvc)
    aR, bR, okR = endpoints(n_r, s_mid, s_len)

    # in front of the camera at the visible span (sample the midpoint depth)
    # closest point of the camera-frame line:
    cp_cam = cpc - np.einsum("oj,oj->o", cpc, dvc)[:, None] * dvc
    ok = okL & okR & (cp_cam[:, 2] > 1.0) & (cp_cam[:, 2] < 40.0)

    obs = np.concatenate([aL, bL, aR, bR], axis=1)            # (O, 8)
    obs += rng.standard_normal(obs.shape) * (noise_px / 406.05)

    obs, obs_cam, obs_line = obs[ok], obs_cam[ok], obs_line[ok]

    # keep only lines observed >= 2 times, and re-index compactly
    cnt = np.bincount(obs_line, minlength=L)
    keep = cnt >= 2
    remap = -np.ones(L, np.int64)
    remap[keep] = np.arange(keep.sum())
    sel = keep[obs_line]
    obs, obs_cam = obs[sel], obs_cam[sel]
    obs_line = remap[obs_line[sel]]
    lines_w = lines_w[keep]

    cam_wt = np.concatenate([
        np.stack([_so3_log(R) for R in R_cw]), t_wc], axis=1)  # (C, 6)
    return dict(cam_wt=cam_wt, lines_w=lines_w, obs=obs, obs_cam=obs_cam,
                obs_line=obs_line.astype(np.int64))


def _so3_log(R):
    from slslam.hostgeom import so3_log
    return so3_log(R)


def perturb_lines_metric(lines_w, sigma_cp_m, sigma_dir_rad, rng):
    """Perturb (cp, dv) lines in METRIC space, then re-normalize.

    Perturbing the orthonormal parameters directly is wildly non-uniform:
    theta encodes the origin distance d ~ cot(theta), so a 0.01 theta
    perturbation moves a 60 m-away line by tens of meters.  Real initial
    estimates carry metric triangulation noise; model that instead.
    """
    cp, dv = lines_w[:, :3].copy(), lines_w[:, 3:].copy()
    L = len(cp)
    dv = dv + rng.standard_normal((L, 3)) * sigma_dir_rad
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    cp = cp + rng.standard_normal((L, 3)) * sigma_cp_m
    cp = cp - np.einsum("lj,lj->l", cp, dv)[:, None] * dv  # re-orthogonalize
    return np.concatenate([cp, dv], axis=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=2048)
    ap.add_argument("--lines-per-cam", type=int, default=8)
    ap.add_argument("--band-m", type=float, default=10.0)
    ap.add_argument("--spacing", type=float, default=0.78)
    ap.add_argument("--noise-px", type=float, default=0.3)
    ap.add_argument("--cam-sigma-rot", type=float, default=0.005)
    ap.add_argument("--cam-sigma-t", type=float, default=0.05)
    ap.add_argument("--line-sigma-cp-m", type=float, default=0.05)
    ap.add_argument("--line-sigma-dir-rad", type=float, default=0.005)
    ap.add_argument("--max-iters", type=int, default=30)
    ap.add_argument("--cg-iters", type=int, default=100)
    ap.add_argument("--warm-runs", type=int, default=2)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--prior", action="store_true",
                    help="fuse the initial estimate's odometry chain as "
                         "a weak pose-graph prior (global_ba_cg prior_c) "
                         "— pins the survey loop's band-visibility null "
                         "modes, which f32 otherwise wanders in")
    args = ap.parse_args(argv)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from slslam import geometry as geo
    from slslam.ops.schur_cg import global_ba_cg_impl, pack_line_major

    platform = jax.devices()[0].platform
    dtype = jnp.float64 if platform == "cpu" and jax.config.jax_enable_x64 \
        else jnp.float32

    t0 = time.perf_counter()
    prob = make_survey_problem(C=args.cams,
                               lines_per_anchor=args.lines_per_cam,
                               band_m=args.band_m, spacing=args.spacing,
                               noise_px=args.noise_px)
    C = len(prob["cam_wt"])
    L = len(prob["lines_w"])
    O = len(prob["obs"])
    gen_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    packed = pack_line_major(prob["obs"], prob["obs_cam"], prob["obs_line"],
                             C, L)
    pack_s = time.perf_counter() - t0

    rng = np.random.default_rng(7)
    cam0 = prob["cam_wt"].copy()
    cam0[1:, :3] += rng.standard_normal((C - 1, 3)) * args.cam_sigma_rot
    cam0[1:, 3:] += rng.standard_normal((C - 1, 3)) * args.cam_sigma_t
    lines0 = perturb_lines_metric(prob["lines_w"], args.line_sigma_cp_m,
                                  args.line_sigma_dir_rad, rng)
    orth0 = np.asarray(geo.av_to_orth(jnp.asarray(lines0)))
    cam_free = np.ones(C, bool)
    cam_free[0] = False

    prior_c = None
    if args.prior:
        from slslam.hostgeom import Pose
        chain = [Pose.from_wt(w) for w in cam0]
        prior_c = jnp.asarray(np.stack([
            (chain[i + 1] @ chain[i].inv()).wt()
            for i in range(C - 1)]), dtype)

    solve = jax.jit(
        lambda *a: global_ba_cg_impl(*a, robust=True,
                                     max_iters=args.max_iters,
                                     cg_iters=args.cg_iters,
                                     prior_c=prior_c,
                                     prior_sigma_rot=0.2,
                                     prior_sigma_t=2.0))
    ba = (jnp.asarray(cam0, dtype), jnp.asarray(orth0, dtype),
          jnp.asarray(packed.obs, dtype),
          jnp.asarray(packed.obs_cam, jnp.int32),
          jnp.asarray(packed.obs_valid),
          jnp.asarray(packed.cam_perm, jnp.int32),
          jnp.asarray(packed.cam_perm_valid),
          jnp.asarray(cam_free), jnp.ones(L, bool),
          jnp.asarray(0.12, dtype), jnp.asarray(1.0 / 406.05, dtype))

    # noise-floor cost: the robust cost evaluated AT ground truth — the
    # target an exact ML solve should reach (absolute ATE is not the right
    # recovery metric here: a long survey loop observed band-locally has
    # weakly observable low-frequency bending modes, like any odometry-
    # constrained SLAM problem)
    from slslam.ops.schur_cg import _eval_system_lm
    orth_gt = np.asarray(geo.av_to_orth(jnp.asarray(prob["lines_w"])))
    gt_cost = float(jax.jit(
        lambda cw, lo: _eval_system_lm(
            cw, lo, jnp.asarray(packed.obs, dtype),
            jnp.asarray(packed.obs_cam, jnp.int32),
            jnp.asarray(packed.obs_valid, dtype),
            jnp.asarray(packed.cam_perm, jnp.int32),
            jnp.asarray(packed.cam_perm_valid),
            jnp.ones(C, dtype), jnp.ones(L, dtype),
            jnp.asarray(0.12, dtype), jnp.asarray(1.0 / 406.05, dtype),
            True, "orth")[0])(
        jnp.asarray(prob["cam_wt"], dtype), jnp.asarray(orth_gt, dtype)))

    lowered = solve.lower(*ba)
    compiled = lowered.compile()
    cost_an = compiled.cost_analysis() or {}
    mem_an = compiled.memory_analysis()
    flops = float(cost_an.get("flops", 0.0))
    bytes_acc = float(cost_an.get("bytes accessed", 0.0))
    hbm_bytes = None
    if mem_an is not None:
        hbm_bytes = int(getattr(mem_an, "temp_size_in_bytes", 0)
                        + getattr(mem_an, "argument_size_in_bytes", 0)
                        + getattr(mem_an, "output_size_in_bytes", 0))

    t0 = time.perf_counter()
    cam1, line1, stats = compiled(*ba)
    jax.block_until_ready(cam1)
    cold_s = time.perf_counter() - t0

    walls = []
    for _ in range(args.warm_runs):
        t0 = time.perf_counter()
        cam1, line1, stats = compiled(*ba)
        jax.block_until_ready(cam1)
        walls.append(time.perf_counter() - t0)
    warm_s = min(walls) if walls else cold_s

    cam1 = np.asarray(cam1)
    t_err = np.linalg.norm(cam1[:, 3:] - prob["cam_wt"][:, 3:], axis=1)
    t_err0 = np.linalg.norm(cam0[:, 3:] - prob["cam_wt"][:, 3:], axis=1)

    def rpe(cam):
        """Mean consecutive relative-translation error vs GT (the locally
        observable quantity; wraps around the loop)."""
        from slslam.hostgeom import rodrigues
        R = np.stack([rodrigues(w) for w in cam[:, :3]])
        pos = -np.einsum("cji,cj->ci", R, cam[:, 3:])        # camera centers
        Rg = np.stack([rodrigues(w) for w in prob["cam_wt"][:, :3]])
        pg = -np.einsum("cji,cj->ci", Rg, prob["cam_wt"][:, 3:])
        d = np.einsum("cij,cj->ci", R, np.roll(pos, -1, 0) - pos)
        dg = np.einsum("cij,cj->ci", Rg, np.roll(pg, -1, 0) - pg)
        return float(np.linalg.norm(d - dg, axis=1).mean())
    iters = int(stats.iterations)
    # flops estimate is the full max_iters trace; scale to executed iters
    flops_exec = flops * (iters + 1) / (args.max_iters + 1) if flops else 0.0

    out = dict(
        platform=platform, dtype=str(dtype.__name__ if hasattr(
            dtype, "__name__") else dtype),
        num_cams=C, num_lines=L, num_obs=O,
        kL=packed.kL, kC=packed.kC,
        fill=round(packed.fill, 3),
        gen_s=round(gen_s, 2), pack_s=round(pack_s, 2),
        cold_s=round(cold_s, 2), warm_s=round(warm_s, 3),
        iterations=iters,
        initial_cost=float(stats.initial_cost),
        final_cost=float(stats.final_cost),
        cost_at_gt=gt_cost,
        cost_vs_noise_floor=round(float(stats.final_cost) / gt_cost, 3)
        if gt_cost > 0 else None,
        mean_cam_t_err_init_m=round(float(t_err0.mean()), 4),
        mean_cam_t_err_final_m=round(float(t_err.mean()), 4),
        rpe_init_m=round(rpe(cam0), 5),
        rpe_final_m=round(rpe(cam1), 5),
        hbm_bytes=hbm_bytes,
        hbm_gb=round(hbm_bytes / 2**30, 3) if hbm_bytes else None,
        xla_flops_per_solve=flops,
        achieved_gflops_s=round(flops_exec / warm_s / 1e9, 1)
        if flops else None,
        achieved_hbm_gb_s=round(
            bytes_acc * (iters + 1) / (args.max_iters + 1)
            / warm_s / 1e9, 1) if bytes_acc else None,
        obs_per_s=round(O * max(iters, 1) / warm_s / 1e6, 2),
    )
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
