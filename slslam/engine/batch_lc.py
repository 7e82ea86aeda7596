"""Loop closure on the device-resident replay path.

The reference interleaves place recognition, loop closure and pose-graph
optimization with the per-frame loop (/root/reference/src/main.cpp:64-67,
src/slam.cpp:1108-1313) because it is an online, causal system.  For replay
/ mapping workloads (the reference's only released mode) the device-resident
design defers loop closure to a post-pass over the keyframes, which keeps
the whole odometry replay inside one ``lax.scan`` (engine/batch.py) and
turns the loop-closure work into three more device dispatches:

  1. **replay** — the batch engine scans the full sequence (no host round
     trips), producing keyframes, the odometry edge chain and landmarks;
  2. **recognition** — the voctree place recognizer consumes the keyframe
     descriptors in order (quantization and scoring are jitted; the
     quarantine/posterior bookkeeping is host-side, off the hot path);
  3. **relative pose** — each detection's matched observation pairs go
     through the same fused RANSAC + motion-only-BA kernel the odometry
     uses (ops/vo_pipeline.py; reference: loop_closure -> pose_estimation,
     slam.cpp:1146-1149), yielding a loop edge;
  4. **pose-graph optimization** — the odometry chain + loop edges solve
     on device (ops/pose_graph.py; reference: slam.cpp:1236-1313), gated
     by the same consistency check (consistency_broken, slam.cpp:1215-1232);
  5. optionally a **merged global refine**: loop-matched feature tracks
     are unioned (the reference's landmark merge, slam.cpp:1162-1208, as
     id unification) and one global bundle adjustment polishes every pose
     and line — a step the reference's sliding-window design cannot do.

The final trajectory is identical in information content to the
reference's online result (same constraints, same solvers); deferring
merely changes *when* the graph is stitched.  Accuracy is typically better
because the global refine optimizes everything jointly.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig, bucket_for
from ..hostgeom import Pose
from ..ops.pose_graph import pose_graph_opt
from ..ops.triangulate import (triangulate_lines,
                                triangulate_lines_host)
from ..ops.vo_pipeline import vo_body
from .batch import BatchResult, BatchSlam


@dataclasses.dataclass
class LoopEvent:
    old_kf: int               # keyframe index recognized
    new_kf: int               # current keyframe index
    n_matches: int            # descriptor matches offered
    ransac_score: int         # RANSAC inliers of the relative-pose solve
    wt_rel: Optional[np.ndarray]   # (6,) T_new * T_old^-1, None if rejected
    accepted: bool            # True only for edges actually fed to PGO
    deduped: bool = False     # True: span-mate of an edge, never solved
    joint: bool = False       # True: from the odometry-anchored joint
                              # span re-solve (_span_joint_resolve)


@dataclasses.dataclass
class BatchLCResult:
    base: BatchResult                 # odometry-only replay result
    trajectory: List[Pose]            # stitched camera-to-world trajectory
    events: List[LoopEvent]
    merged_fids: Dict[int, int]       # feature id -> merged root id
    stats: Dict[str, float]
    refined: Optional[object] = None  # engine.refine.RefineResult


def _span_solve_body(o0, o1, valid, key, baseline, error_thr, huber_delta,
                     inverse_depth, max_t_norm, num_hyp, sample_size,
                     robust, vo_iters, refit_iters, line_param,
                     relin_iters):
    """Device body for ONE span representative's relative-pose solve.

    Mirrors SLAM::loop_closure's obs0/obs1 construction + pose_estimation
    (slam.cpp:1121-1149): o0 = the old keyframe's observations of the
    matched features, o1 = the current keyframe's; lines triangulated in
    the old keyframe's frame; then a joint 2-camera FREE-LINE bundle
    adjustment over ALL offered pairs (robust Huber) and per-pair scoring
    against the REFIT lines.  Gating on lines triangulated from the old
    keyframe's single stereo pair (r2/r3a behavior) rejects genuine
    closures wholesale at place-recognition distances — stereo depth
    noise scales z^2/(b f), ~1 m per line at the 8-17 m where
    terminal-approach recognition fires (measured: every
    olympic4f/myungdong closure solve failed the 5 px gate).  The joint
    two-stereo-pair fit is the unbiased estimate; wrong correspondences
    cannot fit both views and still fail the gate.  cam0 = old kf
    (gauge), cam1 = the loop edge.

    Returns (ransac_score, wt_vo, wt_polished, pair_err): all gating
    happens on the host after ONE fetch for the whole batch of spans.
    """
    from .. import geometry as geo
    from ..ops.residuals import lba_residual_batch
    from ..ops.schur_ba import local_ba_impl

    N = o0.shape[0]
    dtype = o0.dtype
    lines = triangulate_lines(o0, baseline, inverse_depth=inverse_depth)
    res = vo_body(o0, o1, lines, valid, key, baseline, error_thr,
                  huber_delta, max_t_norm=max_t_norm, num_hyp=num_hyp,
                  sample_size=sample_size, robust=robust,
                  max_iters=vo_iters, line_param=line_param,
                  relin_iters=relin_iters)

    cam2 = jnp.stack([jnp.zeros(6, dtype), res.wt])
    orth = geo.av_to_orth(lines)
    obs2 = jnp.concatenate([o0, o1])
    oc2 = jnp.concatenate([jnp.zeros(N, jnp.int32), jnp.ones(N, jnp.int32)])
    ol2 = jnp.concatenate([jnp.arange(N, dtype=jnp.int32)] * 2)
    ov2 = jnp.concatenate([valid, valid])
    cfree = jnp.asarray(np.array([False, True]))
    cam_out, line_out, _ = local_ba_impl(
        cam2, orth, obs2, oc2, ol2, ov2, cfree, valid,
        baseline, huber_delta, robust=robust, max_iters=refit_iters)

    # per-pair max residual across BOTH views under the refit
    # (slam.cpp:305-314 role, on the joint estimate)
    r = lba_residual_batch(cam_out[oc2], line_out[ol2], obs2, baseline)
    err2 = jnp.abs(r).max(axis=1)
    pair_err = jnp.maximum(err2[:N], err2[N:])
    return res.ransac_score, res.wt, cam_out[1], pair_err


@functools.partial(
    jax.jit, static_argnames=("inverse_depth", "max_t_norm", "num_hyp",
                              "sample_size", "robust", "vo_iters",
                              "refit_iters", "line_param", "relin_iters"))
def _span_solve_batch(o0S, o1S, validS, keys, baseline, error_thr,
                      huber_delta, *, inverse_depth, max_t_norm, num_hyp,
                      sample_size, robust, vo_iters, refit_iters,
                      line_param, relin_iters):
    """ALL span representatives' solves in ONE dispatch (vmap over the
    span axis).  r3 issued each span's triangulation, fused VO, joint
    refit and scoring as 3-4 individual device calls — the spans are
    independent fixed-shape problems, exactly what vmap exists for."""
    fn = functools.partial(
        _span_solve_body, inverse_depth=inverse_depth,
        max_t_norm=max_t_norm, num_hyp=num_hyp, sample_size=sample_size,
        robust=robust, vo_iters=vo_iters, refit_iters=refit_iters,
        line_param=line_param, relin_iters=relin_iters)
    return jax.vmap(fn, in_axes=(0, 0, 0, 0, None, None, None))(
        o0S, o1S, validS, keys, baseline, error_thr, huber_delta)


_SPAN_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

# Confirm-stage knobs (measured on the 1000-kf run + the wlc proxy
# pairs).  The quality-critical solvers keep full LM: a fixed-lambda
# 15-iteration GN swap for the group fits and a lines-GN pre-stage
# before the joint polish were both tried for speed and REJECTED —
# each independently killed olympic4f seed-0's rescue closure (0
# accepted vs the record's 9/9 improvement; the pre-stage fits lines
# against the lane's unconverged cameras and flattens the vote).  The
# confirm wall's actual cost was the HOST candidate-pose loop + the
# all-rows scoring pack at 1000 kf, fixed in
# _joint_confirm_jobs without touching solver math.
_POLISH_LM_ITERS = 30      # joint-polish LM cap (the r4 value)
_SCORE_ROWS_CAP = 64       # rows per span scored when picking the
                           # RANSAC alignment candidate (24 was measured
                           # too coarse on olympic4f's rescue spans)


def _merged_inlier_frac(ref, frames_m, is_kf, merged, cfg: SlamConfig):
    """Fraction of MERGED-track observations within the inlier threshold
    under a refine result — does this basin explain the loop evidence?
    (See the counterfactual basin selection in BatchSlamLC.run.)"""
    from ..hostgeom import av_to_orth_np
    from ..ops.residuals import lba_residual_batch
    from .refine import build_problem_structure

    roots = set(merged.values())
    if not roots:
        return 1.0
    s = build_problem_structure(frames_m, is_kf)
    lid = {f: i for i, f in enumerate(ref.feature_ids)}
    sel = np.asarray([o for o in range(len(s.olin))
                      if s.feat_ids[s.olin[o]] in roots
                      and s.feat_ids[s.olin[o]] in lid], np.int64)
    if len(sel) == 0:
        return 1.0
    cam_wt = np.stack([T.inv().wt() for T in ref.trajectory])
    orth = av_to_orth_np(ref.lines_world)
    rows_l = np.asarray([lid[s.feat_ids[s.olin[o]]] for o in sel])
    dtype = jnp.dtype(cfg.compute_dtype)
    n = len(sel)
    nb = -(-n // 1024) * 1024
    pad = lambda a, w: (np.concatenate([a, np.zeros((nb - n, w))])
                        if nb > n else a)
    r = lba_residual_batch(
        jnp.asarray(pad(cam_wt[s.ocam[sel]], 6), dtype),
        jnp.asarray(pad(orth[rows_l], 4), dtype),
        jnp.asarray(pad(s.obs[sel], 8), dtype), cfg.camera.baseline)
    err = np.abs(np.asarray(r, np.float64)[:n]).max(axis=1)
    # (fraction at the acceptance threshold, fraction at HALF of it).
    # The half-threshold fraction is the discriminator: a basin that
    # absorbed genuine drift by bending (rather than jumping) still
    # clears the loose gate but its merged-track fits are strained —
    # measured on olympic4f s1, the odometry-init refine pulled 3.10 ->
    # 2.25 m and saturated the loose fraction while the correct stitched
    # basin sat at 1.11 m
    return (float(np.mean(err < cfg.error_thr)),
            float(np.mean(err < 0.5 * cfg.error_thr)))


def _solve_span_round(cands, frames, kf_idx, cfg: SlamConfig, dtype,
                      base_key):
    """Solve one round of span representatives [(k, old_k, match), ...]
    with a single device dispatch; returns per-candidate
    (wt | None, score, n_offered, inl_pairs) with gating semantics
    identical to the r3 sequential path."""
    per = []
    solve_rows = []
    for (k, old_k, match) in cands:
        obs_new = frames[kf_idx[k]]
        obs_old = frames[kf_idx[old_k]]
        pairs = [(nf, of) for nf, of in match.items()
                 if nf in obs_new and of in obs_old]
        per.append({"pairs": pairs, "n": len(pairs)})
        if len(pairs) >= cfg.ransac_min_sample:
            solve_rows.append((len(per) - 1, k, old_k, pairs))

    results = [(None, 0, p["n"], {}) for p in per]
    if not solve_rows:
        return results

    N = bucket_for(max(len(r[3]) for r in solve_rows), cfg.corr_buckets)
    S = bucket_for(len(solve_rows), _SPAN_BUCKETS)
    o0 = np.zeros((S, N, 8))
    o1 = np.zeros((S, N, 8))
    valid = np.zeros((S, N), bool)
    keys = []
    for s, (_, k, old_k, pairs) in enumerate(solve_rows):
        obs_new = frames[kf_idx[k]]
        obs_old = frames[kf_idx[old_k]]
        for i, (nf, of) in enumerate(pairs):
            o0[s, i] = obs_old[of]
            o1[s, i] = obs_new[nf]
            valid[s, i] = True
        keys.append(jax.random.fold_in(base_key, int(kf_idx[k])))
    # padding spans re-solve row 0 (cheap, masked out on the host side)
    keys.extend([keys[0]] * (S - len(solve_rows)))
    o0[len(solve_rows):] = o0[0]
    o1[len(solve_rows):] = o1[0]
    valid[len(solve_rows):] = valid[0]

    score_d, wt_vo_d, wt_pol_d, pair_err_d = jax.device_get(
        _span_solve_batch(
            jnp.asarray(o0, dtype), jnp.asarray(o1, dtype),
            jnp.asarray(valid), jnp.stack(keys),
            jnp.asarray(cfg.camera.baseline, dtype),
            jnp.asarray(cfg.error_thr, dtype),
            jnp.asarray(cfg.huber_delta, dtype),
            inverse_depth=cfg.inverse_depth,
            max_t_norm=cfg.lc_defer_max_t_norm,
            num_hyp=cfg.ransac_num_hypotheses,
            sample_size=cfg.ransac_min_sample,
            robust=cfg.robust, vo_iters=cfg.moba_max_iter,
            refit_iters=25,
            line_param=cfg.line_param,
            relin_iters=cfg.vo_relin_iters))

    for s, (ci, k, old_k, pairs) in enumerate(solve_rows):
        n = len(pairs)
        wt = np.asarray(wt_vo_d[s], np.float64)
        # plausibility: the RANSAC must find SOME support and a finite
        # model (slam.cpp:295-298's absolute floor); the decisive
        # acceptance gate runs on the joint refit below
        if int(score_d[s]) < cfg.ransac_min_sample \
                or not np.all(np.isfinite(wt)):
            results[ci] = (None, int(max(score_d[s], 0)), n, {})
            continue
        wt_polished = np.asarray(wt_pol_d[s], np.float64)
        if np.all(np.isfinite(wt_polished)):
            wt = wt_polished
        final_inl = (np.asarray(pair_err_d[s], np.float64)
                     < cfg.error_thr) & valid[s]
        n_final = int(np.sum(final_inl))
        min_score = max(cfg.lc_min_inliers,
                        int(np.ceil(cfg.lc_min_inlier_ratio * n)))
        if n_final < min_score:
            results[ci] = (None, n_final, n, {})
            continue
        # geometrically verified pairs only: the merge feeds the global
        # refine, where one wrong identification couples two distinct 3D
        # lines and bends the whole solution (measured on the myungdong
        # proxy: merging all descriptor matches of an accepted span drove
        # the refined ATE 4 m -> 18 m)
        inl_pairs = {nf: of for (nf, of), good in zip(pairs, final_inl[:n])
                     if good}
        results[ci] = (wt, n_final, n, inl_pairs)
    return results


class _JointPrep:
    """Host-packed joint multi-keyframe problem for one span (the packing
    part of the r4 _span_joint_resolve; see _joint_confirm_jobs for the
    recipe and measurements)."""

    def __init__(self, span, frames, kf_idx, traj, cfg: SlamConfig):
        self.span = span
        self.old_ks = sorted({c[1] for c in span})
        self.new_ks = sorted({c[0] for c in span})
        self.cams = self.old_ks + self.new_ks
        self.cam_of = {g: i for i, g in enumerate(self.cams)}
        self.gauge = traj[self.old_ks[0]]
        # pose of camera g (world->cam) in the gauge frame
        self.cam_wt = np.stack([(traj[g].inv() @ self.gauge).wt()
                                for g in self.cams])
        self.Qg = {g: traj[g].inv() @ traj[self.new_ks[0]]
                   for g in self.new_ks}
        self.M_odo = traj[self.new_ks[0]].inv() @ traj[self.old_ks[0]]

        line_ids: List[int] = []
        line_of: Dict[int, int] = {}
        line_first: Dict[int, Tuple[int, np.ndarray]] = {}
        rows, ocam, olin = [], [], []
        pair_rows: Dict[Tuple[int, int], List[int]] = {}
        row_of: Dict[Tuple[int, int, int], int] = {}
        for (k, old_k, match) in span:
            fr_new, fr_old = frames[kf_idx[k]], frames[kf_idx[old_k]]
            for nf, of in match.items():
                if nf not in fr_new or of not in fr_old:
                    continue
                li = line_of.get(of)
                if li is None:
                    li = line_of[of] = len(line_ids)
                    line_ids.append(of)
                    line_first[of] = (old_k, fr_old[of])
                for g, fid, o8 in ((old_k, of, fr_old[of]),
                                   (k, nf, fr_new[nf])):
                    key = (g, fid, li)
                    ri = row_of.get(key)
                    if ri is None:
                        ri = row_of[key] = len(rows)
                        rows.append(o8)
                        ocam.append(self.cam_of[g])
                        olin.append(li)
                    pair_rows.setdefault((nf, of), []).append(ri)
        self.line_ids = line_ids
        self.line_of = line_of
        self.line_first = line_first
        self.rows = np.asarray(rows).reshape(-1, 8)
        self.ocam = np.asarray(ocam, np.int32)
        self.olin = np.asarray(olin, np.int32)
        self.pair_rows = pair_rows
        self.n = len(pair_rows)
        self.C = len(self.cams)
        self.L = len(line_ids)
        self.min_score = max(cfg.lc_min_inliers,
                             int(np.ceil(cfg.lc_min_inlier_ratio
                                         * max(self.n, 1))))

@functools.partial(
    jax.jit, static_argnames=("robust", "max_iters", "line_param"))
def _group_fit_many(cam, line, obs, ocam, olin, ovalid, lfree, baseline,
                    huber_delta, *, robust, max_iters, line_param):
    """All spans' per-group lines-only BAs in ONE dispatch (cameras fixed
    at the in-group odometry).

    This stays the full LM solver (not the fixed-iteration lines-GN):
    the group clouds seed the RANSAC line-cloud alignment, and swapping
    in a fixed-lambda 15-iteration GN here was measured to kill the
    olympic4f rescue closures outright (0 accepted on seeds 0-1 vs the
    record's 9/9 improvement — far-from-basin lines stall without LM's
    lambda adaptation).  The stage is cheap anyway: the r5 confirm wall
    was the HOST candidate-pose loop (see _joint_confirm_jobs), not
    these solves."""
    from ..ops.schur_ba import local_ba_impl

    def one(c, l, o, oc, ol, ov, lf):
        cfree = jnp.zeros(c.shape[0], bool)
        return local_ba_impl(c, l, o, oc, ol, ov, cfree, lf, baseline,
                             huber_delta, robust=robust,
                             max_iters=max_iters, line_param=line_param)

    return jax.vmap(one)(cam, line, obs, ocam, olin, ovalid, lfree)


@functools.partial(
    jax.jit, static_argnames=("robust", "max_iters", "line_param"))
def _joint_polish_many(cam, line, obs, ocam, olin, ovalid, cfree,
                       lfree, ei, ej, ec, esig, baseline, huber_delta, *,
                       robust, max_iters, line_param):
    """All confirm lanes' joint BA polishes in ONE dispatch.  r4 ran
    each span's joint solve serially — latency-bound CG steps that were
    most of the 1000-keyframe wall.  The lanes are vmapped over the
    DENSE Schur solver with pose-prior edges
    (ops/schur_ba.py prior_edges): span problems are window-sized, and
    the dense path runs ONE device step per LM iteration — the first r5
    attempt vmapped the matrix-free CG solver, whose nested while loops
    ran max-over-lanes tiny matvecs at both levels.  obs must be
    camera-major contiguous per lane (any assembly mode applies).

    NO lines-GN pre-stage here, deliberately: pre-fitting the lines
    against the lane's unconverged cameras flattens the joint vote
    (measured: olympic4f seed-0's rescue closure went from accepted to
    0 accepted with a 6-iteration pre-stage; the staged-solve trick
    that helps the window BA hurts hypothesis RACING, where lanes must
    stay distinguishable)."""
    from ..ops.schur_ba import default_assembly, local_ba_impl

    assembly = default_assembly(jax.default_backend())

    def one(c, l, o, oc, ol, ov, cf, lf, i1, j1, c1, s1):
        return local_ba_impl(c, l, o, oc, ol, ov, cf, lf, baseline,
                             huber_delta, robust=robust,
                             max_iters=max_iters, line_param=line_param,
                             assembly=assembly,
                             prior_edges=(i1, j1, c1, s1))

    return jax.vmap(one)(cam, line, obs, ocam, olin, ovalid, cfree,
                         lfree, ei, ej, ec, esig)


@dataclasses.dataclass
class _LaneResult:
    init_name: str            # "edge" | "aligned" | "odometry"
    old_rep: int
    k_rep: int
    wt: np.ndarray            # (6,) joint-estimate loop edge
    inl_pairs: Dict[int, int]
    n_final: int
    n: int
    vote_ok: bool


def _fit_group_problems(preps, traj, cfg: SlamConfig, dtype,
                        timing=None):
    """Stage 1 for every rescue span: both groups' multi-view line fits
    (cameras fixed at the in-group odometry, lines free), all in one
    vmapped dispatch.  Returns {prep_idx: (lines_A, cntA, lines_B, cntB)}
    — lines in each group's LOCAL frame (group's first keyframe).

    The groups each span several keyframes, so line depth comes from
    meters of baseline instead of the 0.12 m stereo pair (the 2-camera
    representative solve fails on weak-mode spans: one stereo pair per
    side leaves a translation direction nearly unobservable — the
    olympic4f terminal edge was 9.5 m wrong despite a 40/60 refit vote).
    """
    from ..hostgeom import av_to_orth_np, orth_to_av_np

    t_sub = time.perf_counter()
    jobs = []   # (prep_idx, side, grp, cw, rws, oc, ol, cnt, init)
    for pi, prep in preps:
        for side in ("old", "new"):
            grp = prep.old_ks if side == "old" else prep.new_ks
            gidx = {g: i for i, g in enumerate(grp)}
            loc = traj[grp[0]]
            cw = np.stack([(traj[g].inv() @ loc).wt() for g in grp])
            # group rows: this side's packed observation rows, deduped
            # per (camera, line) — the solvers' unique-pair invariant
            side_rows = []
            seen_go = set()
            for ri in range(len(prep.rows)):
                if (prep.ocam[ri] >= len(prep.old_ks)) != (side == "new"):
                    continue
                key = (int(prep.ocam[ri]), int(prep.olin[ri]))
                if key in seen_go:
                    continue
                seen_go.add(key)
                side_rows.append(ri)
            rws = prep.rows[side_rows]
            oc_l = np.asarray([gidx[prep.cams[prep.ocam[ri]]]
                               for ri in side_rows], np.int32)
            ol_l = prep.olin[side_rows]
            jobs.append((pi, side, grp, cw, rws, oc_l, ol_l))

    if not jobs:
        return {}
    if timing is not None:
        timing["group_fits_rows"] = round(time.perf_counter() - t_sub, 3)
        t_sub = time.perf_counter()

    Gb = bucket_for(max(len(j[2]) for j in jobs), cfg.cam_buckets)
    Lb = bucket_for(max(p.L for _, p in preps), cfg.line_buckets)
    Ob = bucket_for(max(len(j[4]) for j in jobs), cfg.obs_buckets)
    S = bucket_for(len(jobs), _SPAN_BUCKETS)

    # one batched triangulation for every job's line inits
    tri_cat = triangulate_lines_host(
        np.concatenate([j[4] for j in jobs]), cfg.camera.baseline,
        inverse_depth=cfg.inverse_depth, dtype=dtype)
    if timing is not None:
        timing["group_fits_tri"] = round(time.perf_counter() - t_sub, 3)
        t_sub = time.perf_counter()

    cam_b = np.zeros((S, Gb, 6))
    line_b = np.zeros((S, Lb, 4))
    line_b[:, :, 3] = 0.5
    obs_b = np.zeros((S, Ob, 8))
    oc_b = np.zeros((S, Ob), np.int32)
    ol_b = np.zeros((S, Ob), np.int32)
    ov_b = np.zeros((S, Ob), bool)
    lf_b = np.zeros((S, Lb), bool)
    cnts = []
    pos = 0
    for s, (pi, side, grp, cw, rws, oc_l, ol_l) in enumerate(jobs):
        nr = len(rws)
        tri = tri_cat[pos:pos + nr]
        pos += nr
        cam_b[s, :len(grp)] = cw
        obs_b[s, :nr] = rws
        oc_b[s, :nr] = oc_l
        ol_b[s, :nr] = ol_l
        ov_b[s, :nr] = True
        cnt = np.bincount(ol_l, minlength=Lb)
        cnts.append(cnt)
        lf_b[s] = cnt > 0
        init = np.zeros((Lb, 6))
        init[:, 5] = 1.0
        seenl = set()
        for i in range(nr):
            li = int(ol_l[i])
            if li in seenl:
                continue
            seenl.add(li)
            P = Pose.from_wt(cw[oc_l[i]]).inv()
            init[li, :3] = P.R @ tri[i, :3] + P.t
            init[li, 3:] = P.R @ tri[i, 3:]
        line_b[s] = av_to_orth_np(init)
    # padding lanes re-solve lane 0 (masked out on the host side)
    for s in range(len(jobs), S):
        cam_b[s], line_b[s], obs_b[s] = cam_b[0], line_b[0], obs_b[0]
        oc_b[s], ol_b[s], ov_b[s], lf_b[s] = (oc_b[0], ol_b[0], ov_b[0],
                                              lf_b[0])

    if timing is not None:
        timing["group_fits_pack"] = round(time.perf_counter() - t_sub, 3)
    t_pack = time.perf_counter()
    _, line_out, _ = _group_fit_many(
        jnp.asarray(cam_b, dtype), jnp.asarray(line_b, dtype),
        jnp.asarray(obs_b, dtype), jnp.asarray(oc_b), jnp.asarray(ol_b),
        jnp.asarray(ov_b), jnp.asarray(lf_b),
        jnp.asarray(cfg.camera.baseline, dtype),
        jnp.asarray(cfg.huber_delta, dtype),
        robust=True, max_iters=max(cfg.max_num_iter, 25),
        line_param=cfg.line_param)
    line_out = np.asarray(line_out, np.float64)
    if timing is not None:
        timing["group_fits_solve"] = round(time.perf_counter() - t_pack, 3)

    out = {}
    for s, (pi, side, grp, cw, rws, oc_l, ol_l) in enumerate(jobs):
        lines = orth_to_av_np(line_out[s])
        cur = out.setdefault(pi, [None, None, None, None])
        if side == "old":
            cur[0], cur[1] = lines, cnts[s]
        else:
            cur[2], cur[3] = lines, cnts[s]
    return {pi: tuple(v) for pi, v in out.items()}


def _ransac_align(prep: "_JointPrep", linesA, cntA, linesB, cntB,
                  cfg: SlamConfig):
    """Stage 2: RANSAC line-cloud alignment X_B = S(X_A) — direction
    Wahba + closest-point projector least-squares on sampled line
    triples, sign-disambiguated by the odometry rotation.  Returns the
    candidate list (odometry-implied appended as the fallback) and the
    scoring rows; the caller scores ALL spans' candidates in one batched
    residual call and argmaxes per span.

    (A direct joint BA from the odometry init stalls in a
    split-the-difference local minimum — the free lines absorb the
    misalignment under Huber's flat tails — and a weak cross-group
    odometry prior pins the solve AT odometry: measured n_final 20-30/72
    for every such variant vs 49/72 for this recipe, whose best
    alignment landed 0.97 m from ground truth; PERF_HISTORY r4.)
    """
    M_odo = prep.M_odo
    nzA = np.linalg.norm(linesA[:, 3:], axis=1)
    nzB = np.linalg.norm(linesB[:, 3:], axis=1)
    usable = (cntA > 0) & (cntB > 0) & (nzA > 1e-9) & (nzB > 1e-9)
    vA = linesA[:, 3:] / np.maximum(nzA, 1e-30)[:, None]
    vB = linesB[:, 3:] / np.maximum(nzB, 1e-30)[:, None]
    aA, aB = linesA[:, :3], linesB[:, :3]

    def fit_S_batch(idxs, w=None):
        """(J, k) sample index sets -> (J, 3, 3) R, (J, 3) t, (J,) ok —
        all J candidate fits in one batched numpy pass (the r5a
        per-candidate loop ran 256 sequential 3x3 SVD fits per span and
        dominated the confirm wall at 1000-kf scale once every span
        started running the rescue stages)."""
        J, k = idxs.shape
        if w is None:
            w = np.ones((J, k))
        vAi, vBi = vA[idxs], vB[idxs]            # (J, k, 3)
        aAi, aBi = aA[idxs], aB[idxs]
        R = np.broadcast_to(M_odo.R, (J, 3, 3)).copy()
        t = np.broadcast_to(M_odo.t, (J, 3)).copy()
        P = (np.eye(3)[None, None]
             - vBi[..., :, None] * vBi[..., None, :])   # (J, k, 3, 3)
        A_t = np.einsum("jn,jnab->jab", w, P)
        for _ in range(2):
            s = np.sign(np.einsum("jab,jnb,jna->jn", R, vAi, vBi))
            s[s == 0] = 1.0
            Mw = np.einsum("jn,jna,jnb->jab", w * s, vBi, vAi)
            try:
                U, _, Vt = np.linalg.svd(Mw)
            except np.linalg.LinAlgError:
                # batched SVD aborts wholesale if ONE 3x3 fails to
                # converge; jitter the failing candidates negligibly
                Mw = Mw + 1e-12 * np.random.default_rng(0).standard_normal(
                    Mw.shape)
                U, _, Vt = np.linalg.svd(Mw)
            det = np.linalg.det(np.einsum("jab,jbc->jac", U, Vt))
            D = np.zeros((J, 3, 3))
            D[:, 0, 0] = D[:, 1, 1] = 1.0
            D[:, 2, 2] = det
            R = np.einsum("jab,jbc,jcd->jad", U, D, Vt)
            b_t = np.einsum("jn,jnab,jnb->ja", w, P,
                            aBi - np.einsum("jab,jnb->jna", R, aAi))
            ok_t = np.abs(np.linalg.det(A_t)) > 1e-12
            A_s = np.where(ok_t[:, None, None], A_t, np.eye(3)[None])
            t = np.linalg.solve(A_s, b_t[..., None])[..., 0]
        ok = (np.isfinite(R).all(axis=(1, 2)) & np.isfinite(t).all(axis=1)
              & ok_t)
        return R, t, ok

    strong = np.flatnonzero(usable & (cntA >= 2) & (cntB >= 2))
    pool = strong if len(strong) >= 3 else np.flatnonzero(usable)
    if len(pool) < 3:
        return None
    rng = np.random.default_rng(cfg.rseed ^ (0x5A11 + prep.new_ks[0]))
    samples = np.stack([rng.choice(pool, 3, replace=False)
                        for _ in range(256)])
    R_b, t_b, ok_b = fit_S_batch(samples)
    cands_S = [Pose(R_b[j], t_b[j]) for j in np.flatnonzero(ok_b)]
    Rp, tp, okp = fit_S_batch(pool[None, :])
    if okp[0]:
        cands_S.append(Pose(Rp[0], tp[0]))
    cands_S.append(M_odo)            # odometry-implied as the fallback
    return cands_S


def _joint_confirm_jobs(jobs, frames, kf_idx, traj, cfg: SlamConfig,
                        dtype, drift_ok):
    """Confirm-or-drop for a BATCH of spans: every lane of every span in
    one vmapped joint solve (r4 looped _span_joint_resolve per span —
    VERDICT r4 item 2).

    jobs: list of (span, init_edge-or-None).  Per span the lanes are:

      * "edge"     — polish from the verified 2-view edge (if any);
      * "aligned"  — polish from the RANSAC line-cloud alignment
                     (rescue spans: stages 1-2, batched);
      * "odometry" — polish from the odometry-implied alignment.  The
        null hypothesis (VERDICT r4 item 3): an accepted closure must
        explain the matched lines AT LEAST as well as this lane — a
        closure whose joint vote loses to odometry has no evidence
        behind its correction (myungdong seed 2's accepted edge added
        0.36% of path through closure in r4), while a tie keeps the
        odometry-consistent estimate, whose PGO correction is ~0.

    Returns a list parallel to jobs: None when the span could not be
    attempted (too few pairs / no usable alignment / non-finite solves),
    else (lanes: List[_LaneResult], winner_index-or-None).  The winner
    is the highest joint vote among lanes passing vote + drift gates,
    ties to the non-odometry lane order.
    """
    from ..hostgeom import av_to_orth_np
    from ..ops.residuals import lba_residual_batch

    timing = {}
    t_stage = time.perf_counter()

    def _mark(key):
        nonlocal t_stage
        timing[key] = round(time.perf_counter() - t_stage, 3)
        t_stage = time.perf_counter()

    n_jobs = len(jobs)
    min_attempt = max(cfg.lc_min_inliers, cfg.ransac_min_sample)
    preps: List[Optional[_JointPrep]] = []
    for (span, _) in jobs:
        p = _JointPrep(span, frames, kf_idx, traj, cfg)
        preps.append(p if p.n >= min_attempt else None)
    _mark("prep")

    # ---- stages 1-2 for EVERY confirmable span: group fits + RANSAC
    # align.  Also for spans with a verified 2-view edge — when the
    # edge-polish lane fails the joint vote, the aligned lane is the
    # fallback that rescues genuine closures (olympic4f seed 1: edge
    # lane 42/81, below the 49 floor, while the aligned lane passes;
    # r4's sequential code retried with init=None for exactly this) ----
    rescue = [(i, preps[i]) for i in range(n_jobs)
              if preps[i] is not None]
    fits = _fit_group_problems(rescue, traj, cfg, dtype, timing=timing)
    _mark("group_fits")
    cand_lists = {}
    score_parts = []            # (job_i, J, Rn, cw, lo, ob)
    for i, prep in rescue:
        f = fits.get(i)
        if f is None or f[0] is None or f[2] is None:
            continue
        linesA, cntA, linesB, cntB = f
        cands_S = _ransac_align(prep, linesA, cntA, linesB, cntB, cfg)
        if cands_S is None:
            continue
        new_rows = [ri for ri in range(len(prep.rows))
                    if prep.ocam[ri] >= len(prep.old_ks)]
        Rn = len(new_rows)
        J = len(cands_S)
        # candidate poses per (candidate, NEW camera) — the r5a version
        # composed per (candidate, row), ~J*Rn Pose matmuls + so3_logs
        # per span, and at 1000 kf that host loop WAS the confirm wall;
        # rows share the span's few new cameras
        # candidate selection only needs a representative row subset:
        # J*Rn rows per span (~20k) made the scoring pack + transfer the
        # next wall once the pose composition was fixed; 24 evenly
        # spaced rows keep the inlier argmax stable (the winner is
        # polished by the joint solve either way) at ~4% of the bytes
        if Rn > _SCORE_ROWS_CAP:
            sel = np.linspace(0, Rn - 1, _SCORE_ROWS_CAP).astype(int)
            new_rows = [new_rows[k] for k in sel]
            Rn = len(new_rows)
        cam_wts = {}
        for g in prep.new_ks:
            Qgg = prep.Qg[g]
            cam_wts[prep.cam_of[g]] = np.stack(
                [(Qgg @ Sc).wt() for Sc in cands_S])        # (J, 6)
        cw_all = np.stack([cam_wts[int(prep.ocam[ri])]
                           for ri in new_rows], axis=1)     # (J, Rn, 6)
        la = av_to_orth_np(linesA)[prep.olin[new_rows]]
        cast = np.dtype(dtype)  # pack at compute dtype: halves the
        #                         host->device bytes on the f32 chip path
        score_parts.append((i, J, Rn,
                            cw_all.reshape(-1, 6).astype(cast),
                            np.tile(la, (J, 1)).astype(cast),
                            np.tile(prep.rows[new_rows],
                                    (J, 1)).astype(cast)))
        cand_lists[i] = cands_S
    S_best = {}
    if score_parts:
        # ONE scoring dispatch for every rescue span's candidate list:
        # image-space reprojection inliers of the new-side observations
        # against the old cloud
        cw_f = np.concatenate([p[3] for p in score_parts])
        lo_f = np.concatenate([p[4] for p in score_parts])
        ob_f = np.concatenate([p[5] for p in score_parts])
        tot = len(cw_f)
        totb = -(-tot // 4096) * 4096
        pad = lambda a, w: (np.concatenate([a, np.zeros((totb - tot, w))])
                            if totb > tot else a)
        r = lba_residual_batch(jnp.asarray(pad(cw_f, 6), dtype),
                               jnp.asarray(pad(lo_f, 4), dtype),
                               jnp.asarray(pad(ob_f, 8), dtype),
                               cfg.camera.baseline)
        err_f = np.abs(np.asarray(r, np.float64)[:tot]).max(axis=1)
        err_f = np.where(np.isfinite(err_f), err_f, np.inf)
        pos = 0
        for (i, J, Rn, _, _, _) in score_parts:
            e = err_f[pos:pos + J * Rn].reshape(J, Rn)
            pos += J * Rn
            S_best[i] = cand_lists[i][int(np.argmax(
                (e < cfg.error_thr).sum(axis=1)))]
    _mark("ransac_align")

    # ---- stage 3: one vmapped joint polish over ALL lanes ----
    lanes = []                  # (job_i, name, S alignment in gauge frame)
    for i, (span, init_edge) in enumerate(jobs):
        prep = preps[i]
        if prep is None:
            continue
        if init_edge is not None:
            e_old, e_new, e_wt = init_edge
            lanes.append((i, "edge",
                          prep.Qg[e_new].inv()
                          @ Pose.from_wt(np.asarray(e_wt))
                          @ (traj[e_old].inv() @ prep.gauge)))
        if i in S_best:
            lanes.append((i, "aligned", S_best[i]))
        lanes.append((i, "odometry", prep.M_odo))
    if not lanes:
        return [None] * n_jobs, timing

    act = sorted({i for i, _, _ in lanes})
    ap = [preps[i] for i in act]
    Cb = bucket_for(max(p.C for p in ap), cfg.cam_buckets)
    Lb = bucket_for(max(p.L for p in ap), cfg.line_buckets)
    rnd8 = lambda n: max(8, -(-n // 8) * 8)
    # camera-major blocked flat layout for the dense solver: OmC rows
    # per camera slot (assembly="blocked" contract)
    OmC = rnd8(max(int(np.bincount(p.ocam).max()) for p in ap))
    Eb = rnd8(max((len(p.old_ks) - 1) + (len(p.new_ks) - 1) for p in ap))
    SL = bucket_for(len(lanes), _SPAN_BUCKETS)

    # per-JOB layout, priors and line inits (shared by the job's lanes;
    # the line init anchors at each line's FIRST observing camera, which
    # is always an old-group camera — lane-independent)
    packs, priors, line_inits, cfree_j, lfree_j = {}, {}, {}, {}, {}
    tri_jobs = [(i, np.stack([preps[i].line_first[of][1]
                              for of in preps[i].line_ids])) for i in act]
    tri_cat = triangulate_lines_host(
        np.concatenate([t for _, t in tri_jobs]), cfg.camera.baseline,
        inverse_depth=cfg.inverse_depth, dtype=dtype)
    pos = 0
    for i, first_obs in tri_jobs:
        prep = preps[i]
        ob_f = np.zeros((Cb * OmC, 8))
        ol_f = np.zeros(Cb * OmC, np.int32)
        ov_f = np.zeros(Cb * OmC, bool)
        fill = np.zeros(Cb, np.int32)
        for ri in range(len(prep.rows)):
            c = int(prep.ocam[ri])
            k = c * OmC + fill[c]
            fill[c] += 1
            ob_f[k] = prep.rows[ri]
            ol_f[k] = prep.olin[ri]
            ov_f[k] = True
        packs[i] = (ob_f, ol_f, ov_f)
        ei, ej, ec, esig = [], [], [], []
        for grp in (prep.old_ks, prep.new_ks):
            for a, b in zip(grp, grp[1:]):
                ei.append(prep.cam_of[a])
                ej.append(prep.cam_of[b])
                ec.append((traj[b].inv() @ traj[a]).wt())
                esig.append((0.01, 0.05))   # strong in-group odometry
        while len(ei) < Eb:
            ei.append(0)
            ej.append(0)
            ec.append(np.zeros(6))
            esig.append((1e9, 1e9))         # zero-weight padding
        priors[i] = (np.asarray(ei, np.int32), np.asarray(ej, np.int32),
                     np.stack(ec), np.asarray(esig))
        tri = tri_cat[pos:pos + prep.L]
        pos += prep.L
        lines_g = np.zeros((Lb, 6))
        lines_g[:, 5] = 1.0
        first_cam = [prep.cam_of[prep.line_first[of][0]]
                     for of in prep.line_ids]
        for li in range(prep.L):
            P = Pose.from_wt(prep.cam_wt[first_cam[li]]).inv()
            lines_g[li, :3] = P.R @ tri[li, :3] + P.t
            lines_g[li, 3:] = P.R @ tri[li, 3:]
        line_inits[i] = av_to_orth_np(lines_g)
        cf = np.zeros(Cb, bool)
        cf[1:prep.C] = True
        cfree_j[i] = cf
        lf = np.zeros(Lb, bool)
        lf[:prep.L] = True
        lfree_j[i] = lf

    cam_b = np.zeros((SL, Cb, 6))
    line_b = np.zeros((SL, Lb, 4))
    line_b[:, :, 3] = 0.5
    obs_b = np.zeros((SL, Cb * OmC, 8))
    olin_b = np.zeros((SL, Cb * OmC), np.int32)
    ovalid_b = np.zeros((SL, Cb * OmC), bool)
    ocam_b = np.broadcast_to(
        np.repeat(np.arange(Cb, dtype=np.int32), OmC), (SL, Cb * OmC))
    cfree_b = np.zeros((SL, Cb), bool)
    lfree_b = np.zeros((SL, Lb), bool)
    ei_b = np.zeros((SL, Eb), np.int32)
    ej_b = np.zeros((SL, Eb), np.int32)
    ec_b = np.zeros((SL, Eb, 6))
    esig_b = np.full((SL, Eb, 2), 1e9)
    for s, (i, name, S) in enumerate(lanes):
        prep = preps[i]
        cam_init = np.zeros((Cb, 6))
        cam_init[:prep.C] = prep.cam_wt
        for g in prep.new_ks:
            cam_init[prep.cam_of[g]] = (prep.Qg[g] @ S).wt()
        cam_b[s] = cam_init
        line_b[s] = line_inits[i]
        obs_b[s], olin_b[s], ovalid_b[s] = packs[i]
        cfree_b[s], lfree_b[s] = cfree_j[i], lfree_j[i]
        ei_b[s], ej_b[s], ec_b[s], esig_b[s] = priors[i]
    for s in range(len(lanes), SL):   # padding lanes re-solve lane 0
        for a in (cam_b, line_b, obs_b, olin_b, ovalid_b,
                  cfree_b, lfree_b, ei_b, ej_b, ec_b, esig_b):
            a[s] = a[0]

    cam_out, line_out, _ = _joint_polish_many(
        jnp.asarray(cam_b, dtype), jnp.asarray(line_b, dtype),
        jnp.asarray(obs_b, dtype), jnp.asarray(np.ascontiguousarray(
            ocam_b)), jnp.asarray(olin_b), jnp.asarray(ovalid_b),
        jnp.asarray(cfree_b), jnp.asarray(lfree_b), jnp.asarray(ei_b),
        jnp.asarray(ej_b), jnp.asarray(ec_b), jnp.asarray(esig_b),
        jnp.asarray(cfg.camera.baseline, dtype),
        jnp.asarray(cfg.huber_delta, dtype),
        robust=cfg.robust, max_iters=_POLISH_LM_ITERS,
        line_param=cfg.line_param)
    cam_out = np.asarray(cam_out, np.float64)
    line_out = np.asarray(line_out, np.float64)
    _mark("joint_polish")

    # ---- stage 4: one batched verification over every lane's rows ----
    ver_parts = []
    for s, (i, name, S) in enumerate(lanes):
        prep = preps[i]
        ver_parts.append((cam_out[s][prep.ocam],
                          line_out[s][prep.olin], prep.rows))
    cw_f = np.concatenate([p[0] for p in ver_parts])
    lo_f = np.concatenate([p[1] for p in ver_parts])
    ob_f = np.concatenate([p[2] for p in ver_parts])
    tot = len(cw_f)
    totb = -(-tot // 4096) * 4096
    pad = lambda a, w: (np.concatenate([a, np.zeros((totb - tot, w))])
                        if totb > tot else a)
    r = lba_residual_batch(jnp.asarray(pad(cw_f, 6), dtype),
                           jnp.asarray(pad(lo_f, 4), dtype),
                           jnp.asarray(pad(ob_f, 8), dtype),
                           cfg.camera.baseline)
    err_f = np.abs(np.asarray(r, np.float64)[:tot]).max(axis=1)
    err_f = np.where(np.isfinite(err_f), err_f, np.inf)

    job_lanes: Dict[int, List[_LaneResult]] = {}
    pos = 0
    for s, (i, name, S) in enumerate(lanes):
        prep = preps[i]
        err = err_f[pos:pos + len(prep.rows)]
        pos += len(prep.rows)
        if not np.all(np.isfinite(cam_out[s][:prep.C])):
            continue
        inl_pairs = {}
        n_final = 0
        for (nf, of), idxs in prep.pair_rows.items():
            if err[idxs].max() < cfg.error_thr:
                n_final += 1
                inl_pairs[nf] = of
        k_rep, old_rep, _ = max(prep.span, key=lambda c: len(c[2]))
        wt = (Pose.from_wt(cam_out[s][prep.cam_of[k_rep]])
              @ Pose.from_wt(cam_out[s][prep.cam_of[old_rep]]).inv()).wt()
        job_lanes.setdefault(i, []).append(_LaneResult(
            name, old_rep, k_rep, wt, inl_pairs, n_final, prep.n,
            n_final >= prep.min_score))

    out = []
    for i in range(n_jobs):
        lr = job_lanes.get(i)
        if not lr:
            out.append(None)
            continue
        winner = None
        best = -1
        for li, lane in enumerate(lr):
            if not lane.vote_ok or not drift_ok(lane.old_rep, lane.k_rep,
                                                lane.wt):
                continue
            # >= : ties go to the LATER lane — the odometry-null lane is
            # last, so a closure that merely MATCHES odometry's vote
            # yields to the odometry-consistent estimate (when both
            # lanes converged to the same optimum their edges coincide
            # and the choice is moot; when they differ, the tie means
            # the vote cannot tell them apart and the safe one wins)
            if lane.n_final >= best:
                best = lane.n_final
                winner = li
        out.append((lr, winner))
    _mark("verify_vote")
    return out, timing


def _consistency_broken(poses_wt: np.ndarray, edges: Sequence[Tuple[int,
                        int, np.ndarray]], cfg: SlamConfig) -> bool:
    """slam.cpp:1215-1232: any edge whose current relative pose deviates
    from its constraint by more than the keyframe thresholds."""
    for i, j, c in edges:
        Ti = Pose.from_wt(poses_wt[i])
        Tj = Pose.from_wt(poses_wt[j])
        C = Pose.from_wt(c)
        D = (Tj @ Ti.inv()) @ C.inv()
        ang = np.linalg.norm(Pose(D.R, np.zeros(3)).wt()[:3])
        if ang >= cfg.pgo_consistency_rot_thr \
                or np.linalg.norm(D.t) >= cfg.pgo_consistency_tr_thr:
            return True
    return False


def _pose_graph_stitch(res: BatchResult, loop_edges, cfg: SlamConfig,
                       dtype):
    """Chain + loop edges -> on-device PGO -> stitched trajectory."""
    K = res.kf_count
    poses = np.stack([T.inv().wt() for T in res.trajectory])   # world->cam

    edges = [(g, g + 1, res.edges_wt[g]) for g in range(K - 1)]
    edges += [(o, n, wt) for (o, n, wt) in loop_edges]

    if not _consistency_broken(poses, loop_edges, cfg):
        # graph already consistent (reference: pose_optimization skipped)
        return [T for T in res.trajectory], None

    E = len(edges)
    Vb = max(64, -(-K // 64) * 64)
    Eb = max(64, -(-E // 64) * 64)
    pv = np.zeros((Vb, 6))
    pv[:K] = poses
    ei = np.zeros(Eb, np.int32)
    ej = np.zeros(Eb, np.int32)
    ec = np.zeros((Eb, 6))
    ev = np.zeros(Eb, bool)
    for k, (i, j, c) in enumerate(edges):
        ei[k], ej[k], ec[k], ev[k] = i, j, c, True
    free = np.zeros(Vb, bool)
    free[1:K] = True                       # gauge-fix pose 0

    # huber_delta=0.25 is a DOCUMENTED deviation (PARITY.md): the
    # reference's PGO robust loss is effectively off (po_problem.h:136
    # `robustify` is never assigned) and the interactive engine matches
    # that; the deferred path feeds all loop edges at once, so one bad
    # edge must be soft-gated (0.25 ~ the 15 deg keyframe gate in rad).
    out, stats = pose_graph_opt(
        jnp.asarray(pv, dtype), jnp.asarray(ei), jnp.asarray(ej),
        jnp.asarray(ec, dtype), jnp.asarray(ev), jnp.asarray(free),
        max_iters=cfg.pgo_num_iter, huber_delta=0.25)
    out = np.asarray(out, np.float64)[:K]
    traj = [Pose.from_wt(w).inv() for w in out]
    return traj, stats


def _merge_fids(match_dicts: Sequence[Dict[int, int]]) -> Dict[int, int]:
    """Union-find over loop matches: current fid -> oldest root fid
    (the reference's landmark merge + match_lookup remap,
    slam.cpp:1162-1208, as id unification)."""
    parent: Dict[int, int] = {}

    def find(x):
        while parent.get(x, x) != x:
            parent[x] = parent.get(parent[x], parent[x])
            x = parent[x]
        return x

    for match in match_dicts:
        for nf, of in match.items():
            rn, ro = find(nf), find(of)
            if rn != ro:
                parent[max(rn, ro)] = min(rn, ro)
    return {x: find(x) for x in list(parent)}


def _span_candidates(cands: Sequence[Tuple[int, int, Dict[int, int]]],
                     window: int, gap: int = 2):
    """Group raw detections into revisit spans BEFORE any device work.

    A revisit pass fires the recognizer on every keyframe; the resulting
    detections are correlated (same scene, same old keyframes), so they
    are deduplicated to one geometric edge per span.  Grouping requires
    BOTH sides to be contiguous — new keyframes within ``gap`` of each
    other AND old keyframes within ``gap`` + the new-side step (two
    genuinely distinct closures that fire close together stay separate) —
    and a long run is split into ``window``-keyframe spans so an extended
    overlap contributes one constraint per window span, keeping PGO
    leverage inside the revisited stretch (r2 kept a single edge for the
    whole run).
    """
    spans = []
    cur: List[Tuple[int, int, Dict[int, int]]] = []
    for c in cands:
        if cur:
            dnew = c[0] - cur[-1][0]
            dold = abs(c[1] - cur[-1][1])
            if dnew <= gap and dold <= gap + dnew:
                cur.append(c)
                continue
        if cur:
            spans.append(cur)
        cur = [c]
    if cur:
        spans.append(cur)
    out = []
    for run in spans:
        base = run[0][0]
        chunk: List[Tuple[int, int, Dict[int, int]]] = []
        for c in run:
            if c[0] - base >= window and chunk:
                out.append(chunk)
                chunk = []
                base = c[0]
            chunk.append(c)
        if chunk:
            out.append(chunk)
    return out


class BatchSlamLC:
    """Device-resident replay with loop closure.

    Usage::

        eng = BatchSlamLC(cfg, recognizer, descriptor_source)
        result = eng.run(frames)            # frames: [{fid: obs8}, ...]

    ``descriptor_source(frame_id, feat_ids) -> (F, 72) descriptors`` —
    computed (frontend.descriptor) or oracle (sim.tracks).
    """

    def __init__(self, config: Optional[SlamConfig] = None,
                 recognizer=None, descriptor_source=None,
                 refine: bool = False, refine_rounds: int = 2,
                 overlap_descriptors: bool = False):
        self.cfg = config or SlamConfig()
        self.dtype = jnp.dtype(self.cfg.compute_dtype)
        self.recognizer = recognizer
        self.descriptor_source = descriptor_source
        self.refine = refine
        self.refine_rounds = refine_rounds
        # overlap_descriptors=True computes EVERY frame's descriptors on
        # the host while the device runs the replay scan (the scan is
        # dispatched async; the host is otherwise idle during the
        # scan).  Opt-in because stateful descriptor sources
        # (sim.tracks draws per-call RNG noise) see a different call
        # stream when some frames are not keyframes: the default path
        # calls kf-order/kf-only.  Benches and deferred replays whose
        # keyframe gates are ~0 (every frame a KF) get an identical
        # stream and the host work hides behind the scan.
        self.overlap_descriptors = overlap_descriptors
        self._batch = BatchSlam(self.cfg)

    def run(self, frames: List[Dict[int, np.ndarray]],
            frame_ids: Optional[List[int]] = None,
            normalized: bool = True,
            lifetime: Optional[int] = None) -> BatchLCResult:
        cfg = self.cfg
        t0 = time.perf_counter()
        if not normalized:
            from .batch import normalize_frames
            frames = normalize_frames(frames, cfg.camera)

        handle = self._batch.dispatch(frames, frame_ids=frame_ids,
                                      lifetime=lifetime)
        pre_desc = None
        if (self.overlap_descriptors and self.recognizer is not None
                and self.descriptor_source is not None):
            # the scan is enqueued; the device works while the host
            # computes descriptors for every frame (see __init__)
            pre_desc = [self.descriptor_source(i, sorted(fr))
                        for i, fr in enumerate(frames)]
        res = self._batch.collect(handle)
        t_replay = time.perf_counter() - t0

        kf_idx = np.flatnonzero(np.asarray(res.is_kf, bool))
        events: List[LoopEvent] = []
        merge_matches: List[Dict[int, int]] = []
        loop_edges = []
        n_candidates = 0
        n_spans = 0
        t1 = time.perf_counter()
        t_desc = t_scan = 0.0
        if self.recognizer is not None and self.descriptor_source is not None:
            base_key = jax.random.PRNGKey(cfg.rseed ^ 0x10C)
            fids_list = [sorted(frames[f]) for f in kf_idx]
            if hasattr(self.recognizer, "recognize_all"):
                # batched recognition: the whole timeline in one scan
                # (loopclosure/batch.py)
                descs = (
                    [pre_desc[int(f)] for f in kf_idx]
                    if pre_desc is not None else
                    [self.descriptor_source(int(f), fids)
                     for f, fids in zip(kf_idx, fids_list)])
                t_desc = time.perf_counter() - t1
                hits = self.recognizer.recognize_all(
                    list(range(len(kf_idx))), fids_list, descs)
                t_scan = time.perf_counter() - t1 - t_desc
            else:
                hits = [self.recognizer.query_and_insert(
                    k, fids_list[k],
                    pre_desc[int(f)] if pre_desc is not None
                    else self.descriptor_source(int(f), fids_list[k]))
                    for k, f in enumerate(kf_idx)]

            # correlated detections dedup to one edge per revisit span
            # BEFORE the relative-pose solves (r2 solved every candidate
            # — 2-3 device dispatches each — then discarded most): the
            # span representative with the most descriptor matches is
            # solved first, falling back to the next-best on rejection.
            cands = [(k, hit[0], hit[1]) for k, hit in enumerate(hits)
                     if hit is not None]
            n_candidates = len(cands)
            spans = _span_candidates(cands, cfg.ba_window_size)
            n_spans = len(spans)

            # cumulative odometry path length per keyframe, for the
            # drift-fraction sanity gate (SlamConfig.lc_max_drift_frac)
            cum = np.concatenate([[0.0], np.cumsum([
                np.linalg.norm(res.trajectory[g + 1].t
                               - res.trajectory[g].t)
                for g in range(res.kf_count - 1)])])

            def _drift_ok(old_k, k, wt):
                implied = (res.trajectory[k].inv()
                           @ res.trajectory[old_k])
                dev = np.linalg.norm(Pose.from_wt(wt).t - implied.wt()[3:])
                path = max(cum[k] - cum[old_k], 1.0)
                return dev <= cfg.lc_max_drift_frac * path

            # per round, EVERY pending span's next-best representative is
            # solved in one batched dispatch (_span_solve_batch); spans
            # whose representative is rejected fall back to the next one
            # in the following round, up to 3 attempts (the r3 sequential
            # fallback order, now 3 dispatches total instead of 3-4 per
            # span)
            n_spans_total = len(spans)
            t_rounds0 = time.perf_counter()
            span_ordered = [sorted(s, key=lambda c: -len(c[2]))[:3]
                            for s in spans]
            span_events: List[List[LoopEvent]] = [[] for _ in spans]
            span_edge: List[Optional[tuple]] = [None] * n_spans_total
            span_merge: List[Optional[dict]] = [None] * n_spans_total
            span_solved: List[set] = [set() for _ in spans]
            pending = list(range(n_spans_total))
            for rnd in range(3):
                rd = [(si, span_ordered[si][rnd]) for si in pending
                      if rnd < len(span_ordered[si])]
                if not rd:
                    break
                res_r = _solve_span_round([c for _, c in rd], frames,
                                          kf_idx, cfg, self.dtype,
                                          base_key)
                nxt = []
                for (si, (k, old_k, match)), (wt, score, n, inl_pairs) \
                        in zip(rd, res_r):
                    if wt is not None and not _drift_ok(old_k, k, wt):
                        wt = None
                    accepted = wt is not None
                    span_events[si].append(
                        LoopEvent(old_k, k, n, score, wt, accepted))
                    span_solved[si].add(k)
                    if accepted:
                        span_edge[si] = (old_k, k, wt)
                        span_merge[si] = inl_pairs
                    else:
                        nxt.append(si)
                pending = nxt
            t_rounds = time.perf_counter() - t_rounds0
            t_joint0 = time.perf_counter()
            n_joint = 0
            # every span gets a joint multi-keyframe confirm
            # (_joint_confirm_jobs, ALL lanes in one vmapped solve):
            # accepted spans have their 2-view edge CONFIRMED and
            # polished (the 2-view estimate carries weak-mode error even
            # when it passes its own vote — olympic4f's accepted 2-view
            # edge measured 3.3 m off ground truth), fully rejected
            # spans get the RANSAC line-cloud-alignment rescue, EVERY
            # confirmable span also races the odometry-null lane, and a
            # 2-view edge the multi-view vote refutes (no lane wins, but
            # lanes were attempted) is dropped — reject-only containment
            # is not capability, but neither is keeping an edge the
            # stronger estimator disagrees with
            jobs = []
            job_si = []
            for si in range(n_spans_total):
                accepted_edge = span_edge[si]
                if accepted_edge is not None and np.linalg.norm(
                        accepted_edge[2][3:]) <= cfg.lc_confirm_t_norm:
                    # revisit-range 2-view edge: reliable as-is ONLY if
                    # it is also odometry-consistent — an edge implying
                    # a real correction must win the confirm lanes (see
                    # SlamConfig.lc_confirm_t_norm / lc_confirm_dev_t)
                    old_k, k, wt = accepted_edge
                    implied = (res.trajectory[k].inv()
                               @ res.trajectory[old_k])
                    dev = np.linalg.norm(Pose.from_wt(wt).t - implied.t)
                    if dev <= cfg.lc_confirm_dev_t:
                        continue
                jobs.append((spans[si], accepted_edge))
                job_si.append(si)
            confirm_stages = {}
            if jobs:
                outs, confirm_stages = _joint_confirm_jobs(
                    jobs, frames, kf_idx, res.trajectory, cfg,
                    self.dtype, _drift_ok)
            else:
                outs = []
            for (span_j, accepted_edge), si, out in zip(jobs, job_si,
                                                        outs):
                if out is None:
                    # not attemptable (too few pairs / degenerate): an
                    # existing 2-view edge stands unrefuted (ADVICE r4:
                    # drop only what a lane actually refuted)
                    continue
                lanes_r, winner = out
                n_joint += len(lanes_r)
                for li, lane in enumerate(lanes_r):
                    ok = li == winner
                    span_events[si].append(LoopEvent(
                        lane.old_rep, lane.k_rep, lane.n, lane.n_final,
                        lane.wt if ok else None, ok, joint=True))
                if winner is not None:
                    lane = lanes_r[winner]
                    span_edge[si] = (lane.old_rep, lane.k_rep, lane.wt)
                    span_merge[si] = lane.inl_pairs
                elif accepted_edge is not None:
                    # every lane (incl. the edge's own polish) failed
                    # the joint vote: the multi-view geometry refutes
                    # the 2-view edge — drop it
                    span_edge[si] = None
                    span_merge[si] = None
            t_joint = time.perf_counter() - t_joint0
            for si, span in enumerate(spans):
                for (k, old_k, match) in span:
                    if k not in span_solved[si]:
                        span_events[si].append(
                            LoopEvent(old_k, k, len(match), 0, None,
                                      False, deduped=True))
                events.extend(span_events[si])
                if span_edge[si] is not None:
                    loop_edges.append(span_edge[si])
                    # only the solve's geometrically-verified inlier
                    # pairs feed the track merge (a single wrong
                    # identification couples two distinct 3D lines in
                    # the refine and bends the whole map)
                    merge_matches.append(span_merge[si])
        t_recog = time.perf_counter() - t1

        t2 = time.perf_counter()
        if loop_edges:
            traj, pgo_stats = _pose_graph_stitch(res, loop_edges, cfg,
                                                 self.dtype)
        else:
            traj, pgo_stats = list(res.trajectory), None
        t_pgo = time.perf_counter() - t2

        merged = _merge_fids(merge_matches)

        refined = None
        t_refine = 0.0
        if self.refine and res.kf_count:
            from .refine import global_refine
            t3 = time.perf_counter()
            if merged:
                frames_m = [{merged.get(fid, fid): o for fid, o in
                             fr.items()} for fr in frames]
            else:
                frames_m = frames
            # the refine INITIALIZES from the stitched trajectory but its
            # odometry prior VALUES must come from the odometry
            # MEASUREMENTS (res.edges_wt), never from the PGO output: a
            # noisy loop edge bends the stitched chain, and a prior built
            # from it would pin the refine to the bend (measured on the
            # itbt3f wlc proxy: 0.17 m odometry -> 0.27 m "refined"),
            # while the weak per-edge measurement prior (sigma_t 2 m/edge)
            # still lets a genuine loop correction — centimeters per edge
            # spread over the chain — stand.  Whether the prior is APPLIED
            # at all is global_refine's detect_band_visibility auto gate
            # (on the merged frames): fully-observable loop-merged maps
            # run the pure ML solve (ADVICE r3).
            prior_c = (np.asarray(res.edges_wt, np.float64)
                       if res.kf_count > 1 else None)
            # ... and the accepted loop edges enter the same solve as
            # general pose priors (ops/schur_cg.py prior_edges): the
            # refine is then the full MAP over observations + odometry
            # measurements + loop constraints — one noisy loop edge is a
            # weak term among thousands, not the pose-graph-only solve's
            # dominant constraint
            pedges = None
            if loop_edges:
                pedges = (np.asarray([o for (o, _, _) in loop_edges]),
                          np.asarray([nk for (_, nk, _) in loop_edges]),
                          np.stack([wt for (_, _, wt) in loop_edges]))
            refined = global_refine(frames_m, res.is_kf, traj, config=cfg,
                                    rounds=self.refine_rounds,
                                    _prior_c=prior_c, prior_edges=pedges)
            traj = refined.trajectory

            # Counterfactual basin selection for CONTESTED closures: when
            # an accepted edge implies a real correction (deviation from
            # the odometry-implied pose > lc_confirm_dev_t), the joint
            # vote can prefer a wrong alignment on a weak-mode ridge —
            # the local line geometry of a street span genuinely fits the
            # wrong point better (myungdong seed 2: aligned lane 47/65 vs
            # odometry 28/65, yet applying it bent the map).  Geometry
            # local to the span cannot arbitrate; the WHOLE map can: run
            # the identical refine problem (same merges, same priors)
            # initialized from the raw odometry chain instead of the
            # stitched trajectory and keep whichever basin ends at lower
            # total cost.  Costs are directly comparable — only the init
            # differs.  Uncontested runs (every edge odometry-consistent)
            # skip the second refine entirely.
            contested = False
            any_large = False
            for (old_k, new_k, wt) in loop_edges:
                implied = (res.trajectory[new_k].inv()
                           @ res.trajectory[old_k])
                dev = np.linalg.norm(Pose.from_wt(wt).t - implied.t)
                if dev > cfg.lc_confirm_dev_t:
                    contested = True
                    path = max(cum[new_k] - cum[old_k], 1.0)
                    if dev > cfg.lc_counterfactual_corr_frac * path:
                        any_large = True
            # a correction clearly above the odometry noise floor is
            # what loop closure exists for — the stitched jump stands
            # without a counterfactual (see lc_counterfactual_corr_frac)
            contested = contested and not any_large
            self._refine_pick = "stitched"
            self._refine_loop_frac = None
            if contested:
                alt = global_refine(frames_m, res.is_kf,
                                    list(res.trajectory), config=cfg,
                                    rounds=self.refine_rounds,
                                    _prior_c=prior_c, prior_edges=pedges)
                # Basin selection: total cost does NOT discriminate here
                # (measured r5: the wrong myungdong-s2 basin was 5.6%
                # CHEAPER, the genuine olympic-s1 one 10% cheaper — in
                # the weak-mode regime both basins fit the bulk of the
                # observations).  What discriminates is whether the
                # odometry-init basin EXPLAINS THE LOOP EVIDENCE: the
                # fraction of merged-track observations within the
                # inlier threshold under each basin's refined result.
                # When the gentle basin satisfies the merges too (the
                # contested small-correction case), odometry is the
                # prior-correct default; only when it cannot (genuine
                # multi-meter drift: the merged lines stay split) does
                # the stitched jump carry real information.
                f_st, fh_st = _merged_inlier_frac(refined, frames_m,
                                                  res.is_kf, merged, cfg)
                f_od, fh_od = _merged_inlier_frac(alt, frames_m,
                                                  res.is_kf, merged, cfg)
                self._refine_loop_frac = {
                    "stitched": (round(f_st, 3), round(fh_st, 3)),
                    "odometry_init": (round(f_od, 3), round(fh_od, 3))}
                # guard only: the gentle basin must still explain the
                # merges about as well (it does whenever the correction
                # is sub-noise — measured 97-99% both basins)
                if f_od >= f_st - 0.05 and fh_od >= fh_st - 0.05:
                    refined = alt
                    traj = alt.trajectory
                    self._refine_pick = "odometry-init"
            t_refine = time.perf_counter() - t3

        stats = dict(res.stats)
        stats.update({
            "num_loop_candidates": n_candidates,
            "num_loop_spans": n_spans,
            "num_loop_closures": len(loop_edges),
            "num_merged_tracks": len(merged),
            "pgo_iterations": (int(pgo_stats.iterations)
                               if pgo_stats is not None else 0),
            "wall_replay_s": round(t_replay, 3),
            "wall_recognition_s": round(t_recog, 3),
            "wall_desc_s": round(t_desc, 3),
            "wall_recog_scan_s": round(t_scan, 3),
            "wall_span_rounds_s": round(t_rounds, 3) if n_spans else 0.0,
            "wall_joint_confirm_s": (round(t_joint, 3)
                                     if n_spans else 0.0),
            "num_joint_solves": n_joint if n_spans else 0,
            "wall_confirm_stages": (confirm_stages if n_spans else {}),
            "wall_pgo_s": round(t_pgo, 3),
            "wall_refine_s": round(t_refine, 3),
            "refine_pick": getattr(self, "_refine_pick", "stitched"),
            "refine_loop_frac": getattr(self, "_refine_loop_frac", None),
        })
        return BatchLCResult(base=res, trajectory=traj, events=events,
                             merged_fids=merged, stats=stats,
                             refined=refined)
