"""Device-resident batch engine: the whole SLAM loop as one ``lax.scan``.

The interactive engine (engine/slam.py) mirrors the reference's per-frame
host loop (/root/reference/src/main.cpp:45-80) and pays 2 device dispatches
+ 2 fetches per keyframe.  This module is the device-resident alternative
for *replay / mapping* workloads (the reference's only released mode:
replaying recorded line-track files, README:25-27): the entire sequence
is uploaded once, a single jitted ``lax.scan`` runs VO + keyframe gating +
triangulation + windowed Schur-LM BA + endpoint maintenance for every
frame on device, and the results come back in one fetch.  Zero per-frame
host round trips.

Semantics match the interactive engine (and through it the reference) with
two scoping restrictions, both checked in tests/test_batch_engine.py:

* no loop closure (the odometry graph is a chain).  On a chain, metric
  embedding from the newest keyframe (slam.cpp:1317-1366) orders keyframes
  by recency, so the reference's BA window "first 2W by metric distance,
  nearest W free" (slam.cpp:1374-1382, 811-814) becomes "last 2W keyframes,
  last W free" — a ring buffer.  Sequences with loop closures run the
  interactive engine (or this engine per loop-free segment).
* landmark slots are fixed capacity.  Feature ids are assigned to device
  slots by a host pre-pass; ids whose observations can no longer enter the
  BA window are retired (their final state is emitted from the scan) and
  their slots recycled, so capacity bounds *concurrently tracked* lines,
  not the sequence's total.

State layout on device (the reference's heap maps, slam.h:77-162, as
fixed-shape SoA tensors):

* landmark pool ``lm_*`` indexed by slot, lines stored in the **current
  embedding frame** (the newest keyframe's camera frame).  The reference
  stores lines in their init keyframe's frame and re-derives poses every
  cycle via metric embedding; on a chain the two are related by composing
  the (BA-refreshed) edges from init keyframe to newest, so transporting
  lines by each accepted motion — and re-anchoring after BA moves the
  newest pose — is algebraically identical (slam.cpp:884-886, 964-972).
* keyframe ring ``win_*`` of the last 2W keyframes: that frame's
  observations (the landmark obs_vec entries that can still reach BA,
  slam.cpp:848-882), member flags (final VO inliers, slam.cpp:151-157 via
  add_new_keyframe 730-761), pose in the embedding frame, and global index.
* edge list ``edges`` (relative pose keyframe g -> g+1): the authoritative
  relative map.  BA results persist by overwriting intra-free-window edges
  (slam.cpp:1398-1416); the final trajectory is the edge chain composed
  from keyframe 0 (slam.cpp:1473-1496).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import geometry as geo
from ..config import SlamConfig, bucket_for
from ..hostgeom import Pose
from ..ops.schur_ba import default_assembly, lines_gn_impl, local_ba_impl
from ..ops.triangulate import triangulate_lines
from ..ops.vo_pipeline import vo_body


# ---------------------------------------------------------------------------
# Host pre-pass: slot assignment with recycling
# ---------------------------------------------------------------------------

class FramePack(NamedTuple):
    """Per-frame observation tensors + retirement schedule (host arrays)."""

    obs: np.ndarray          # (F, Om, 8) normalized stereo endpoints
    slot: np.ndarray         # (F, Om) landmark slot per observation
    valid: np.ndarray        # (F, Om)
    retire_slot: np.ndarray  # (F, Rm) slots to retire *before* frame f
    retire_valid: np.ndarray  # (F, Rm)
    frame_idx: np.ndarray    # (F,) original frame ids (for RNG keys)
    fid_of_slot_events: list  # [(frame, slot, feature_id)] assignment log
    num_slots: int           # live-slot capacity actually needed


def pack_frames(frames: List[Dict[int, np.ndarray]],
                lifetime: Optional[int] = None,
                window: int = 10,
                max_obs: Optional[int] = None,
                frame_ids: Optional[List[int]] = None) -> FramePack:
    """Assign feature ids to recyclable device slots.

    A feature is live from its first observation until ``lifetime`` frames
    after its last (default 6*window: once its newest observation is
    certainly out of the 2W keyframe window even if every frame becomes a
    keyframe, with 2W of slack for gated frames).  Slots are reused across
    disjoint live ranges; the scan emits a landmark's final state when its
    slot retires.
    """
    F = len(frames)
    if lifetime is None:
        lifetime = 6 * window
    first: Dict[int, int] = {}
    last: Dict[int, int] = {}
    for f, fr in enumerate(frames):
        for fid in fr:
            first.setdefault(fid, f)
            last[fid] = f

    # greedy interval slot assignment
    free: List[int] = []
    free_at: Dict[int, List[int]] = {}
    slot_of: Dict[int, int] = {}
    retire_events: Dict[int, List[int]] = {}
    num_slots = 0
    events = sorted(first.items(), key=lambda kv: kv[1])
    for fid, f0 in events:
        exp = last[fid] + lifetime
        # release slots that became free strictly before f0
        for ff in [k for k in list(free_at) if k <= f0]:
            free.extend(free_at.pop(ff))
        if free:
            s = free.pop()
        else:
            s = num_slots
            num_slots += 1
        slot_of[fid] = s
        if exp + 1 < F:
            free_at.setdefault(exp + 1, []).append(s)
            retire_events.setdefault(exp + 1, []).append(s)

    Om = max_obs or max((len(fr) for fr in frames), default=1)
    Om = max(Om, 1)
    Rm = max((len(v) for v in retire_events.values()), default=1)
    obs = np.zeros((F, Om, 8))
    slot = np.zeros((F, Om), np.int32)
    valid = np.zeros((F, Om), bool)
    for f, fr in enumerate(frames):
        for k, fid in enumerate(sorted(fr)):
            if k >= Om:
                raise ValueError(
                    f"frame {f} has {len(fr)} observations > max_obs={Om}")
            obs[f, k] = np.asarray(fr[fid], np.float64)
            slot[f, k] = slot_of[fid]
            valid[f, k] = True
    retire_slot = np.zeros((F, Rm), np.int32)
    retire_valid = np.zeros((F, Rm), bool)
    for f, slots in retire_events.items():
        for k, s in enumerate(slots):
            retire_slot[f, k] = s
            retire_valid[f, k] = True
    fidx = np.asarray(frame_ids if frame_ids is not None else range(F),
                     np.int32)
    log = sorted((f0, slot_of[fid], fid) for fid, f0 in first.items())
    return FramePack(obs, slot, valid, retire_slot, retire_valid, fidx,
                     log, num_slots)


# ---------------------------------------------------------------------------
# Scan state
# ---------------------------------------------------------------------------

class BatchCarry(NamedTuple):
    kf_count: jnp.ndarray    # () int32 — accepted keyframes so far
    fail_streak: jnp.ndarray  # () int32 consecutive VO failures
    lm_line: jnp.ndarray     # (Lp, 6) lines in current embedding frame
    lm_active: jnp.ndarray   # (Lp,) bool
    lm_twice: jnp.ndarray    # (Lp,) bool twice_observed
    lm_tt: jnp.ndarray       # (Lp, 2) endpoint interval
    lm_pvn: jnp.ndarray      # (Lp, 3) previous direction (reset detector)
    win_obs: jnp.ndarray     # (Wn, Om, 8) ring of window keyframe obs
    win_slot: jnp.ndarray    # (Wn, Om) int32
    win_valid: jnp.ndarray   # (Wn, Om) bool
    win_member: jnp.ndarray  # (Wn, Lp) bool member_lms flags
    win_pose: jnp.ndarray    # (Wn, 6) pose embedding-frame -> kf camera
    win_g: jnp.ndarray       # (Wn,) int32 global kf index, -1 = empty
    edges: jnp.ndarray       # (Fmax, 6) edge g -> g+1 as (w, t)
    sum_iters: jnp.ndarray   # () int32
    sum_init_cost: jnp.ndarray
    sum_final_cost: jnp.ndarray
    n_processed: jnp.ndarray  # () int32 frames through the full BA pipeline


class BatchStepOut(NamedTuple):
    is_kf: jnp.ndarray
    wt: jnp.ndarray          # (6,) accepted VO motion (zeros otherwise)
    n_common: jnp.ndarray
    ransac_score: jnp.ndarray
    n_final_inliers: jnp.ndarray
    ba_iters: jnp.ndarray
    ba_init_cost: jnp.ndarray
    ba_final_cost: jnp.ndarray
    ret_line: jnp.ndarray    # (Rm, 6) retired landmark lines (their frame =
    ret_tt: jnp.ndarray      # (Rm, 2)   the then-newest keyframe, ret_kf)
    ret_twice: jnp.ndarray   # (Rm,)
    ret_kf: jnp.ndarray      # (Rm,) int32 keyframe index of the frame
    ret_valid: jnp.ndarray   # (Rm,)


def _closest_point(line):
    """p0 = closest point to the origin on the (cp, v) line; safe on rows
    of zeros."""
    p, v = line[..., :3], line[..., 3:]
    n = jnp.cross(p, v)
    vv = jnp.sum(v * v, axis=-1, keepdims=True)
    return jnp.cross(v, n) / jnp.maximum(vv, 1e-30)


def _transport(line, tt, pvn, active, R, t):
    """Express lines (+ endpoint intervals, direction memory) in a new
    frame X' = R X + t.  Exact 3D transport of the tt endpoint scalars
    (equivalent to the reference's gc_tt_to_pose/from_pose bookkeeping,
    gc.cpp:125-150, without the init-frame detour)."""
    vv = jnp.sum(line[..., 3:] ** 2, axis=-1, keepdims=True)
    vh = line[..., 3:] / jnp.sqrt(jnp.maximum(vv, 1e-30))
    p0 = _closest_point(line)
    P1 = p0 + tt[..., 0:1] * vh
    P2 = p0 + tt[..., 1:2] * vh
    line2 = geo.line_to_pose(line, R, t)
    p0n = _closest_point(line2)
    vhn = jnp.einsum("ij,...j->...i", R, vh)
    t1 = jnp.sum(vhn * (jnp.einsum("ij,...j->...i", R, P1) + t - p0n),
                 axis=-1)
    t2 = jnp.sum(vhn * (jnp.einsum("ij,...j->...i", R, P2) + t - p0n),
                 axis=-1)
    uninit = jnp.logical_and(tt[..., 0] == 0.0, tt[..., 1] == 0.0)
    tt2 = jnp.where(uninit[..., None], 0.0, jnp.stack([t1, t2], axis=-1))
    pvn2 = jnp.einsum("ij,...j->...i", R, pvn)
    am = active[..., None]
    return (jnp.where(am, line2, line), jnp.where(am, tt2, tt),
            jnp.where(am, pvn2, pvn))


def _extend_endpoints(line, tt, pvn, update, obs, cfg_thr, cfg_ext):
    """Vectorized SLAM::extend_end_points (slam.cpp:979-1084) in the
    current embedding frame (offset-free: tt is maintained in-frame by
    _transport).  Matches engine/slam.py extend_end_points."""
    v = line[..., 3:]
    vv = jnp.sum(v * v, axis=-1)
    cvn = v / jnp.sqrt(jnp.maximum(vv, 1e-30))[..., None]
    dot = jnp.clip(jnp.sum(cvn * pvn, axis=-1), -1.0, 1.0)
    ang = jnp.arccos(dot)
    reset = ang > cfg_thr
    pvn1 = jnp.where(reset[..., None], cvn, pvn)
    tt1 = jnp.where(reset[..., None], 0.0, tt)

    one = jnp.ones(obs.shape[:-1] + (1,), obs.dtype)
    p11 = jnp.concatenate([obs[..., 0:2], one], axis=-1)
    p21 = jnp.concatenate([obs[..., 2:4], one], axis=-1)
    ln = jnp.cross(p11, p21)[..., :2]
    n_ln = jnp.linalg.norm(ln, axis=-1)
    ok = n_ln > 0
    ln = ln / jnp.maximum(n_ln, 1e-30)[..., None]
    zero = jnp.zeros_like(one)
    p12 = p11 + jnp.concatenate([ln, zero], axis=-1)
    p22 = p21 + jnp.concatenate([ln, zero], axis=-1)

    pc = line[..., :3]
    nc = jnp.cross(pc, v)
    n1 = jnp.cross(p11, p12)
    n2 = jnp.cross(p21, p22)
    e1_xyz = jnp.cross(nc, n1)
    e1_w = -jnp.sum(v * n1, axis=-1)
    e2_xyz = jnp.cross(nc, n2)
    e2_w = -jnp.sum(v * n2, axis=-1)

    p0 = _closest_point(line)
    vnn = cvn
    p0_dist = jnp.linalg.norm(p0, axis=-1)
    ok = jnp.logical_and(ok, p0_dist <= cfg_ext)
    ok = jnp.logical_and(ok, jnp.abs(e1_w) >= 1e-12)
    ok = jnp.logical_and(ok, jnp.abs(e2_w) >= 1e-12)
    pc1 = e1_xyz / jnp.where(e1_w == 0, 1.0, e1_w)[..., None]
    pc2 = e2_xyz / jnp.where(e2_w == 0, 1.0, e2_w)[..., None]
    ok = jnp.logical_and(ok, pc1[..., 2] >= 0)
    ok = jnp.logical_and(ok, pc2[..., 2] >= 0)

    t1 = jnp.sum(vnn * (pc1 - p0), axis=-1)
    t2 = jnp.sum(vnn * (pc2 - p0), axis=-1)
    tt_lo = jnp.minimum(t1, t2)
    tt_hi = jnp.maximum(t1, t2)
    extend = jnp.sqrt(jnp.maximum(cfg_ext ** 2 - p0_dist ** 2, 0.0))
    tt_lo = jnp.clip(tt_lo, -extend, extend)
    tt_hi = jnp.clip(tt_hi, -extend, extend)
    ok = jnp.logical_and(ok, tt_lo != tt_hi)

    uninit = jnp.logical_and(tt1[..., 0] == 0.0, tt1[..., 1] == 0.0)
    lo = jnp.where(uninit, tt_lo, jnp.minimum(tt1[..., 0], tt_lo))
    hi = jnp.where(uninit, tt_hi, jnp.maximum(tt1[..., 1], tt_hi))
    tt2 = jnp.where(ok[..., None], jnp.stack([lo, hi], axis=-1), tt1)

    um = update[..., None]
    return jnp.where(um, tt2, tt), jnp.where(um, pvn1, pvn)


def _make_step(cfg: SlamConfig, Wn: int, Lp: int, Om: int, Rm: int,
               Fmax: int, dtype, base_key, assembly: str):
    """Build the scan step function (all shapes/static knobs closed over)."""
    W = cfg.ba_window_size
    Lcap = Lp - 1  # dump row index
    baseline = cfg.camera.baseline
    error_thr = cfg.error_thr
    huber_delta = cfg.huber_delta
    min_s = cfg.ransac_min_sample

    def step(carry: BatchCarry, xs):
        obs_f, slot_f, val_f, ret_s, ret_v, fidx = xs

        # ---- retirement: emit final state, clear slots, purge ring ----
        ret_idx = jnp.where(ret_v, ret_s, Lcap)
        ret_line = carry.lm_line[ret_idx]
        ret_tt = carry.lm_tt[ret_idx]
        ret_twice = carry.lm_twice[ret_idx]
        ret_valid = jnp.logical_and(ret_v, carry.lm_active[ret_idx])
        ret_kf = jnp.full((Rm,), 1, jnp.int32) * (carry.kf_count - 1)
        lm_active = carry.lm_active.at[ret_idx].set(False)
        lm_active = lm_active.at[Lcap].set(False)
        lm_twice = carry.lm_twice.at[ret_idx].set(False)
        lm_tt = carry.lm_tt.at[ret_idx].set(0.0)
        hit = jnp.any(jnp.logical_and(
            carry.win_slot[..., None] == ret_s[None, None, :],
            ret_v[None, None, :]), axis=-1)
        win_valid = jnp.logical_and(carry.win_valid, jnp.logical_not(hit))
        win_member = carry.win_member.at[:, ret_idx].set(False)
        carry = carry._replace(lm_active=lm_active, lm_twice=lm_twice,
                               lm_tt=lm_tt, win_valid=win_valid,
                               win_member=win_member)

        # dense slot-aligned map of this frame's observations
        slot_sel = jnp.where(val_f, slot_f, Lcap)
        curr_map = jnp.zeros((Lp, 8), dtype).at[slot_sel].set(obs_f)
        curr_has = jnp.zeros((Lp,), bool).at[slot_sel].set(val_f)
        curr_has = curr_has.at[Lcap].set(False)

        zeros_out = BatchStepOut(
            jnp.asarray(False), jnp.zeros(6, dtype),
            jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
            jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
            jnp.asarray(0.0, dtype), jnp.asarray(0.0, dtype),
            ret_line, ret_tt, ret_twice, ret_kf, ret_valid)

        def skip_fn(c):
            return c, zeros_out

        def first_fn(c):
            # slam.cpp check_input_data()==2: first keyframe, no edge,
            # no members (final_inliers is empty), triangulate everything.
            tri = triangulate_lines(curr_map, baseline,
                                    inverse_depth=cfg.inverse_depth)
            nm = curr_has[..., None]
            lm_line = jnp.where(nm, tri, c.lm_line)
            lm_pvn = jnp.where(
                nm, tri[..., 3:] / jnp.maximum(
                    jnp.linalg.norm(tri[..., 3:], axis=-1, keepdims=True),
                    1e-30), c.lm_pvn)
            c = c._replace(
                kf_count=jnp.asarray(1, jnp.int32),
                lm_line=lm_line, lm_active=jnp.logical_or(c.lm_active,
                                                          curr_has),
                lm_pvn=lm_pvn,
                win_obs=c.win_obs.at[0].set(obs_f),
                win_slot=c.win_slot.at[0].set(slot_f),
                win_valid=c.win_valid.at[0].set(val_f),
                win_pose=c.win_pose.at[0].set(0.0),
                win_g=c.win_g.at[0].set(0))
            return c, zeros_out._replace(is_kf=jnp.asarray(True))

        def normal_fn(c):
            prev_pos = (c.kf_count - 1) % Wn
            pv = c.win_valid[prev_pos]
            psel = jnp.where(pv, c.win_slot[prev_pos], Lcap)
            prev_map = jnp.zeros((Lp, 8), dtype).at[psel].set(
                c.win_obs[prev_pos])
            prev_has = jnp.zeros((Lp,), bool).at[psel].set(pv)
            prev_has = prev_has.at[Lcap].set(False)

            common = jnp.logical_and(jnp.logical_and(curr_has, prev_has),
                                     c.lm_active)
            n_common = jnp.sum(common.astype(jnp.int32)).astype(jnp.int32)

            key = jax.random.fold_in(base_key, fidx)
            res = vo_body(prev_map, curr_map, c.lm_line, common, key,
                          baseline, error_thr, huber_delta,
                          max_t_norm=cfg.ransac_max_t_norm,
                          num_hyp=cfg.ransac_num_hypotheses,
                          sample_size=min_s, robust=cfg.robust,
                          max_iters=cfg.moba_max_iter,
                          line_param=cfg.line_param,
                          relin_iters=cfg.vo_relin_iters)
            ok = jnp.logical_and(n_common >= min_s,
                                 res.ransac_score >= min_s)
            ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(res.wt)))
            ang = jnp.linalg.norm(res.wt[:3])
            tn = jnp.linalg.norm(res.wt[3:])
            is_kf = jnp.logical_and(
                ok, jnp.logical_or(ang >= cfg.kf_rot_thr,
                                   tn >= cfg.kf_tr_thr))

            # failure containment (SlamConfig.vo_fail_recovery): a frame
            # with common features whose RANSAC fell below the inlier
            # floor counts as a failure; after R in a row, accept a
            # recovery keyframe from the best-effort polished motion
            # before the common tracks expire entirely
            failed = jnp.logical_and(n_common >= min_s,
                                     jnp.logical_not(ok))
            if cfg.vo_fail_recovery > 0:
                recover = jnp.logical_and(
                    failed, c.fail_streak + 1 >= cfg.vo_fail_recovery)
                recover = jnp.logical_and(
                    recover, jnp.all(jnp.isfinite(res.wt)))
                recover = jnp.logical_and(
                    recover, jnp.linalg.norm(res.wt[3:])
                    <= 2.0 * cfg.ransac_max_t_norm)
                is_kf = jnp.logical_or(is_kf, recover)

            final_inl = jnp.logical_and(common, res.final_errors < error_thr)
            out_base = zeros_out._replace(
                n_common=n_common, ransac_score=res.ransac_score.astype(jnp.int32),
                n_final_inliers=jnp.sum(final_inl.astype(jnp.int32)).astype(jnp.int32))

            def reject_fn(c):
                # gated-but-tracking frames reset the streak; genuine
                # RANSAC failures accumulate it
                return c._replace(fail_streak=jnp.where(
                    failed, c.fail_streak + 1, 0)), out_base

            def accept_fn(c):
                wt = res.wt
                Rn, tn_ = geo.wt_to_Rt(wt)
                g_new = c.kf_count           # global index of the new KF
                new_pos = g_new % Wn

                # re-embed at the new keyframe (metric_embedding on a
                # chain): poses compose with the inverse motion, lines and
                # endpoint intervals transport by the motion
                win_pose = jax.vmap(lambda p: geo.wt_compose(
                    p, geo.wt_inv(wt)))(c.win_pose)
                lm_line, lm_tt, lm_pvn = _transport(
                    c.lm_line, c.lm_tt, c.lm_pvn, c.lm_active, Rn, tn_)

                # new keyframe enters the ring (evicting the one leaving
                # the 2W window); members = final VO inliers on both the
                # new and previous keyframe (slam.cpp:151-157, 730-761)
                win_obs = c.win_obs.at[new_pos].set(obs_f)
                win_slot = c.win_slot.at[new_pos].set(slot_f)
                win_valid = c.win_valid.at[new_pos].set(val_f)
                win_member = c.win_member.at[new_pos].set(final_inl)
                win_member = win_member.at[prev_pos].set(
                    jnp.logical_or(win_member[prev_pos], final_inl))
                win_pose = win_pose.at[new_pos].set(0.0)
                win_g = c.win_g.at[new_pos].set(g_new)

                # odometry edge prev -> new (slam.cpp:740-748)
                edges = c.edges.at[g_new - 1].set(wt)

                # triangulate first-seen features in the new frame
                # (slam.cpp:161-219)
                new_mask = jnp.logical_and(curr_has,
                                           jnp.logical_not(c.lm_active))
                tri = triangulate_lines(curr_map, baseline,
                                        inverse_depth=cfg.inverse_depth)
                nm = new_mask[..., None]
                lm_line = jnp.where(nm, tri, lm_line)
                lm_tt = jnp.where(nm, 0.0, lm_tt)
                lm_pvn = jnp.where(
                    nm, tri[..., 3:] / jnp.maximum(
                        jnp.linalg.norm(tri[..., 3:], axis=-1,
                                        keepdims=True), 1e-30), lm_pvn)
                lm_active = jnp.logical_or(c.lm_active, new_mask)

                # ---- windowed BA (slam.cpp:795-975) ----
                kc_new = g_new + 1
                age = (kc_new - 1) - win_g
                cam_valid = win_g >= 0
                cam_free = jnp.logical_and(cam_valid, age < W)

                member_cnt = jnp.sum(
                    jnp.logical_and(win_member,
                                    cam_free[:, None]).astype(jnp.int32),
                    axis=0)
                qualify = jnp.logical_and(member_cnt >= 2, lm_active)
                qualify = qualify.at[Lcap].set(False)

                benign = jnp.zeros((Lp, 6), dtype).at[:, 2].set(1.0)
                benign = benign.at[:, 3].set(1.0)
                enc = {"orth": geo.av_to_orth, "aid": geo.av_to_aid,
                       "asd": geo.av_to_asd}[cfg.line_param]
                dec = {"orth": geo.orth_to_av, "aid": geo.aid_to_av,
                       "asd": geo.asd_to_av}[cfg.line_param]
                line_p4 = enc(jnp.where(lm_active[..., None], lm_line,
                                        benign))
                if cfg.ba_init_jitter:
                    # deterministic annealing jitter on free lines only
                    # (see SlamConfig.ba_init_jitter)
                    jkey = jax.random.fold_in(
                        jax.random.fold_in(base_key, fidx), 0x0B0A)
                    line_p4 = line_p4 + (
                        cfg.ba_init_jitter
                        * jax.random.normal(jkey, line_p4.shape, dtype)
                        * qualify[:, None].astype(dtype))

                ob = win_obs.reshape(Wn * Om, 8)
                ocam = jnp.repeat(jnp.arange(Wn, dtype=jnp.int32), Om)
                olin = jnp.where(win_valid, win_slot, Lcap).reshape(-1)
                ovalid = jnp.logical_and(
                    win_valid.reshape(-1),
                    jnp.logical_and(qualify[olin], cam_valid[ocam]))

                if cfg.lines_gn_iters > 0:
                    # stage the lines into their basin before the joint
                    # solve (SlamConfig.lines_gn_iters).  Applied to ALL
                    # qualifying lines every frame: restricting it to
                    # new-to-BA lines (tried r4) lost the continuous
                    # line polish and drove the interactive engine's
                    # mapped-landmark median 0.02 -> 0.19 m off-world —
                    # the joint LM shares its iterations between cameras
                    # and lines, and the staged lines-only steps carry
                    # real line convergence every window.
                    line_p4 = lines_gn_impl(
                        win_pose, line_p4, ob, ocam, olin, ovalid,
                        qualify, baseline, huber_delta,
                        robust=cfg.robust, iters=cfg.lines_gn_iters,
                        line_param=cfg.line_param)

                anchor = None
                if cfg.window_anchor_sigma_rot > 0 \
                        and cfg.window_anchor_sigma_t > 0:
                    anchor = (jnp.asarray(cfg.window_anchor_sigma_rot,
                                          dtype),
                              jnp.asarray(cfg.window_anchor_sigma_t,
                                          dtype))
                # ob/ocam are camera-major contiguous by construction
                # (the reshape above), so every assembly mode applies
                cam_out, line_out, stats = local_ba_impl(
                    win_pose, line_p4, ob, ocam, olin, ovalid, cam_free,
                    qualify, baseline, huber_delta, robust=cfg.robust,
                    max_iters=cfg.max_num_iter, line_param=cfg.line_param,
                    cam_anchor_sigmas=anchor, assembly=assembly)

                win_pose = jnp.where(cam_valid[:, None], cam_out, win_pose)
                lm_line = jnp.where(qualify[..., None], dec(line_out),
                                    lm_line)
                lm_twice = jnp.logical_or(c.lm_twice, qualify)

                # re-anchor: BA may move the newest pose off identity when
                # the whole window is free; re-root the embedding at the
                # newest keyframe (the reference re-runs metric_embedding
                # next cycle, which does exactly this)
                anchor = win_pose[new_pos]
                Ra, ta = geo.wt_to_Rt(anchor)
                win_pose = jax.vmap(lambda p: geo.wt_compose(
                    p, geo.wt_inv(anchor)))(win_pose)
                win_pose = win_pose.at[new_pos].set(0.0)
                lm_line, lm_tt, lm_pvn = _transport(
                    lm_line, lm_tt, lm_pvn, lm_active, Ra, ta)

                # refresh intra-free-window consecutive edges with the BA
                # relative poses: C := T (slam.cpp:1398-1416)
                Rw, tw = geo.wt_to_Rt(win_pose)
                src_ok = jnp.logical_and(cam_free, age >= 1)
                p2 = (win_g + 1) % Wn
                Rr, tr = geo.t_rel(Rw[p2], tw[p2], Rw, tw)
                wt_rel = geo.Rt_to_wt(Rr, tr)
                eidx = jnp.where(src_ok, win_g, Fmax + 1)
                edges = edges.at[eidx].set(wt_rel, mode="drop")

                # endpoint interval maintenance (slam.cpp:979-1084):
                # ba_updated & currently visible
                upd = jnp.logical_and(qualify, curr_has)
                lm_tt, lm_pvn = _extend_endpoints(
                    lm_line, lm_tt, lm_pvn, upd, curr_map,
                    cfg.line_vn_angle_thr, cfg.extension_length)

                c2 = c._replace(
                    fail_streak=jnp.asarray(0, jnp.int32),
                    kf_count=kc_new, lm_line=lm_line, lm_active=lm_active,
                    lm_twice=lm_twice, lm_tt=lm_tt, lm_pvn=lm_pvn,
                    win_obs=win_obs, win_slot=win_slot,
                    win_valid=win_valid, win_member=win_member,
                    win_pose=win_pose, win_g=win_g, edges=edges,
                    sum_iters=c.sum_iters + stats.iterations,
                    sum_init_cost=c.sum_init_cost + stats.initial_cost,
                    sum_final_cost=c.sum_final_cost + stats.final_cost,
                    n_processed=c.n_processed + 1)
                out = out_base._replace(
                    is_kf=jnp.asarray(True), wt=wt,
                    ba_iters=stats.iterations,
                    ba_init_cost=stats.initial_cost,
                    ba_final_cost=stats.final_cost)
                return c2, out

            return jax.lax.cond(is_kf, accept_fn, reject_fn, c)

        has_obs = jnp.any(val_f)
        branch = jnp.where(jnp.logical_not(has_obs), 0,
                           jnp.where(carry.kf_count == 0, 1, 2))
        return jax.lax.switch(branch, [skip_fn, first_fn, normal_fn], carry)

    return step


# ---------------------------------------------------------------------------
# Public driver
# ---------------------------------------------------------------------------

def normalize_frames(frames: List[Dict[int, np.ndarray]],
                     cam) -> List[Dict[int, np.ndarray]]:
    """Pixel endpoints -> normalized camera coords (slam.cpp:121-128)."""
    conv = []
    for fr in frames:
        d = {}
        for fid, o in fr.items():
            o = np.asarray(o, np.float64).copy()
            o[0::2] = o[0::2] / cam.fx - cam.cx / cam.fx
            o[1::2] = o[1::2] / cam.fy - cam.cy / cam.fy
            d[fid] = o
        conv.append(d)
    return conv


class RetiredLandmark(NamedTuple):
    line: np.ndarray   # (6,) in the frame of keyframe `kf`
    tt: np.ndarray     # (2,)
    twice_observed: bool
    kf: int            # keyframe whose camera frame `line` lives in


@dataclasses.dataclass
class BatchResult:
    trajectory: List[Pose]          # camera-to-world, rooted at keyframe 0
    edges_wt: np.ndarray            # (K-1, 6) final edge chain
    is_kf: np.ndarray               # (F,) which frames became keyframes
    kf_count: int
    landmarks: List[RetiredLandmark]  # live + retired, world-consistent
    stats: Dict[str, float]
    per_frame: Dict[str, np.ndarray]

    def world_segments(self, min_len: float = 1.0,
                       require_twice: bool = True) -> List[np.ndarray]:
        """Landmark world endpoint segments (slam.cpp:1508-1532)."""
        T_cw = [p for p in self.trajectory]
        segs = []
        for lm in self.landmarks:
            if require_twice and not lm.twice_observed:
                continue
            if abs(lm.tt[1] - lm.tt[0]) < min_len:
                continue
            p0 = np.asarray(_closest_point(jnp.asarray(lm.line)))
            v = lm.line[3:]
            vn = v / np.linalg.norm(v)
            Ti = T_cw[lm.kf]
            p1 = Ti.R @ (p0 + vn * lm.tt[0]) + Ti.t
            p2 = Ti.R @ (p0 + vn * lm.tt[1]) + Ti.t
            segs.append(np.concatenate([p1, p2]))
        return segs


class BatchSlam:
    """Replay a whole observation sequence on device.

    Usage::

        eng = BatchSlam(cfg)
        result = eng.run(frames)           # frames: [{fid: obs8}, ...]
    """

    # the compiled scan is cached GLOBALLY by (config, shapes): engine
    # instances are cheap to construct (bench.py's LC mode builds a fresh
    # stateful engine per run), and a per-instance cache forced a full
    # re-trace of the scan per instance, even with the persistent
    # XLA cache warm
    _runner_cache = {}

    def __init__(self, config: Optional[SlamConfig] = None,
                 lm_capacity: Optional[int] = None,
                 chunk_frames: Optional[int] = None,
                 assembly: Optional[str] = None):
        """``assembly`` overrides the window BA's assembly mode (default:
        ops/schur_ba.py default_assembly for the backend); it exists so
        that the modes can be timed against each other in the scan."""
        self.cfg = config or SlamConfig()
        self.dtype = jnp.dtype(self.cfg.compute_dtype)
        self.lm_capacity = lm_capacity
        self.chunk_frames = chunk_frames
        self.assembly = assembly or default_assembly(jax.default_backend())

    def _runner(self, Wn, Lp, Om, Rm, Fmax):
        sig = (self.cfg, self.dtype, self.assembly, Wn, Lp, Om, Rm, Fmax)
        if sig not in BatchSlam._runner_cache:
            base_key = jax.random.PRNGKey(self.cfg.rseed)
            step = _make_step(self.cfg, Wn, Lp, Om, Rm, Fmax, self.dtype,
                              base_key, self.assembly)

            @jax.jit
            def run(carry, xs):
                return jax.lax.scan(step, carry, xs)

            BatchSlam._runner_cache[sig] = run
        return BatchSlam._runner_cache[sig]

    def _runner_many(self, S, Wn, Lp, Om, Rm, Fmax):
        """vmapped scan: S independent sequences in ONE dispatch.

        The per-frame problems are tiny, so a batched scan can carry S
        sequences for about the wall of the slowest one instead of S
        serial replays (whether it does on a given device is a
        measurement; bench.py BENCH_MANY=vmap).  Under vmap the
        keyframe lax.cond runs both branches for every lane — acceptable
        on replay workloads where (nearly) every frame is a keyframe;
        gate-heavy sequences should prefer serial dispatch().  All lanes
        share the RANSAC key stream (exactly like serial replays of the
        same engine — the data differ per lane, the sampled hypothesis
        indices coincide).
        """
        sig = ("many", S, self.cfg, self.dtype, self.assembly, Wn, Lp, Om,
               Rm, Fmax)
        if sig not in BatchSlam._runner_cache:
            base_key = jax.random.PRNGKey(self.cfg.rseed)
            step = _make_step(self.cfg, Wn, Lp, Om, Rm, Fmax, self.dtype,
                              base_key, self.assembly)

            def run_one(carry, xs):
                return jax.lax.scan(step, carry, xs)

            BatchSlam._runner_cache[sig] = jax.jit(
                jax.vmap(run_one, in_axes=(None, 0)))
        return BatchSlam._runner_cache[sig]

    def run(self, frames: List[Dict[int, np.ndarray]],
            frame_ids: Optional[List[int]] = None,
            normalized: bool = True,
            lifetime: Optional[int] = None) -> BatchResult:
        return self.collect(self.dispatch(frames, frame_ids=frame_ids,
                                          normalized=normalized,
                                          lifetime=lifetime))

    def dispatch(self, frames: List[Dict[int, np.ndarray]],
                 frame_ids: Optional[List[int]] = None,
                 normalized: bool = True,
                 lifetime: Optional[int] = None):
        """Enqueue the replay without blocking (JAX dispatch is async).

        Returns an opaque handle for ``collect``.  Lets a caller overlap
        the next sequence's device replay with this one's host-side
        post-processing (bench.py pipelines seeds this way — the chip
        works while the host packs the previous seed's refine problem).
        """
        cfg = self.cfg
        if not normalized:
            frames = normalize_frames(frames, cfg.camera)

        pack = pack_frames(frames, window=cfg.ba_window_size,
                           frame_ids=frame_ids, lifetime=lifetime)
        Wn = 2 * cfg.ba_window_size
        Lcap = self.lm_capacity or bucket_for(pack.num_slots,
                                              cfg.line_buckets)
        if pack.num_slots > Lcap:
            raise ValueError(
                f"sequence needs {pack.num_slots} live landmark slots "
                f"> capacity {Lcap}; raise lm_capacity")
        Lp = Lcap + 1
        Om = bucket_for(pack.obs.shape[1], cfg.obs_buckets)
        Rm = pack.retire_slot.shape[1]
        F = len(frames)
        Fmax = F

        # pad per-frame tensors to the Om bucket
        def pad_om(a, fill=0):
            out = np.full(a.shape[:1] + (Om,) + a.shape[2:], fill,
                          dtype=a.dtype)
            out[:, :a.shape[1]] = a
            return out

        xs = (jnp.asarray(pad_om(pack.obs), self.dtype),
              jnp.asarray(pad_om(pack.slot)),
              jnp.asarray(pad_om(pack.valid, fill=False)),
              jnp.asarray(pack.retire_slot),
              jnp.asarray(pack.retire_valid),
              jnp.asarray(pack.frame_idx))

        carry0 = self._carry0(Wn, Lp, Om, Fmax)

        run = self._runner(Wn, Lp, Om, Rm, Fmax)
        carry, ys = run(carry0, xs)
        return (carry, ys, pack, Lcap)

    def _carry0(self, Wn, Lp, Om, Fmax) -> BatchCarry:
        return BatchCarry(
            kf_count=jnp.asarray(0, jnp.int32),
            fail_streak=jnp.asarray(0, jnp.int32),
            lm_line=jnp.zeros((Lp, 6), self.dtype),
            lm_active=jnp.zeros((Lp,), bool),
            lm_twice=jnp.zeros((Lp,), bool),
            lm_tt=jnp.zeros((Lp, 2), self.dtype),
            lm_pvn=jnp.zeros((Lp, 3), self.dtype),
            win_obs=jnp.zeros((Wn, Om, 8), self.dtype),
            win_slot=jnp.zeros((Wn, Om), jnp.int32),
            win_valid=jnp.zeros((Wn, Om), bool),
            win_member=jnp.zeros((Wn, Lp), bool),
            win_pose=jnp.zeros((Wn, 6), self.dtype),
            win_g=jnp.full((Wn,), -1, jnp.int32),
            edges=jnp.zeros((Fmax + 2, 6), self.dtype),
            sum_iters=jnp.asarray(0, jnp.int32),
            sum_init_cost=jnp.asarray(0.0, self.dtype),
            sum_final_cost=jnp.asarray(0.0, self.dtype),
            n_processed=jnp.asarray(0, jnp.int32))

    def run_many(self, seqs: List[List[Dict[int, np.ndarray]]],
                 normalized: bool = True,
                 lifetime: Optional[int] = None) -> List[BatchResult]:
        return self.collect_many(self.dispatch_many(
            seqs, normalized=normalized, lifetime=lifetime))

    def dispatch_many(self, seqs: List[List[Dict[int, np.ndarray]]],
                      normalized: bool = True,
                      lifetime: Optional[int] = None):
        """Enqueue S independent sequence replays as ONE vmapped scan.

        Shapes are unified across sequences (max frame count, shared
        observation/landmark/retirement buckets); shorter sequences pad
        with empty frames (the scan's skip branch).  Returns a handle for
        ``collect_many``.  See ``_runner_many`` for the cost model.
        """
        cfg = self.cfg
        if not normalized:
            seqs = [normalize_frames(f, cfg.camera) for f in seqs]
        packs = [pack_frames(f, window=cfg.ba_window_size,
                             lifetime=lifetime) for f in seqs]
        S = len(packs)
        Wn = 2 * cfg.ba_window_size
        need = max(p.num_slots for p in packs)
        Lcap = self.lm_capacity or bucket_for(need, cfg.line_buckets)
        if need > Lcap:
            raise ValueError(
                f"a sequence needs {need} live landmark slots "
                f"> capacity {Lcap}; raise lm_capacity")
        Lp = Lcap + 1
        Om = bucket_for(max(p.obs.shape[1] for p in packs),
                        cfg.obs_buckets)
        Rm = max(p.retire_slot.shape[1] for p in packs)
        Fs = [len(f) for f in seqs]
        Fmax = max(Fs)

        def pad2(a, M, fill=0):
            out = np.full((Fmax, M) + a.shape[2:], fill, dtype=a.dtype)
            out[:a.shape[0], :a.shape[1]] = a
            return out

        def pad1(a, fill=0):
            out = np.full((Fmax,), fill, dtype=a.dtype)
            out[:a.shape[0]] = a
            return out

        xs = (
            jnp.asarray(np.stack([pad2(p.obs, Om) for p in packs]),
                        self.dtype),
            jnp.asarray(np.stack([pad2(p.slot, Om) for p in packs])),
            jnp.asarray(np.stack([pad2(p.valid, Om, fill=False)
                                  for p in packs])),
            jnp.asarray(np.stack([pad2(p.retire_slot, Rm)
                                  for p in packs])),
            jnp.asarray(np.stack([pad2(p.retire_valid, Rm, fill=False)
                                  for p in packs])),
            jnp.asarray(np.stack([pad1(p.frame_idx) for p in packs])),
        )
        carry0 = self._carry0(Wn, Lp, Om, Fmax)
        run = self._runner_many(S, Wn, Lp, Om, Rm, Fmax)
        carry, ys = run(carry0, xs)
        return (carry, ys, packs, Lcap, Fs)

    def collect_many(self, handle) -> List[BatchResult]:
        carry, ys, packs, Lcap, Fs = handle
        carry, ys = jax.device_get((carry, ys))
        out = []
        for s, pack in enumerate(packs):
            c_s = BatchCarry(*(np.asarray(x)[s] for x in carry))
            y_s = BatchStepOut(*(np.asarray(x)[s][:Fs[s]] for x in ys))
            out.append(self._collect(c_s, y_s, pack, Lcap))
        return out

    def collect(self, handle) -> BatchResult:
        carry, ys, pack, Lcap = handle
        carry, ys = jax.device_get((carry, ys))
        return self._collect(carry, ys, pack, Lcap)

    def _collect(self, carry, ys, pack, Lcap) -> BatchResult:
        K = int(carry.kf_count)
        edges = np.asarray(carry.edges, np.float64)[:max(K - 1, 0)]

        # trajectory: compose the edge chain from keyframe 0
        # (slam.cpp:1473-1496 via metric_embedding(0))
        T = Pose()
        traj = [T.inv()]
        for g in range(K - 1):
            T = Pose.from_wt(edges[g]) @ T
            traj.append(T.inv())

        # landmarks: retired (emitted mid-scan) + still-live slots
        lms: List[RetiredLandmark] = []
        rl = np.asarray(ys.ret_line, np.float64)
        rt = np.asarray(ys.ret_tt, np.float64)
        rtw = np.asarray(ys.ret_twice)
        rkf = np.asarray(ys.ret_kf)
        rv = np.asarray(ys.ret_valid)
        for f in range(rl.shape[0]):
            for k in range(rl.shape[1]):
                if rv[f, k]:
                    lms.append(RetiredLandmark(
                        rl[f, k], rt[f, k], bool(rtw[f, k]),
                        int(rkf[f, k])))
        lm_line = np.asarray(carry.lm_line, np.float64)
        lm_tt = np.asarray(carry.lm_tt, np.float64)
        lm_active = np.asarray(carry.lm_active)
        lm_twice = np.asarray(carry.lm_twice)
        for s in range(Lcap):
            if lm_active[s]:
                lms.append(RetiredLandmark(
                    lm_line[s], lm_tt[s], bool(lm_twice[s]), K - 1))

        n = max(int(carry.n_processed), 1)
        stats = {
            "num_keyframes": K,
            "num_landmarks": len(lms),
            "num_edges": max(K - 1, 0),
            "avg_num_iterations": int(carry.sum_iters) / n,
            "avg_initial_cost": float(carry.sum_init_cost) / n,
            "avg_final_cost": float(carry.sum_final_cost) / n,
        }
        per_frame = {
            "is_kf": np.asarray(ys.is_kf),
            "wt": np.asarray(ys.wt, np.float64),
            "n_common": np.asarray(ys.n_common),
            "ransac_score": np.asarray(ys.ransac_score),
            "n_final_inliers": np.asarray(ys.n_final_inliers),
            "ba_iters": np.asarray(ys.ba_iters),
            "ba_init_cost": np.asarray(ys.ba_init_cost, np.float64),
            "ba_final_cost": np.asarray(ys.ba_final_cost, np.float64),
        }
        return BatchResult(traj, edges, per_frame["is_kf"], K, lms, stats,
                           per_frame)

    def save_trajectory(self, result: BatchResult, path: str):
        from ..evalio.writers import write_trajectory
        write_trajectory(path, result.trajectory)
