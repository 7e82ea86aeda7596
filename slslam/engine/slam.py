"""The SLAM engine: per-frame pipeline over jitted device kernels.

Re-designs class SLAM (/root/reference/src/slam.{h,cpp}) as a functional-core
/ imperative-shell split: this module owns the host-side map registries, id
bookkeeping, metric embedding, and window selection, and calls fixed-shape
jitted kernels (ops/) for every hot computation — RANSAC VO, motion-only BA,
windowed Schur-LM BA, pose-graph optimization, and batched triangulation.
All device problems are padded to capacity buckets so jit caches stay warm.

Per-frame cycle (main.cpp:45-80):
  start_cycle -> grab_frame -> check_input_data -> check_keyframe_motion
  -> add_new_keyframe -> [place_recognized -> loop_closure ->
  pose_optimization] -> local_bundle_adjustment -> end_cycle

Intended scale: the ONLINE regime of the reference — up to a few
thousand keyframes.  Two per-keyframe costs are deliberately simple at
that scale and become the ceiling beyond it: ``consistency_broken``
walks every edge on the host (O(E) Python per keyframe), and
``pose_optimization`` assembles a dense (6V)^2 reduced system (the
reference's own sequences top out at 319 keyframes; both are fine to
~3k, quadratic beyond).  Larger replay/mapping workloads belong on the
batch path (engine/batch.py + engine/batch_lc.py), whose PGO/refine use
the matrix-free solvers (ops/schur_cg.py) with no dense V^2 term.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

import jax
import jax.numpy as jnp
import numpy as np

from .. import geometry as geo
from ..config import SlamConfig, bucket_for
from ..hostgeom import Pose, line_from_pose, line_to_pose, \
    normalize, rotation_angle, skew
from ..ops.pose_graph import pose_graph_opt
from ..ops.schur_ba import staged_local_ba
from ..ops.triangulate import triangulate_lines
from ..ops.vo_pipeline import vo_pipeline
from ..utils.stopwatch import StopWatch
from .embedding import metric_embedding
from .state import Edge, Keyframe, Landmark, MapState


_LINE_ENCODERS = {"orth": geo.av_to_orth, "aid": geo.av_to_aid,
                  "asd": geo.av_to_asd}
_LINE_DECODERS = {"orth": geo.orth_to_av, "aid": geo.aid_to_av,
                  "asd": geo.asd_to_av}


def _encode_lines_host(line_av, line_param):
    """(N, 6) -> (N, 4) on the host (no device round trip) when a NumPy
    mirror exists; falls back to the jnp implementation otherwise."""
    import slslam.hostgeom as hg
    if line_param == "orth":
        return hg.av_to_orth_np(line_av)
    if line_param == "aid":
        return hg.av_to_aid_np(line_av)
    return np.asarray(_LINE_ENCODERS[line_param](jnp.asarray(line_av)),
                      np.float64)


def _decode_lines_host(line_p4, line_param):
    import slslam.hostgeom as hg
    if line_param == "orth":
        return hg.orth_to_av_np(line_p4)
    if line_param == "aid":
        return hg.aid_to_av_np(line_p4)
    return np.asarray(_LINE_DECODERS[line_param](jnp.asarray(line_p4)),
                      np.float64)


class Slam:
    """The engine. One instance per sequence (reference SLAM ctor,
    slam.cpp:30-40)."""

    def __init__(self, config: Optional[SlamConfig] = None):
        self.cfg = config or SlamConfig()
        self.state = MapState()
        self.dtype = jnp.dtype(self.cfg.compute_dtype)

        self.frame_id = -1
        self.curr_pose = Pose()
        self.curr_obs: Dict[int, np.ndarray] = {}
        self.prev_kf_obs: Dict[int, np.ndarray] = {}
        self.final_inliers: Set[int] = set()
        self._vo_fail_streak = 0
        self._last_failed_motion: Optional[Pose] = None
        self._vo_fail_kind: Optional[str] = None
        self.ba_kfs: Dict[int, int] = {}
        self.prev_ba_kfs: Set[int] = set()
        self.match_result: Dict[int, int] = {}
        self.lc_kf_id = -1
        self.lc_cnt = 0

        self.key = jax.random.PRNGKey(self.cfg.rseed)
        self.stop_watch = StopWatch()

        # optional mesh for distributed solves (cfg.mesh_devices > 1):
        # local BA runs line-sharded, PGO edge-sharded
        self.mesh = None
        if self.cfg.mesh_devices and self.cfg.mesh_devices > 1:
            from jax.sharding import Mesh
            devs = jax.devices()[:self.cfg.mesh_devices]
            if len(devs) < self.cfg.mesh_devices:
                raise ValueError(
                    f"mesh_devices={self.cfg.mesh_devices} but only "
                    f"{len(devs)} devices available")
            self.mesh = Mesh(np.array(devs), ("obs",))

        # optional loop-closure subsystem (slslam.loopclosure): a
        # PlaceRecognizer plus a descriptor source mapping
        # (frame_id, [feature ids]) -> (F, 72) descriptors.  The released
        # reference stubs this out (slam.cpp:1088-1104).
        self.place_recognizer = None
        self.descriptor_source = None

        # per-frame progress logging (the reference's cout lines,
        # slam.cpp:52,293-294,314,1426); off by default
        self.verbose = False

        # run statistics (reference m_sum_*, slam.cpp:37-39,949-952)
        self.sum_init_cost = 0.0
        self.sum_final_cost = 0.0
        self.sum_num_iteration = 0
        self.num_frames_processed = 0

    # ------------------------------------------------------------------
    # cycle plumbing
    # ------------------------------------------------------------------

    def start_cycle(self, frame_id: int):
        """slam.cpp:50-58."""
        self.frame_id = frame_id
        self.curr_obs = {}
        self.ba_kfs = {}
        self.match_result = {}

    def grab_frame(self, obs: Dict[int, np.ndarray],
                   normalized: bool = True):
        """Ingest one frame of stereo line observations.

        obs: feature_id -> (8,) endpoints.  If not `normalized`, pixel
        coordinates are converted with the calibration
        (slam.cpp:112-135).  Applies the loop-closure id remap
        (match_lookup) and refreshes landmark visibility (slam.cpp:62-108).
        """
        for lm in self.state.lms.values():
            lm.currently_visible = False

        cam = self.cfg.camera
        for fid, o in obs.items():
            o = np.asarray(o, np.float64)
            if not normalized:
                o = o.copy()
                o[0::2] = o[0::2] / cam.fx - cam.cx / cam.fx
                o[1::2] = o[1::2] / cam.fy - cam.cy / cam.fy
            fid = self.state.match_lookup.get(fid, fid)
            self.curr_obs[fid] = o
            if fid in self.state.lms:
                self.state.lms[fid].currently_visible = True

    def check_input_data(self) -> int:
        """slam.cpp:139-147: 1 = no obs, 2 = no previous KF, 0 = proceed."""
        if not self.curr_obs:
            return 1
        if not self.prev_kf_obs:
            return 2
        return 0

    def end_cycle(self):
        """slam.cpp:1553-1555."""
        self.prev_kf_obs = self.curr_obs

    def process_frame(self, obs: Dict[int, np.ndarray], frame_id: int,
                      normalized: bool = True) -> bool:
        """One full frame of the reference main loop (main.cpp:45-80).

        Returns True if the frame became a keyframe.
        """
        self.start_cycle(frame_id)
        self.grab_frame(obs, normalized=normalized)
        status = self.check_input_data()
        if status == 1:
            return False
        if status == 2:
            self.add_new_keyframe(add_edge=False)
            self.end_cycle()
            return True
        if not self.check_keyframe_motion():
            return False
        self.add_new_keyframe(add_edge=True)
        if self.place_recognized() and self.loop_closure():
            if self.consistency_broken():
                self.pose_optimization()
        self.local_bundle_adjustment()
        self.end_cycle()
        self.num_frames_processed += 1
        return True

    # ------------------------------------------------------------------
    # landmark initialization
    # ------------------------------------------------------------------

    def _add_lms(self):
        """slam.cpp:161-186: triangulate new features, append observations
        of known ones.  All new features triangulate in one batched kernel
        call."""
        st = self.state
        kfid = st.last_kf_id()
        new_kfid = (kfid + 1) if kfid is not None else 0

        new_ids = [fid for fid in self.curr_obs if fid not in st.lms]
        new_set = set(new_ids)
        if new_ids:
            # pad to a capacity bucket: keeps the jit cache to a handful of
            # shapes across the whole run
            Nb = bucket_for(len(new_ids), self.cfg.obs_buckets)
            O = np.zeros((Nb, 8))
            O[:len(new_ids)] = np.stack([self.curr_obs[f] for f in new_ids])
            lines = np.asarray(triangulate_lines(
                jnp.asarray(O, self.dtype), self.cfg.camera.baseline,
                inverse_depth=self.cfg.inverse_depth),
                np.float64)[:len(new_ids)]
            for fid, line in zip(new_ids, lines):
                lm = Landmark(line=line, init_kfid=new_kfid)
                lm.tt = np.zeros(2)
                lm.pvn = normalize(line[3:])
                lm.obs_vec.append((new_kfid, self.curr_obs[fid]))
                st.lms[fid] = lm

        for fid, o in self.curr_obs.items():
            if fid not in new_set:
                st.lms[fid].obs_vec.append((new_kfid, o))

    # ------------------------------------------------------------------
    # visual odometry
    # ------------------------------------------------------------------

    def pose_estimation(self, obs0: Dict[int, np.ndarray],
                        obs1: Dict[int, np.ndarray],
                        max_t_norm: Optional[float] = None
                        ) -> Optional[Pose]:
        """slam.cpp:244-319: RANSAC + motion-only BA + final inliers.

        Landmark lines are fetched in the current embedding frame; the
        caller must have run metric_embedding at the reference frame.
        Returns the motion (frame of obs0 -> frame of obs1) or None.
        """
        self.stop_watch.tick("pose_estimation")
        st = self.state
        cfg = self.cfg
        # failure taxonomy for the recovery streak (mirrors engine/batch.py
        # step: "sparse" = too few common features resets the streak,
        # "ransac" = a genuine solve failure with enough features
        # increments it)
        self._vo_fail_kind = None

        comm = sorted(set(obs0) & set(obs1) & set(st.lms))
        if len(comm) < cfg.ransac_min_sample:
            self._vo_fail_kind = "sparse"
            self.stop_watch.tock("pose_estimation")
            return None

        lines = {}
        for fid in comm:
            lm = st.lms[fid]
            lines[fid] = line_from_pose(lm.line, st.kfs[lm.init_kfid].T)

        N = len(comm)
        Nb = bucket_for(N, cfg.corr_buckets)
        o0 = np.zeros((Nb, 8))
        o1 = np.zeros((Nb, 8))
        ln = np.zeros((Nb, 6))
        ln[:, 5] = 1.0  # benign direction for padding
        valid = np.zeros(Nb, bool)
        for k, fid in enumerate(comm):
            o0[k] = obs0[fid]
            o1[k] = obs1[fid]
            ln[k] = lines[fid]
            valid[k] = True

        self.key, sub = jax.random.split(self.key)
        res = vo_pipeline(
            jnp.asarray(o0, self.dtype), jnp.asarray(o1, self.dtype),
            jnp.asarray(ln, self.dtype), jnp.asarray(valid), sub,
            cfg.camera.baseline, cfg.error_thr, cfg.huber_delta,
            max_t_norm=(max_t_norm if max_t_norm is not None
                        else cfg.ransac_max_t_norm),
            num_hyp=cfg.ransac_num_hypotheses,
            sample_size=cfg.ransac_min_sample,
            robust=cfg.robust, max_iters=cfg.moba_max_iter,
            line_param=cfg.line_param,
            relin_iters=cfg.vo_relin_iters)
        # one fused device->host fetch for the whole VO result
        best_score, wt, errors = jax.device_get(
            (res.ransac_score, res.wt, res.final_errors))

        if not np.all(np.isfinite(wt)):
            # failure containment: a non-finite solve result is treated as
            # a tracking failure for this frame, never written to the map
            # (counts toward the recovery streak like any RANSAC failure,
            # mirroring batch.py's `failed`, but offers no motion)
            self._vo_fail_kind = "ransac"
            self.stop_watch.tock("pose_estimation")
            return None
        if int(best_score) < cfg.ransac_min_sample:
            # keep the best-effort motion for the recovery path
            # (check_keyframe_motion; SlamConfig.vo_fail_recovery)
            self._vo_fail_kind = "ransac"
            self._last_failed_motion = Pose.from_wt(
                np.asarray(wt, np.float64))
            self.final_inliers = {
                comm[k] for k in range(N) if errors[k] < cfg.error_thr}
            self.stop_watch.tock("pose_estimation")
            return None

        self.final_inliers = {
            comm[k] for k in range(N) if errors[k] < cfg.error_thr}

        if self.verbose:
            # reference format: "Feature Num: <common>-<ransac>-<final>"
            print(f"{self.frame_id}:\tFeature Num: {N}-{int(best_score)}"
                  f"-{len(self.final_inliers)}")

        self.stop_watch.tock("pose_estimation")
        return Pose.from_wt(np.asarray(wt, np.float64))

    def check_keyframe_motion(self) -> bool:
        """slam.cpp:223-240: VO against the previous keyframe; KF iff the
        motion exceeds the rotation/translation thresholds.

        Failure containment (no reference analog; mirrors
        engine/batch.py): the reference retries the SAME stale keyframe
        forever after a RANSAC failure, so a few sparse frames kill
        tracking for the rest of the run.  After
        ``vo_fail_recovery`` consecutive failures with enough common
        features, the best-effort polished motion is accepted as a
        recovery keyframe; windowed BA re-estimates it jointly.
        """
        st = self.state
        cfg = self.cfg
        metric_embedding(st, st.last_kf_id())
        self._last_failed_motion = None
        motion = self.pose_estimation(self.prev_kf_obs, self.curr_obs)
        if motion is None:
            # streak bookkeeping mirrors engine/batch.py (CLAUDE.md: the
            # engine mirrors stay in sync): a genuine RANSAC failure with
            # enough common features — including a non-finite solve —
            # increments the streak; a too-sparse frame resets it.
            if self._vo_fail_kind == "ransac":
                self._vo_fail_streak += 1
                if (cfg.vo_fail_recovery > 0
                        and self._vo_fail_streak >= cfg.vo_fail_recovery
                        and self._last_failed_motion is not None
                        and np.linalg.norm(self._last_failed_motion.t)
                        <= 2.0 * cfg.ransac_max_t_norm):
                    self.curr_pose = self._last_failed_motion
                    self._vo_fail_streak = 0
                    return True
            else:
                self._vo_fail_streak = 0
            return False
        if (rotation_angle(motion.R) < cfg.kf_rot_thr
                and np.linalg.norm(motion.t) < cfg.kf_tr_thr):
            self._vo_fail_streak = 0
            return False
        self.curr_pose = motion
        self._vo_fail_streak = 0
        return True

    # ------------------------------------------------------------------
    # keyframe / map growth
    # ------------------------------------------------------------------

    def add_new_keyframe(self, add_edge: bool):
        """slam.cpp:730-761."""
        st = self.state
        kf = Keyframe(T=self.curr_pose.copy())

        prev_id = st.last_kf_id()
        # member lms: final inliers recorded on both the new and previous KF
        # (slam.cpp:151-157)
        for fid in self.final_inliers:
            kf.member_lms.add(fid)
            if prev_id is not None:
                st.kfs[prev_id].member_lms.add(fid)

        self._add_lms()

        new_id = (prev_id + 1) if prev_id is not None else 0
        if add_edge:
            e = Edge.from_pose(self.curr_pose)
            st.edges[(prev_id, new_id)] = e
            st.edges[(new_id, prev_id)] = e.inverse()
            st.edge_set.add((prev_id, new_id))
            kf.neighbor_kfs.add(prev_id)
            st.kfs[prev_id].neighbor_kfs.add(new_id)

        st.kfs[new_id] = kf

    # ------------------------------------------------------------------
    # local bundle adjustment
    # ------------------------------------------------------------------

    def local_bundle_adjustment(self):
        """slam.cpp:1370-1427: embed at newest KF, window = first 2W KFs by
        metric distance, BA, then write BA results back into the edge
        constraints."""
        st = self.state
        cfg = self.cfg

        self.stop_watch.tick("embedding")
        order = metric_embedding(st, st.last_kf_id())
        self.stop_watch.tock("embedding")
        self.ba_kfs = {}
        for rank, (_, kid) in enumerate(order):
            if rank >= 2 * cfg.ba_window_size:
                break
            self.ba_kfs[kid] = rank

        self.stop_watch.tick("local_ba")
        self._bundle_adjustment()
        self.stop_watch.tock("local_ba")

        # refresh all intra-free-window edges: T and C := BA relative pose
        # (slam.cpp:1390-1416) — this is how BA results persist in the
        # relative map.
        free = sorted(k for k, rank in self.ba_kfs.items()
                      if rank < cfg.ba_window_size)
        for i in range(len(free)):
            for j in range(i + 1, len(free)):
                n1, n2 = free[i], free[j]
                if (n1, n2) not in st.edges:
                    continue
                T = st.kfs[n2].T.rel_to(st.kfs[n1].T)
                st.edges[(n1, n2)].T = T.copy()
                st.edges[(n1, n2)].C = T.copy()
                Ti = T.inv()
                st.edges[(n2, n1)].T = Ti.copy()
                st.edges[(n2, n1)].C = Ti.copy()

        self.delete_lms()
        self.stop_watch.tick("endpoints")
        self.extend_end_points()
        self.stop_watch.tock("endpoints")

    def _bundle_adjustment(self):
        """slam.cpp:795-975: pack the window problem, solve, write back."""
        st = self.state
        cfg = self.cfg
        self.stop_watch.tick("ba_pack")

        # free cameras: window rank < W, registered in ascending kf id
        kfid_map: Dict[int, int] = {}
        vec_kfs: List[int] = []
        cam_wt: List[np.ndarray] = []
        lm_count: Dict[int, int] = {}
        for kid in sorted(self.ba_kfs):
            if self.ba_kfs[kid] >= cfg.ba_window_size:
                continue
            kf = st.kfs[kid]
            for fid in kf.member_lms:
                lm_count[fid] = lm_count.get(fid, 0) + 1
            kfid_map[kid] = len(vec_kfs)
            vec_kfs.append(kid)
            cam_wt.append(st.kfs[kid].T.wt())

        num_free = len(vec_kfs)

        # vectorized observation gathering: per-landmark NumPy masks
        # instead of a per-observation Python loop (hot on large windows)
        max_kf = st.last_kf_id()
        in_window = np.zeros(max_kf + 1, bool)
        for kid in self.ba_kfs:
            in_window[kid] = True
        kfidx_of = np.full(max_kf + 1, -1, np.int64)
        for kid, ci in kfid_map.items():
            kfidx_of[kid] = ci

        obs_chunks: List[np.ndarray] = []
        cam_chunks: List[np.ndarray] = []
        line_chunks: List[np.ndarray] = []
        cam_fixed_flags: List[bool] = [False] * num_free
        line_ids: List[int] = []

        for fid in sorted(lm_count):
            if lm_count[fid] < 2 or fid not in st.lms:
                continue
            lm = st.lms[fid]
            lm.twice_observed = True
            lm.ba_updated = True
            kfids, obs_arr = lm.obs_arrays()
            mask = in_window[kfids]
            if not mask.any():
                continue
            sel_kfids = kfids[mask]
            # register out-of-free-window observers as fixed cameras
            for kid in np.unique(sel_kfids[kfidx_of[sel_kfids] < 0]):
                ci = len(vec_kfs)
                kfid_map[int(kid)] = ci
                kfidx_of[kid] = ci
                vec_kfs.append(int(kid))
                cam_wt.append(st.kfs[int(kid)].T.wt())
                cam_fixed_flags.append(True)
            obs_chunks.append(obs_arr[mask])
            cam_chunks.append(kfidx_of[sel_kfids])
            line_chunks.append(np.full(mask.sum(), len(line_ids), np.int64))
            line_ids.append(fid)

        if not line_ids or num_free == 0:
            return

        # batched line fetch into the embedding frame + host-side encode
        Ti_cache = {}
        line_av = np.empty((len(line_ids), 6))
        for n, fid in enumerate(line_ids):
            lm = st.lms[fid]
            Ti = Ti_cache.get(lm.init_kfid)
            if Ti is None:
                Ti = st.kfs[lm.init_kfid].T.inv()
                Ti_cache[lm.init_kfid] = Ti
            line_av[n, :3] = Ti.R @ lm.line[:3] + Ti.t
            line_av[n, 3:] = Ti.R @ lm.line[3:]
        line_orth = _encode_lines_host(line_av, cfg.line_param)

        obs_rows = np.concatenate(obs_chunks)
        obs_cam = np.concatenate(cam_chunks)
        obs_line = np.concatenate(line_chunks)

        C, L, O = len(vec_kfs), len(line_ids), len(obs_rows)
        Cb = bucket_for(C, cfg.cam_buckets)
        Lb = bucket_for(L, cfg.line_buckets)
        Ob = bucket_for(O, cfg.obs_buckets)

        cam_p = np.zeros((Cb, 6))
        cam_p[:C] = np.stack(cam_wt)
        cam_free = np.zeros(Cb, bool)
        cam_free[:C] = ~np.asarray(cam_fixed_flags)

        lorth = np.zeros((Lb, 4))
        lorth[:, 3] = 0.5
        lorth[:L] = line_orth
        if cfg.ba_init_jitter:
            # deterministic annealing jitter on free lines only
            # (see SlamConfig.ba_init_jitter)
            jrng = np.random.default_rng(
                (cfg.rseed, self.frame_id, 0x0B0A))
            lorth[:L] += cfg.ba_init_jitter * jrng.standard_normal((L, 4))
        line_free = np.zeros(Lb, bool)
        line_free[:L] = True

        obs_p = np.zeros((Ob, 8))
        obs_p[:O] = obs_rows
        ocam = np.zeros(Ob, np.int32)
        ocam[:O] = obs_cam
        olin = np.zeros(Ob, np.int32)
        olin[:O] = obs_line
        valid = np.zeros(Ob, bool)
        valid[:O] = True

        self.stop_watch.tock("ba_pack")
        if self.mesh is not None:
            from ..ops.schur_ba import lines_gn
            from ..parallel.dist_ba import (dist_local_ba_lines,
                                            partition_by_line)
            if cfg.lines_gn_iters > 0:
                # the staged lines-GN runs on the full problem BEFORE
                # line partitioning, so the sharded solve matches the
                # single-device staged_local_ba path (tests/
                # test_distributed.py asserts the mirror)
                lorth = np.asarray(lines_gn(
                    jnp.asarray(cam_p, self.dtype),
                    jnp.asarray(lorth, self.dtype),
                    jnp.asarray(obs_p, self.dtype), jnp.asarray(ocam),
                    jnp.asarray(olin), jnp.asarray(valid),
                    jnp.asarray(line_free), cfg.camera.baseline,
                    cfg.huber_delta, robust=cfg.robust,
                    iters=cfg.lines_gn_iters,
                    line_param=cfg.line_param), np.float64)
            n = self.mesh.devices.size
            lo, lf, ob, oc_sh, ol_sh, ov, perm = partition_by_line(
                lorth, line_free, obs_p, ocam, olin, valid, n)
            cam_dev, line_dev, stats_dev = dist_local_ba_lines(
                self.mesh, jnp.asarray(cam_p, self.dtype),
                jnp.asarray(lo, self.dtype), jnp.asarray(ob, self.dtype),
                jnp.asarray(oc_sh), jnp.asarray(ol_sh), jnp.asarray(ov),
                jnp.asarray(cam_free), jnp.asarray(lf),
                cfg.camera.baseline, cfg.huber_delta,
                robust=cfg.robust, max_iters=cfg.max_num_iter,
                line_param=cfg.line_param)
            cam_out, line_sh, stats = jax.device_get(
                (cam_dev, line_dev, stats_dev))
            line_out = np.asarray(line_sh,
                                  np.float64).reshape(-1, 4)[perm]
            cam_out = np.asarray(cam_out, np.float64)
        else:
            cam_dev, line_dev, stats_dev = staged_local_ba(
                jnp.asarray(cam_p, self.dtype),
                jnp.asarray(lorth, self.dtype),
                jnp.asarray(obs_p, self.dtype), jnp.asarray(ocam),
                jnp.asarray(olin), jnp.asarray(valid),
                jnp.asarray(cam_free),
                jnp.asarray(line_free), cfg.camera.baseline,
                cfg.huber_delta,
                robust=cfg.robust, max_iters=cfg.max_num_iter,
                line_param=cfg.line_param,
                gn_iters=cfg.lines_gn_iters,
                cam_anchor_sigmas=(
                    (jnp.asarray(cfg.window_anchor_sigma_rot, self.dtype),
                     jnp.asarray(cfg.window_anchor_sigma_t, self.dtype))
                    if cfg.window_anchor_sigma_rot > 0
                    and cfg.window_anchor_sigma_t > 0 else None))
            # single fused device->host fetch
            cam_out, line_out, stats = jax.device_get(
                (cam_dev, line_dev, stats_dev))
            cam_out = np.asarray(cam_out, np.float64)
            line_out = np.asarray(line_out, np.float64)

        self.sum_num_iteration += int(stats.iterations)
        self.sum_init_cost += float(stats.initial_cost)
        self.sum_final_cost += float(stats.final_cost)
        if self.verbose:
            print(f"\tBA: {C} cams / {L} lines / {O} obs, "
                  f"{int(stats.iterations)} iters, cost "
                  f"{float(stats.initial_cost):.3e} -> "
                  f"{float(stats.final_cost):.3e}")

        if not (np.all(np.isfinite(cam_out)) and
                np.all(np.isfinite(line_out))):
            # failure containment: reject the whole solve rather than
            # poisoning the relative map (no reference analog — the new
            # build's failure-detection policy)
            return
        # write back poses first, then lines (which re-read the updated
        # init-KF poses) — matching the reference order (slam.cpp:957-972)
        for ci, kid in enumerate(vec_kfs):
            st.kfs[kid].T = Pose.from_wt(cam_out[ci])
        line_av_out = _decode_lines_host(line_out[:L], cfg.line_param)
        T_cache = {}
        for li, fid in enumerate(line_ids):
            lm = st.lms[fid]
            T = T_cache.get(lm.init_kfid)
            if T is None:
                T = st.kfs[lm.init_kfid].T
                T_cache[lm.init_kfid] = T
            lm.line = line_to_pose(line_av_out[li], T)

    # ------------------------------------------------------------------
    # landmark lifecycle
    # ------------------------------------------------------------------

    def delete_lms(self):
        """slam.cpp:765-791.  NOTE: in the released reference,
        curr_ba_kfs is never populated, so deletion never fires; we
        reproduce that default and gate the *intended* semantics behind
        cfg.gc_landmarks."""
        gc = getattr(self.cfg, "gc_landmarks", False)
        if not gc:
            self.prev_ba_kfs = set()
            return
        st = self.state
        curr = set(self.ba_kfs)
        for kid in self.prev_ba_kfs - curr:
            kf = st.kfs.get(kid)
            if kf is None:
                continue
            for fid in list(kf.member_lms):
                lm = st.lms.get(fid)
                if lm is None:
                    kf.member_lms.discard(fid)
                    continue
                if not lm.twice_observed:
                    del st.lms[fid]
        self.prev_ba_kfs = curr

    def extend_end_points(self):
        """slam.cpp:979-1084: maintain finite drawable endpoint intervals
        tt on the infinite landmark lines.  Fully vectorized over the
        active (BA-updated, currently visible) landmark set.

        The reference's Plücker-matrix intersection Lc @ pi (slam.cpp:
        1008-1024) simplifies: for pi = (n, 0) (a plane through the
        camera center), Lc @ pi = (nc x n, -vc . n).
        """
        st = self.state
        thr = self.cfg.extension_length
        active = [lm for lm in st.lms.values()
                  if lm.ba_updated and lm.currently_visible]
        for lm in active:
            lm.ba_updated = False
        if not active:
            return
        M = len(active)
        line = np.stack([lm.line for lm in active])      # init-KF frame
        pvn = np.stack([lm.pvn for lm in active])
        tt_cur = np.stack([lm.tt for lm in active])
        obs = np.stack([lm.obs_vec[-1][1] for lm in active])

        def nrm(v):
            n = np.linalg.norm(v, axis=-1, keepdims=True)
            return np.where(n > 0, v / np.where(n > 0, n, 1.0), v)

        # direction-change reset (slam.cpp:990-996)
        cvn = nrm(line[:, 3:])
        ang = np.arccos(np.clip(np.sum(cvn * pvn, axis=1), -1.0, 1.0))
        reset = ang > self.cfg.line_vn_angle_thr
        pvn_new = np.where(reset[:, None], cvn, pvn)
        tt_cur = np.where(reset[:, None], 0.0, tt_cur)

        # init poses (world->init-cam in the current embedding)
        Rk = np.empty((M, 3, 3))
        tk = np.empty((M, 3))
        cache = {}
        for i, lm in enumerate(active):
            P = cache.get(lm.init_kfid)
            if P is None:
                P = st.kfs[lm.init_kfid].T
                cache[lm.init_kfid] = P
            Rk[i] = P.R
            tk[i] = P.t

        # line in the embedding frame (line_from_pose batched)
        Rki = np.transpose(Rk, (0, 2, 1))
        tki = -np.einsum("mij,mj->mi", Rki, tk)
        pc = np.einsum("mij,mj->mi", Rki, line[:, :3]) + tki
        vc = np.einsum("mij,mj->mi", Rki, line[:, 3:])
        nc = np.cross(pc, vc)

        one = np.ones((M, 1))
        p11 = np.concatenate([obs[:, 0:2], one], axis=1)
        p21 = np.concatenate([obs[:, 2:4], one], axis=1)
        ln = np.cross(p11, p21)[:, :2]
        n_ln = np.linalg.norm(ln, axis=1)
        ok = n_ln > 0
        ln = ln / np.maximum(n_ln, 1e-300)[:, None]
        zero = np.zeros((M, 1))
        p12 = p11 + np.concatenate([ln, zero], axis=1)
        p22 = p21 + np.concatenate([ln, zero], axis=1)

        # planes through the camera center: pi = (p_a x p_b, 0)
        n1 = np.cross(p11, p12)
        n2 = np.cross(p21, p22)
        e1_xyz = np.cross(nc, n1)
        e1_w = -np.sum(vc * n1, axis=1)
        e2_xyz = np.cross(nc, n2)
        e2_w = -np.sum(vc * n2, axis=1)

        vv = np.sum(vc * vc, axis=1)
        p0 = np.cross(vc, nc) / vv[:, None]
        vnn = vc / np.sqrt(vv)[:, None]
        p0_dist = np.linalg.norm(p0, axis=1)
        ok &= p0_dist <= thr
        ok &= (np.abs(e1_w) >= 1e-12) & (np.abs(e2_w) >= 1e-12)
        pc1 = e1_xyz / np.where(e1_w == 0, 1.0, e1_w)[:, None]
        pc2 = e2_xyz / np.where(e2_w == 0, 1.0, e2_w)[:, None]
        ok &= (pc1[:, 2] >= 0) & (pc2[:, 2] >= 0)

        t1 = np.sum(vnn * (pc1 - p0), axis=1)
        t2 = np.sum(vnn * (pc2 - p0), axis=1)
        tt_lo = np.minimum(t1, t2)
        tt_hi = np.maximum(t1, t2)
        extend = np.sqrt(np.maximum(thr * thr - p0_dist ** 2, 0.0))
        tt_lo = np.clip(tt_lo, -extend, extend)
        tt_hi = np.clip(tt_hi, -extend, extend)
        ok &= tt_lo != tt_hi

        # interval transport between frames (gc_tt_to/from_pose):
        # offset = init_pose.t . v_hat (in the init frame)
        v_init_n = nrm(line[:, 3:])
        offset = np.sum(tk * v_init_n, axis=1)
        uninit = (tt_cur[:, 0] == 0) & (tt_cur[:, 1] == 0)
        tt1_lo = np.where(uninit, tt_lo,
                          np.minimum(tt_cur[:, 0] - offset, tt_lo))
        tt1_hi = np.where(uninit, tt_hi,
                          np.maximum(tt_cur[:, 1] - offset, tt_hi))
        new_lo = tt1_lo + offset
        new_hi = tt1_hi + offset

        for i, lm in enumerate(active):
            lm.pvn = pvn_new[i]
            lm.tt = (np.array([new_lo[i], new_hi[i]]) if ok[i]
                     else tt_cur[i].copy())

    # ------------------------------------------------------------------
    # loop closure / pose graph
    # ------------------------------------------------------------------

    def place_recognized(self) -> bool:
        """Query the place-recognition backend for the new keyframe.

        Mirrors the reference's intended (commented) flow
        (slam.cpp:1088-1104): on a database hit, keep only matches whose
        current feature is a VO inlier.  Returns False (the release
        behavior) when no recognizer is attached.
        """
        if self.place_recognizer is None or self.descriptor_source is None:
            return False
        kf_id = self.state.last_kf_id()
        feat_ids = sorted(self.curr_obs)
        desc = self.descriptor_source(self.frame_id, feat_ids)
        if desc is None or len(desc) != len(feat_ids):
            return False
        hit = self.place_recognizer.query_and_insert(kf_id, feat_ids, desc)
        if hit is None:
            return False
        lc_kf_id, match_result = hit
        self.match_result = {
            cid: lid for cid, lid in match_result.items()
            if cid in self.final_inliers}
        if len(self.match_result) < self.cfg.ransac_min_sample:
            return False
        self.lc_kf_id = lc_kf_id
        return True

    def loop_closure(self) -> bool:
        """slam.cpp:1108-1211: estimate the loop relative pose from the
        matched old landmarks, insert the loop edge, and merge landmark
        identities."""
        st = self.state
        self.lc_cnt += 1

        metric_embedding(st, self.lc_kf_id)

        obs0: Dict[int, np.ndarray] = {}
        obs1: Dict[int, np.ndarray] = {}
        for cid, lid in self.match_result.items():
            lm = st.lms.get(lid)
            if lm is None:
                continue
            for (obs_kfid, o) in lm.obs_vec:
                if obs_kfid == self.lc_kf_id:
                    obs0[lid] = o
                    obs1[lid] = self.curr_obs[cid]
                    break

        motion = self.pose_estimation(
            obs0, obs1, max_t_norm=self.cfg.lc_ransac_max_t_norm)
        if motion is None:
            return False

        kfid = st.last_kf_id()
        e = Edge.from_pose(motion)
        st.edges[(self.lc_kf_id, kfid)] = e
        st.edges[(kfid, self.lc_kf_id)] = e.inverse()
        st.edge_set.add((self.lc_kf_id, kfid))
        st.kfs[self.lc_kf_id].neighbor_kfs.add(kfid)
        st.kfs[kfid].neighbor_kfs.add(self.lc_kf_id)

        # merge: current landmark's history is appended onto the old
        # landmark, KF memberships rewritten, current lm deleted, current
        # obs re-keyed, and future frames remapped via match_lookup
        temp: Dict[int, int] = {}
        for cid, lid in self.match_result.items():
            if lid not in obs1 or cid not in st.lms:
                continue
            if lid not in self.final_inliers:
                continue
            if cid == lid:
                # self-match: the track SURVIVED since the recognized
                # keyframe (only the quarantine bounds how old a matched
                # doc's features can be), so current and "old" landmark
                # are the same object — appending its obs_vec onto
                # itself while iterating it never terminates (found as a
                # 130 GB OOM once the r3 vocabulary fix made detections
                # fire while old tracks were still alive)
                continue
            lm_old = st.lms[lid]
            lm_cur = st.lms[cid]
            for (obs_kfid, o) in list(lm_cur.obs_vec):
                lm_old.obs_vec.append((obs_kfid, o))
                kf = st.kfs[obs_kfid]
                if cid in kf.member_lms:
                    kf.member_lms.discard(cid)
                    kf.member_lms.add(lid)
            del st.lms[cid]
            temp[lid] = cid

        for lid in list(self.final_inliers):
            cid = temp.get(lid)
            if cid is None:
                continue
            if cid in self.curr_obs:
                self.curr_obs[lid] = self.curr_obs.pop(cid)
            st.match_lookup[cid] = lid

        return True

    def consistency_broken(self) -> bool:
        """slam.cpp:1215-1232: any edge whose current relative pose deviates
        from its constraint beyond the keyframe thresholds."""
        st = self.state
        for (n1, n2) in st.edge_set:
            T = st.kfs[n2].T.rel_to(st.kfs[n1].T)
            C = st.edges[(n1, n2)].C
            d = T.rel_to(C)
            if (rotation_angle(d.R) > self.cfg.pgo_consistency_rot_thr
                    or np.linalg.norm(d.t) > self.cfg.pgo_consistency_tr_thr):
                return True
        return False

    def pose_optimization(self):
        """slam.cpp:1236-1313: whole-graph pose optimization."""
        st = self.state
        self.stop_watch.tick("pose_graph")

        metric_embedding(st, st.last_kf_id())

        edge_list = sorted(st.edge_set)
        E = len(edge_list)
        V = len(st.kfs)
        if E == 0:
            self.stop_watch.tock("pose_graph")
            return

        ei = np.array([e[0] for e in edge_list], np.int32)
        ej = np.array([e[1] for e in edge_list], np.int32)
        ctr = np.stack([st.edges[e].C.wt() for e in edge_list])
        poses = np.stack([st.kfs[i].T.wt() for i in range(V)])

        pose_free = np.ones(V, bool)
        pose_free[ei[0]] = False  # gauge (po_problem.cpp:62-63)

        if self.mesh is not None:
            from ..parallel.dist_pgo import dist_pose_graph_opt
            n = self.mesh.devices.size
            Ep = ((E + n - 1) // n) * n
            ei_p = np.zeros(Ep, np.int32); ei_p[:E] = ei
            ej_p = np.zeros(Ep, np.int32); ej_p[:E] = ej
            ctr_p = np.zeros((Ep, 6)); ctr_p[:E] = ctr
            ev = np.zeros(Ep, bool); ev[:E] = True
            out, _ = dist_pose_graph_opt(
                self.mesh, jnp.asarray(poses, self.dtype),
                jnp.asarray(ei_p), jnp.asarray(ej_p),
                jnp.asarray(ctr_p, self.dtype), jnp.asarray(ev),
                jnp.asarray(pose_free), max_iters=self.cfg.pgo_num_iter)
        else:
            out, _ = pose_graph_opt(
                jnp.asarray(poses, self.dtype), jnp.asarray(ei),
                jnp.asarray(ej), jnp.asarray(ctr, self.dtype),
                jnp.ones(E, bool), jnp.asarray(pose_free),
                max_iters=self.cfg.pgo_num_iter)
        out = np.asarray(out, np.float64)

        for i in range(V):
            st.kfs[i].T = Pose.from_wt(out[i])
        for (n1, n2) in st.edge_set:
            st.edges[(n1, n2)].T = st.kfs[n2].T.rel_to(st.kfs[n1].T)
            st.edges[(n2, n1)].T = st.kfs[n1].T.rel_to(st.kfs[n2].T)

        self.stop_watch.tock("pose_graph")

    # ------------------------------------------------------------------
    # outputs
    # ------------------------------------------------------------------

    def trajectory(self) -> List[Pose]:
        """Camera-to-world poses rooted at keyframe 0 (slam.cpp:1473-1481)."""
        st = self.state
        if not st.kfs:
            return []
        metric_embedding(st, 0)
        return [st.kfs[i].T.inv() for i in sorted(st.kfs)]

    def save_trajectory(self, path: str):
        """Reference text format: i t_z -t_x -t_y w0 w1 w2
        (slam.cpp:1489-1494)."""
        from ..evalio.writers import write_trajectory
        write_trajectory(path, self.trajectory())

    def save_landmarks(self, path: str):
        """Reference text format (slam.cpp:1431-1471)."""
        from ..evalio.writers import write_landmarks
        write_landmarks(path, self._landmark_world_segments(min_len=0.0))

    def _landmark_world_segments(self, min_len=1.0, require_twice=True):
        """World endpoint segments of mapped lines (slam.cpp:1508-1532)."""
        st = self.state
        segs = []
        for lm in st.lms.values():
            if require_twice and not lm.twice_observed:
                continue
            if abs(lm.tt[0] - lm.tt[1]) < min_len:
                continue
            p = lm.line[:3]
            v = lm.line[3:]
            n = np.cross(p, v)
            p0 = np.cross(v, n) / (v @ v)
            vn = v / np.linalg.norm(v)
            Ti = st.kfs[lm.init_kfid].T.inv()
            p1 = Ti.R @ (p0 + vn * lm.tt[0]) + Ti.t
            p2 = Ti.R @ (p0 + vn * lm.tt[1]) + Ti.t
            segs.append(np.concatenate([p1, p2]))
        return segs

    def post_processing(self) -> Dict[str, float]:
        """Summary statistics (slam.cpp:1565-1632, main.cpp:84-89)."""
        sw = self.stop_watch
        n = max(self.num_frames_processed, 1)
        return {
            "proc_pose_estimation_mean_s": sw.stats("pose_estimation").mean,
            "proc_local_ba_mean_s": sw.stats("local_ba").mean,
            "proc_pose_graph_mean_s": sw.stats("pose_graph").mean,
            "proc_ba_pack_mean_s": sw.stats("ba_pack").mean,
            "proc_embedding_mean_s": sw.stats("embedding").mean,
            "proc_endpoints_mean_s": sw.stats("endpoints").mean,
            "total_time_s": sw.elapsed(),
            "num_keyframes": len(self.state.kfs),
            "num_landmarks": len(self.state.lms),
            "num_edges": len(self.state.edges) // 2,
            "num_loop_closures": self.lc_cnt,
            "avg_num_iterations": self.sum_num_iteration / n,
            "avg_initial_cost": self.sum_init_cost / n,
            "avg_final_cost": self.sum_final_cost / n,
        }


