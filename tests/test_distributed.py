"""Distributed BA / PGO tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slslam import geometry as geo
from slslam.config import CameraConfig
from slslam.ops.pose_graph import pose_graph_opt
from slslam.ops.schur_ba import local_ba
from slslam.parallel import (dist_local_ba_lines, dist_pose_graph_opt,
                             make_mesh, partition_by_line)

from test_ba import make_problem

CAM = CameraConfig()
BL = CAM.baseline


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return make_mesh(jax.devices())


def padded_ba_problem(num_cams=4, noise_px=0.3, pad_obs=1024,
                      pad_lines=None):
    cam_wt, gt_lines, obs, obs_cam, obs_line, _ = make_problem(
        num_cams=num_cams, noise_px=noise_px, seed=1)
    rng = np.random.default_rng(42)
    L, O, C = len(gt_lines), len(obs), num_cams
    orth_gt = np.asarray(geo.av_to_orth(jnp.asarray(gt_lines)))
    cam0 = cam_wt.copy()
    cam0[1:] += rng.standard_normal((C - 1, 6)) * 0.02
    orth0 = orth_gt + rng.standard_normal((L, 4)) * 0.005
    cam_free = np.ones(C, bool)
    cam_free[0] = False

    obs_p = np.zeros((pad_obs, 8)); obs_p[:O] = obs
    oc = np.zeros(pad_obs, np.int32); oc[:O] = obs_cam
    ol = np.zeros(pad_obs, np.int32); ol[:O] = obs_line
    valid = np.zeros(pad_obs, bool); valid[:O] = True

    Lp = pad_lines or L
    orth_p = np.zeros((Lp, 4)); orth_p[:, 3] = 0.5; orth_p[:L] = orth0
    lf = np.zeros(Lp, bool); lf[:L] = True

    return (jnp.asarray(cam0), jnp.asarray(orth_p), jnp.asarray(obs_p),
            jnp.asarray(oc), jnp.asarray(ol), jnp.asarray(valid),
            jnp.asarray(cam_free), jnp.asarray(lf))


def _line_sharded_args(args, n_shards):
    (cam0, orth0, obs_p, oc, ol, valid, cam_free, line_free) = args
    lo, lf, ob, oc_sh, ol_sh, ov, perm = partition_by_line(
        np.asarray(orth0), np.asarray(line_free), np.asarray(obs_p),
        np.asarray(oc), np.asarray(ol), np.asarray(valid), n_shards)
    return (cam0, jnp.asarray(lo), jnp.asarray(ob), jnp.asarray(oc_sh),
            jnp.asarray(ol_sh), jnp.asarray(ov), cam_free,
            jnp.asarray(lf)), perm


class TestDistBA:
    def test_solution_quality(self, mesh):
        args = padded_ba_problem()
        sh, _ = _line_sharded_args(args, 8)
        cam_d, _, stats = dist_local_ba_lines(mesh, *sh, BL,
                                              1.0 / CAM.focal_length)
        assert float(stats.final_cost) < float(stats.initial_cost)
        assert not np.any(np.isnan(np.asarray(cam_d)))

    def test_collective_bytes_independent_of_map_size(self, mesh):
        """The line-sharded layout's contract (SURVEY §5, VERDICT r1 #4):
        per-LM-iteration collective volume must not grow with the number
        of lines/observations.  Compiled-HLO check: total all-reduce bytes
        for a 4x-larger map are identical."""
        import re

        def allreduce_bytes(args):
            sh, _ = _line_sharded_args(args, 8)
            lowered = dist_local_ba_lines.lower(
                mesh, *sh, jnp.asarray(BL, sh[0].dtype),
                jnp.asarray(1.0 / CAM.focal_length, sh[0].dtype),
                robust=True, max_iters=10)
            txt = lowered.compile().as_text()
            sizes = {"f64": 8, "f32": 4, "u32": 4, "s32": 4, "pred": 1,
                     "u8": 1, "f16": 2, "bf16": 2}
            total = 0
            for line in txt.splitlines():
                if "all-reduce(" not in line and "all-reduce-start(" \
                        not in line:
                    continue
                # result shapes appear before ' = ... all-reduce('
                head = line.split("=", 1)[0] + "=" + \
                    line.split("=", 1)[1].split("all-reduce")[0]
                for m in re.finditer(r"(\w+)\[([\d,]*)\]", head):
                    dt, dims = m.group(1), m.group(2)
                    if dt not in sizes:
                        continue
                    n = 1
                    for d in dims.split(","):
                        if d:
                            n *= int(d)
                    total += n * sizes[dt]
            return total

        small = padded_ba_problem(num_cams=4, pad_obs=1024)
        big = padded_ba_problem(num_cams=4, pad_obs=4096, pad_lines=256)
        b_small = allreduce_bytes(small)
        b_big = allreduce_bytes(big)
        assert b_small > 0
        assert b_big == b_small, (b_small, b_big)


def pgo_ring_problem(V=32, E_pad=64, drift=0.05, seed=0):
    """A noisy loop: V poses around a circle, sequential + loop-closure
    edges, initial poses drifted."""
    rng = np.random.default_rng(seed)
    # ground truth poses: yaw around circle
    gt = []
    for i in range(V):
        ang = 2 * np.pi * i / V
        wt = np.array([0.0, ang, 0.0, np.sin(ang) * 3, 0.0, np.cos(ang) * 3])
        gt.append(wt)
    gt = np.stack(gt)

    def rel(a, b):
        Ra, ta = np.asarray(geo.wt_to_Rt(jnp.asarray(a))[0]), a[3:]
        Rb, tb = np.asarray(geo.wt_to_Rt(jnp.asarray(b))[0]), b[3:]
        # T_b * T_a^-1
        R = Rb @ Ra.T
        t = tb - R @ ta
        return np.concatenate([
            np.asarray(geo.so3_log(jnp.asarray(R))), t])

    ei, ej, ctr = [], [], []
    for i in range(V - 1):
        ei.append(i); ej.append(i + 1); ctr.append(rel(gt[i], gt[i + 1]))
    # loop edge
    ei.append(V - 1); ej.append(0); ctr.append(rel(gt[V - 1], gt[0]))
    E = len(ei)

    poses0 = gt + rng.standard_normal(gt.shape) * drift
    poses0[0] = gt[0]

    ei_p = np.zeros(E_pad, np.int32); ei_p[:E] = ei
    ej_p = np.zeros(E_pad, np.int32); ej_p[:E] = ej
    ctr_p = np.zeros((E_pad, 6)); ctr_p[:E] = np.stack(ctr)
    ev = np.zeros(E_pad, bool); ev[:E] = True
    free = np.ones(V, bool); free[0] = False

    return (jnp.asarray(poses0), jnp.asarray(ei_p), jnp.asarray(ej_p),
            jnp.asarray(ctr_p), jnp.asarray(ev), jnp.asarray(free)), gt


class TestPGO:
    def test_converges_to_ground_truth(self):
        args, gt = pgo_ring_problem()
        out, stats = pose_graph_opt(*args, max_iters=30)
        out = np.asarray(out)
        # residual cost ~ 0 and poses back at ground truth (gauge-fixed)
        assert float(stats.final_cost) < 1e-12
        np.testing.assert_allclose(out, gt, atol=1e-4)

    def test_ten_iteration_cap(self):
        args, gt = pgo_ring_problem(drift=0.02)
        out, stats = pose_graph_opt(*args, max_iters=10)
        assert int(stats.iterations) <= 10
        assert float(stats.final_cost) < float(stats.initial_cost) * 1e-3

    def test_dist_matches_single(self, mesh):
        args, gt = pgo_ring_problem()
        out_s, stats_s = pose_graph_opt(*args, max_iters=10)
        out_d, stats_d = dist_pose_graph_opt(mesh, *args, max_iters=10)
        np.testing.assert_allclose(np.asarray(out_d), np.asarray(out_s),
                                   rtol=1e-8, atol=1e-10)


class TestDistBALines:
    def test_line_sharded_matches_single(self, mesh):
        from slslam.parallel.dist_ba import (dist_local_ba_lines,
                                             partition_by_line)
        args = padded_ba_problem()
        (cam0, orth0, obs_p, oc, ol, valid, cam_free, line_free) = args
        cam_s, line_s, stats_s = local_ba(*args, BL, 1.0 / CAM.focal_length)

        lo, lf, ob, oc_sh, ol_sh, ov, perm = partition_by_line(
            np.asarray(orth0), np.asarray(line_free), np.asarray(obs_p),
            np.asarray(oc), np.asarray(ol), np.asarray(valid), 8)
        cam_d, line_d, stats_d = dist_local_ba_lines(
            mesh, cam0, jnp.asarray(lo), jnp.asarray(ob),
            jnp.asarray(oc_sh), jnp.asarray(ol_sh), jnp.asarray(ov),
            args[6], jnp.asarray(lf), BL, 1.0 / CAM.focal_length)
        # un-permute lines back to global order
        line_flat = np.asarray(line_d).reshape(-1, 4)
        line_back = line_flat[perm]

        np.testing.assert_allclose(np.asarray(cam_d), np.asarray(cam_s),
                                   rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(line_back, np.asarray(line_s),
                                   rtol=1e-7, atol=1e-9)
        assert int(stats_d.iterations) == int(stats_s.iterations)


class TestEngineDistributed:
    def test_engine_with_mesh_matches_single(self):
        import dataclasses
        from slslam.config import SlamConfig
        from slslam.engine import Slam
        from slslam.evalio.writers import trajectory_rows
        from slslam.sim import (StereoLineRenderer, house_segments,
                                wave_trajectory)

        # 14 frames: enough for the window to cycle and the sharded
        # BA/PGO paths to execute; the dominant cost is the shard_map
        # compiles, so more frames only pad the slowest suite test
        segs = house_segments()
        poses = wave_trajectory(num_frames=14)
        ren = StereoLineRenderer(segs, CameraConfig(), noise_px=0.3, seed=1)
        frames = [ren.observe(T) for T in poses]

        def run(mesh_devices):
            cfg = dataclasses.replace(SlamConfig(),
                                      compute_dtype="float64",
                                      mesh_devices=mesh_devices)
            slam = Slam(cfg)
            for i, obs in enumerate(frames):
                slam.process_frame(obs, i)
            return trajectory_rows(slam.trajectory())

        t1 = run(0)
        t8 = run(8)
        np.testing.assert_allclose(t8, t1, atol=1e-8)
