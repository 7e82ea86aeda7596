"""Matrix-free PCG Schur solver (ops/schur_cg.py) vs the dense solver."""

import jax.numpy as jnp
import numpy as np
import pytest

from slslam import geometry as geo
from slslam.config import CameraConfig
from slslam.ops.schur_ba import local_ba
from slslam.ops.schur_cg import (global_ba_cg, pack_line_major)

from test_ba import make_problem

CAM = CameraConfig()
BL = CAM.baseline
HD = 1.0 / CAM.focal_length


def _perturbed(num_cams=6, noise_px=0.3, seed=1, cam_sigma=0.01,
               line_sigma=0.003):
    cam_wt, gt_lines, obs, obs_cam, obs_line, _ = make_problem(
        num_cams=num_cams, noise_px=noise_px, seed=seed)
    rng = np.random.default_rng(42)
    C, L = num_cams, len(gt_lines)
    cam0 = cam_wt.copy()
    cam0[1:] += rng.standard_normal((C - 1, 6)) * cam_sigma
    orth_gt = np.asarray(geo.av_to_orth(jnp.asarray(gt_lines)))
    orth0 = orth_gt + rng.standard_normal((L, 4)) * line_sigma
    cam_free = np.ones(C, bool)
    cam_free[0] = False
    return cam0, orth0, obs, obs_cam, obs_line, cam_free, cam_wt


class TestPackLineMajor:
    def test_roundtrip(self):
        _, _, obs, obs_cam, obs_line, _, _ = _perturbed()
        C, L = int(obs_cam.max()) + 1, int(obs_line.max()) + 1
        p = pack_line_major(obs, obs_cam, obs_line, C, L)
        assert p.obs_valid.sum() == len(obs)
        assert p.cam_perm_valid.sum() == len(obs)
        # every original observation appears in its line's bucket
        for o in range(0, len(obs), 7):
            l = obs_line[o]
            hits = np.where(p.obs_valid[l]
                            & (p.obs_cam[l] == obs_cam[o]))[0]
            assert any(np.allclose(p.obs[l, k], obs[o]) for k in hits)
        # cam_perm points back at the right flat rows
        flat_obs = p.obs.reshape(-1, 8)
        for c in range(C):
            for k in np.where(p.cam_perm_valid[c])[0]:
                row = flat_obs[p.cam_perm[c, k]]
                li = p.cam_perm[c, k] // p.kL
                assert p.obs_cam[li, p.cam_perm[c, k] % p.kL] == c

    def test_bucket_rounding(self):
        _, _, obs, obs_cam, obs_line, _, _ = _perturbed()
        C, L = int(obs_cam.max()) + 1, int(obs_line.max()) + 1
        p = pack_line_major(obs, obs_cam, obs_line, C, L)
        assert p.kL % 8 == 0 and p.kC % 8 == 0


class TestGlobalBACG:
    def _solve_both(self, **kw):
        cam0, orth0, obs, obs_cam, obs_line, cam_free, cam_gt = _perturbed(
            **kw)
        C, L, O = len(cam0), len(orth0), len(obs)

        cd, ld, sd = local_ba(
            jnp.asarray(cam0), jnp.asarray(orth0), jnp.asarray(obs),
            jnp.asarray(obs_cam), jnp.asarray(obs_line), jnp.ones(O, bool),
            jnp.asarray(cam_free), jnp.ones(L, bool), BL, HD,
            robust=True, max_iters=25)

        p = pack_line_major(obs, obs_cam, obs_line, C, L)
        cc, lc, sc = global_ba_cg(
            jnp.asarray(cam0), jnp.asarray(orth0), jnp.asarray(p.obs),
            jnp.asarray(p.obs_cam), jnp.asarray(p.obs_valid),
            jnp.asarray(p.cam_perm), jnp.asarray(p.cam_perm_valid),
            jnp.asarray(cam_free), jnp.ones(L, bool),
            jnp.asarray(BL), jnp.asarray(HD),
            robust=True, max_iters=25)
        return (np.asarray(cd), sd), (np.asarray(cc), sc), cam_gt

    def test_matches_dense_final_cost(self):
        (cd, sd), (cc, sc), _ = self._solve_both()
        # same initial cost (identical problem), same basin
        np.testing.assert_allclose(float(sc.initial_cost),
                                   float(sd.initial_cost), rtol=1e-9)
        np.testing.assert_allclose(float(sc.final_cost),
                                   float(sd.final_cost), rtol=1e-3)

    def test_recovers_poses(self):
        (cd, sd), (cc, sc), cam_gt = self._solve_both(
            noise_px=0.0, cam_sigma=0.02)
        np.testing.assert_allclose(cc, cam_gt, atol=1e-5)
        assert float(sc.final_cost) < 1e-13

    def test_fixed_cameras_stay_fixed(self):
        cam0, orth0, obs, obs_cam, obs_line, cam_free, _ = _perturbed()
        cam_free[:2] = False
        C, L = len(cam0), len(orth0)
        p = pack_line_major(obs, obs_cam, obs_line, C, L)
        cc, lc, sc = global_ba_cg(
            jnp.asarray(cam0), jnp.asarray(orth0), jnp.asarray(p.obs),
            jnp.asarray(p.obs_cam), jnp.asarray(p.obs_valid),
            jnp.asarray(p.cam_perm), jnp.asarray(p.cam_perm_valid),
            jnp.asarray(cam_free), jnp.ones(L, bool),
            jnp.asarray(BL), jnp.asarray(HD), robust=True, max_iters=10)
        np.testing.assert_array_equal(np.asarray(cc)[:2], cam0[:2])

    def test_padded_lines_inert(self):
        """Extra padded line rows must not change the solution."""
        cam0, orth0, obs, obs_cam, obs_line, cam_free, _ = _perturbed()
        C, L = len(cam0), len(orth0)
        p = pack_line_major(obs, obs_cam, obs_line, C, L)

        def solve(orth, ob, oc, ov, cp, cpv, lf):
            return global_ba_cg(
                jnp.asarray(cam0), jnp.asarray(orth), jnp.asarray(ob),
                jnp.asarray(oc), jnp.asarray(ov), jnp.asarray(cp),
                jnp.asarray(cpv), jnp.asarray(cam_free), jnp.asarray(lf),
                jnp.asarray(BL), jnp.asarray(HD), robust=True, max_iters=8)

        ca, la, sa = solve(orth0, p.obs, p.obs_cam, p.obs_valid,
                           p.cam_perm, p.cam_perm_valid, np.ones(L, bool))

        Lp = L + 16
        orth_p = np.zeros((Lp, 4))
        orth_p[:, 3] = 0.5
        orth_p[:L] = orth0
        ob = np.zeros((Lp, p.kL, 8)); ob[:L] = p.obs
        oc = np.zeros((Lp, p.kL), np.int32); oc[:L] = p.obs_cam
        ov = np.zeros((Lp, p.kL), bool); ov[:L] = p.obs_valid
        lf = np.zeros(Lp, bool); lf[:L] = True
        cb, lb, sb = solve(orth_p, ob, oc, ov, p.cam_perm,
                           p.cam_perm_valid, lf)

        np.testing.assert_allclose(np.asarray(cb), np.asarray(ca),
                                   rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(np.asarray(lb)[:L], np.asarray(la),
                                   rtol=1e-7, atol=1e-9)

    def test_larger_than_dense_limit(self):
        """A problem whose dense W would be prohibitive solves fine and
        reduces cost (memory check is structural: no (C,L,6,4) tensor)."""
        # synthetic multi-camera chain: 64 cams, 512 lines
        rng = np.random.default_rng(0)
        C, L = 64, 512
        # world->cam: p_c = p_w - pos, so wt translation is -pos
        cam_wt = np.zeros((C, 6))
        cam_wt[:, 3] = -0.02 * np.arange(C)
        p1 = rng.uniform(-4, 4, (L, 3)) + np.array([0, 0, 8.0])
        d = rng.standard_normal((L, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        p2 = p1 + d

        obs, ocam, olin = [], [], []
        for c in range(C):
            t = np.array([0.02 * c, 0.0, 0.0])
            for l in range(L):
                if (l + c) % 4:      # ~75% visibility
                    continue
                a, b = p1[l] - t, p2[l] - t
                if a[2] < 1 or b[2] < 1:
                    continue
                ou = np.array([a[0] / a[2], a[1] / a[2],
                               b[0] / b[2], b[1] / b[2]])
                ar, br = a - [BL, 0, 0], b - [BL, 0, 0]
                ov_ = np.array([ar[0] / ar[2], ar[1] / ar[2],
                                br[0] / br[2], br[1] / br[2]])
                obs.append(np.concatenate([ou, ov_]))
                ocam.append(c)
                olin.append(l)
        obs = np.stack(obs)
        lines_av = np.concatenate(
            [np.cross(d, np.cross(p1 - 0, d)) / 1.0, d], axis=1)
        # closest point form
        cp = np.cross(d, np.cross(p1, d)) / np.sum(d * d, 1, keepdims=True)
        lines_av = np.concatenate([cp, d], axis=1)
        orth0 = np.asarray(geo.av_to_orth(jnp.asarray(lines_av)))
        orth0 = orth0 + rng.standard_normal(orth0.shape) * 0.002
        cam0 = cam_wt + rng.standard_normal(cam_wt.shape) * 0.005
        cam0[0] = cam_wt[0]
        cam_free = np.ones(C, bool); cam_free[0] = False

        pk = pack_line_major(obs, ocam, olin, C, L)
        cc, lc, sc = global_ba_cg(
            jnp.asarray(cam0), jnp.asarray(orth0), jnp.asarray(pk.obs),
            jnp.asarray(pk.obs_cam), jnp.asarray(pk.obs_valid),
            jnp.asarray(pk.cam_perm), jnp.asarray(pk.cam_perm_valid),
            jnp.asarray(cam_free), jnp.ones(L, bool),
            jnp.asarray(BL), jnp.asarray(HD), robust=True, max_iters=15)
        assert float(sc.final_cost) < 0.05 * float(sc.initial_cost)
        assert np.abs(np.asarray(cc) - cam_wt).max() < 0.01
