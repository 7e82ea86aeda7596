"""Unit tests for the geometry core (vs reference gc.cpp semantics)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slslam import geometry as geo
from slslam import hostgeom as hg


def rand_rot(rng, n=()):
    w = rng.standard_normal(n + (3,))
    return w


class TestRotations:
    def test_rodrigues_orthonormal(self):
        rng = np.random.default_rng(0)
        w = jnp.asarray(rng.standard_normal((32, 3)))
        R = geo.rodrigues(w)
        eye = jnp.eye(3)
        err = jnp.abs(R @ jnp.swapaxes(R, -1, -2) - eye).max()
        assert err < 1e-12
        assert jnp.allclose(jnp.linalg.det(R), 1.0)

    def test_log_exp_roundtrip(self):
        rng = np.random.default_rng(1)
        w = rng.standard_normal((64, 3))
        # keep |w| < pi for uniqueness of the log
        w = w / np.maximum(np.linalg.norm(w, axis=-1, keepdims=True), 1.0) * 2.9
        w_rt = geo.so3_log(geo.rodrigues(jnp.asarray(w)))
        np.testing.assert_allclose(np.asarray(w_rt), w, atol=1e-9)

    def test_small_angle(self):
        w = jnp.asarray([1e-12, -2e-13, 3e-12])
        R = geo.rodrigues(w)
        np.testing.assert_allclose(np.asarray(geo.so3_log(R)), np.asarray(w),
                                   atol=1e-15)

    def test_near_pi(self):
        axis = np.array([1.0, 2.0, -0.5])
        axis /= np.linalg.norm(axis)
        w = axis * (np.pi - 1e-4)
        w_rt = np.asarray(geo.so3_log(geo.rodrigues(jnp.asarray(w))))
        np.testing.assert_allclose(w_rt, w, atol=1e-6)

    def test_host_matches_device(self):
        rng = np.random.default_rng(2)
        for _ in range(20):
            w = rng.standard_normal(3)
            np.testing.assert_allclose(
                hg.rodrigues(w), np.asarray(geo.rodrigues(jnp.asarray(w))),
                atol=1e-12)
            R = hg.rodrigues(w)
            np.testing.assert_allclose(
                hg.so3_log(R), np.asarray(geo.so3_log(jnp.asarray(R))),
                atol=1e-9)


class TestPoses:
    def test_compose_inverse(self):
        rng = np.random.default_rng(3)
        R1 = geo.rodrigues(jnp.asarray(rng.standard_normal(3)))
        t1 = jnp.asarray(rng.standard_normal(3))
        R2 = geo.rodrigues(jnp.asarray(rng.standard_normal(3)))
        t2 = jnp.asarray(rng.standard_normal(3))
        Rc, tc = geo.t_compose(R2, t2, R1, t1)
        Rr, tr = geo.t_rel(Rc, tc, R1, t1)
        np.testing.assert_allclose(np.asarray(Rr), np.asarray(R2), atol=1e-12)
        np.testing.assert_allclose(np.asarray(tr), np.asarray(t2), atol=1e-12)

    def test_wt_roundtrip(self):
        rng = np.random.default_rng(4)
        wt = jnp.asarray(rng.standard_normal(6))
        R, t = geo.wt_to_Rt(wt)
        wt2 = geo.Rt_to_wt(R, t)
        np.testing.assert_allclose(np.asarray(wt2), np.asarray(wt), atol=1e-9)

    def test_wt_compose_matches_matrix(self):
        rng = np.random.default_rng(5)
        a = jnp.asarray(rng.standard_normal(6) * 0.5)
        b = jnp.asarray(rng.standard_normal(6) * 0.5)
        wt_c = geo.wt_compose(a, b)
        Ra, ta = geo.wt_to_Rt(a)
        Rb, tb = geo.wt_to_Rt(b)
        Rc, tc = geo.t_compose(Ra, ta, Rb, tb)
        np.testing.assert_allclose(np.asarray(wt_c),
                                   np.asarray(geo.Rt_to_wt(Rc, tc)),
                                   atol=1e-9)

    def test_host_pose_ops(self):
        rng = np.random.default_rng(6)
        T1 = hg.Pose(hg.rodrigues(rng.standard_normal(3)),
                     rng.standard_normal(3))
        T2 = hg.Pose(hg.rodrigues(rng.standard_normal(3)),
                     rng.standard_normal(3))
        T20 = T2 @ T1
        T21 = T20.rel_to(T1)
        np.testing.assert_allclose(T21.R, T2.R, atol=1e-12)
        np.testing.assert_allclose(T21.t, T2.t, atol=1e-12)
        ident = T1 @ T1.inv()
        np.testing.assert_allclose(ident.R, np.eye(3), atol=1e-12)
        np.testing.assert_allclose(ident.t, 0, atol=1e-12)


class TestLines:
    def test_line_transform_roundtrip(self):
        rng = np.random.default_rng(7)
        line = jnp.asarray(rng.standard_normal(6))
        R = geo.rodrigues(jnp.asarray(rng.standard_normal(3)))
        t = jnp.asarray(rng.standard_normal(3))
        line_c = geo.line_to_pose(line, R, t)
        line_w = geo.line_from_pose(line_c, R, t)
        np.testing.assert_allclose(np.asarray(line_w), np.asarray(line),
                                   atol=1e-12)

    def test_plk_transform_consistent_with_points(self):
        # Transform a line defined by 2 points: plk transform of the line
        # must equal the line through the transformed points.
        rng = np.random.default_rng(8)
        p = jnp.asarray(rng.standard_normal(3))
        q = jnp.asarray(rng.standard_normal(3))
        v = q - p
        n = jnp.cross(p, q)  # moment
        plk = jnp.concatenate([n, v])
        R = geo.rodrigues(jnp.asarray(rng.standard_normal(3)))
        t = jnp.asarray(rng.standard_normal(3))
        plk_c = geo.plk_to_pose(plk, R, t)
        pc = geo.point_to_pose(R, t, p)
        qc = geo.point_to_pose(R, t, q)
        n_c = jnp.cross(pc, qc)
        v_c = qc - pc
        np.testing.assert_allclose(np.asarray(plk_c[:3]), np.asarray(n_c),
                                   atol=1e-9)
        np.testing.assert_allclose(np.asarray(plk_c[3:]), np.asarray(v_c),
                                   atol=1e-9)

    def test_plucker_origin(self):
        p = jnp.asarray([1.0, 2.0, 3.0])
        v = jnp.asarray([0.0, 1.0, 0.0])
        n = jnp.cross(p, p + v)
        cp = geo.plucker_origin(n, v)
        # closest point to origin on the line {p + s v}: must be perpendicular
        np.testing.assert_allclose(float(jnp.dot(cp, v)), 0.0, atol=1e-12)
        # and lie on the line
        s = float(jnp.dot(cp - p, v))
        np.testing.assert_allclose(np.asarray(p + s * v), np.asarray(cp),
                                   atol=1e-12)

    def test_ppp_pi_contains_points(self):
        rng = np.random.default_rng(9)
        x1, x2, x3 = (jnp.asarray(rng.standard_normal(3)) for _ in range(3))
        pi = geo.ppp_pi(x1, x2, x3)
        for x in (x1, x2, x3):
            val = float(pi[:3] @ x + pi[3])
            assert abs(val) < 1e-9

    def test_pipi_plk_on_both_planes(self):
        rng = np.random.default_rng(10)
        x1, x2, x3, x4 = (jnp.asarray(rng.standard_normal(3))
                          for _ in range(4))
        # two planes sharing the line through x1, x2
        pi1 = geo.ppp_pi(x1, x2, x3)
        pi2 = geo.ppp_pi(x1, x2, x4)
        plk = geo.pipi_plk(pi1, pi2)
        n, v = plk[:3], plk[3:]
        # direction parallel to x2 - x1
        cr = jnp.cross(v, x2 - x1)
        np.testing.assert_allclose(np.asarray(cr), 0, atol=1e-8)
        # moment consistent: n = p x (p+v) for any p on the line
        cp = geo.plucker_origin(n, v)
        s = float(jnp.dot(cp - x1, x2 - x1) / jnp.dot(x2 - x1, x2 - x1))
        np.testing.assert_allclose(np.asarray(x1 + s * (x2 - x1)),
                                   np.asarray(cp), atol=1e-8)


class TestParameterizations:
    def _rand_av(self, rng):
        # random line in (cp, dv) form with cp ⟂ dv (the canonical form
        # produced by triangulation)
        v = rng.standard_normal(3)
        p = rng.standard_normal(3) * 2.0
        cp = np.cross(v, np.cross(p, v)) / (v @ v)
        return jnp.asarray(np.concatenate([cp, v]))

    def test_orth_roundtrip(self):
        rng = np.random.default_rng(11)
        for _ in range(50):
            av = self._rand_av(rng)
            orth = geo.av_to_orth(av)
            av2 = geo.orth_to_av(orth)
            # direction normalizes; compare cp and unit direction
            np.testing.assert_allclose(np.asarray(av2[:3]), np.asarray(av[:3]),
                                       atol=1e-8)
            vn = np.asarray(av[3:]) / np.linalg.norm(np.asarray(av[3:]))
            np.testing.assert_allclose(np.asarray(av2[3:]), vn, atol=1e-8)

    def test_aid_roundtrip(self):
        rng = np.random.default_rng(12)
        for _ in range(20):
            av = self._rand_av(rng)
            av2 = geo.aid_to_av(geo.av_to_aid(av))
            np.testing.assert_allclose(np.asarray(av2[:3]), np.asarray(av[:3]),
                                       atol=1e-8)
            vn = np.asarray(av[3:]) / np.linalg.norm(np.asarray(av[3:]))
            np.testing.assert_allclose(np.asarray(av2[3:]), vn, atol=1e-8)

    def test_asd_reference_semantics(self):
        # The reference's asd is experimental and does NOT round-trip: it
        # stores exp(|v|/|n|) = exp(1/|cp|) (gc.cpp:291) and asd_to_av
        # returns cp scaled by log(asd3) = 1/|cp| instead of |cp|
        # (gc.cpp:341,352).  We reproduce that behavior exactly.
        rng = np.random.default_rng(13)
        for _ in range(20):
            av = self._rand_av(rng)
            av2 = geo.asd_to_av(geo.av_to_asd(av))
            cp = np.asarray(av[:3])
            vn = np.asarray(av[3:]) / np.linalg.norm(np.asarray(av[3:]))
            np.testing.assert_allclose(np.asarray(av2[3:]), vn, atol=1e-8)
            expected_cp = cp / (np.linalg.norm(cp) ** 2)
            np.testing.assert_allclose(np.asarray(av2[:3]), expected_cp,
                                       atol=1e-7)

    def test_orth_batched(self):
        rng = np.random.default_rng(14)
        avs = jnp.stack([self._rand_av(rng) for _ in range(16)])
        orths = geo.av_to_orth(avs)
        assert orths.shape == (16, 4)
        av2 = geo.orth_to_av(orths)
        np.testing.assert_allclose(np.asarray(av2[:, :3]),
                                   np.asarray(avs[:, :3]), atol=1e-8)


class TestEndpointTransport:
    def test_tt_roundtrip(self):
        rng = np.random.default_rng(15)
        tt = jnp.asarray([0.5, 2.0])
        v = jnp.asarray(rng.standard_normal(3))
        R = geo.rodrigues(jnp.asarray(rng.standard_normal(3)))
        t = jnp.asarray(rng.standard_normal(3))
        tt1 = geo.tt_to_pose(tt, v, R, t)
        tt0 = geo.tt_from_pose(tt1, v, R, t)
        np.testing.assert_allclose(np.asarray(tt0), np.asarray(tt), atol=1e-12)

    def test_tt_uninitialized_passthrough(self):
        # (0, 0) means uninitialized and passes through (gc.cpp:128-129)
        v = jnp.asarray([1.0, 0.0, 0.0])
        R = jnp.eye(3)
        t = jnp.asarray([5.0, 0.0, 0.0])
        tt1 = geo.tt_to_pose(jnp.zeros(2), v, R, t)
        np.testing.assert_allclose(np.asarray(tt1), 0.0)


class TestTriangulateHost:
    def test_bucketed_wrapper_matches_direct_call(self):
        # triangulate_lines_host pads the row count to a capacity bucket
        # before the jitted kernel (novel shapes cost a fresh XLA compile);
        # the real rows' values must be identical to the direct call and
        # the padded rows must never leak
        from slslam.ops.triangulate import (triangulate_lines,
                                            triangulate_lines_host)
        rng = np.random.default_rng(3)
        for n in (1, 63, 64, 65):
            obs = rng.standard_normal((n, 8)) * 0.2
            direct = np.asarray(triangulate_lines(
                jnp.asarray(obs), 0.12, inverse_depth=0.1), np.float64)
            host = triangulate_lines_host(obs, 0.12, inverse_depth=0.1)
            assert host.shape == (n, 6)
            np.testing.assert_allclose(host, direct, rtol=0, atol=0)

    def test_overflow_rounds_up_past_last_bucket(self):
        from slslam.ops.triangulate import triangulate_lines_host
        rng = np.random.default_rng(4)
        obs = rng.standard_normal((70, 8)) * 0.2
        out = triangulate_lines_host(obs, 0.12, inverse_depth=0.1,
                                     buckets=(8, 32))
        assert out.shape == (70, 6)       # 70 > 32 -> padded to 96 inside
        assert np.isfinite(out).all()
