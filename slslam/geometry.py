"""Geometry core: SE(3), Plücker lines, line parameterizations (JAX).

Reimplements the semantics of the reference geometry layer (gc.h/gc.cpp,
/root/reference/src/gc.cpp) as pure, batch-friendly `jax.numpy` functions.
Every function accepts leading batch dimensions and is differentiable and
jit/vmap-safe.  Poses are represented either as an (R, t) pair with shapes
(..., 3, 3) / (..., 3) or as a 6-vector ``wt`` = (angle-axis w, translation t).

Conventions (matching the reference):
  * A pose T = (R, t) maps world coordinates to camera coordinates:
    p_c = R p_w + t.
  * A "cp/dv line" is a 6-vector (closest point to origin, direction)
    (gc.cpp:63-81).
  * A Plücker line is (n, v) with n the moment and v the direction
    (gc.cpp:83-117).
  * The orthonormal 4-DoF parameterization is (alpha, beta, gamma, theta)
    with d = cos(theta)/sin(theta) (gc.cpp:361-460).

A mirror of the scalar hot-path functions in plain NumPy lives in
``slslam.hostgeom`` for the imperative engine shell.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-12


# ---------------------------------------------------------------------------
# SO(3) / SE(3)
# ---------------------------------------------------------------------------

def skew(v):
    """Skew-symmetric matrix [v]x (gc.cpp:119-123). v: (..., 3)."""
    z = jnp.zeros_like(v[..., 0])
    return jnp.stack([
        jnp.stack([z, -v[..., 2], v[..., 1]], axis=-1),
        jnp.stack([v[..., 2], z, -v[..., 0]], axis=-1),
        jnp.stack([-v[..., 1], v[..., 0], z], axis=-1),
    ], axis=-2)


def rodrigues(w):
    """Angle-axis (..., 3) -> rotation matrix (..., 3, 3) (gc.cpp:24-34).

    Uses the Rodrigues formula with a Taylor fallback for small angles so the
    function stays differentiable at w = 0.
    """
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS))
    small = theta2 < 1e-16

    # sin(theta)/theta and (1-cos(theta))/theta^2 with Taylor fallbacks.
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)

    W = skew(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R):
    """Rotation matrix (..., 3, 3) -> angle-axis (..., 3) (gc.cpp:36-49).

    Robust log map: angle from atan2(|vee(R - R^T)|/2, (tr-1)/2); near pi the
    axis is recovered from the diagonal of (R + I)/2.
    """
    vee = 0.5 * jnp.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], axis=-1)
    s = jnp.linalg.norm(vee, axis=-1)            # sin(theta)
    c = 0.5 * (jnp.trace(R, axis1=-2, axis2=-1) - 1.0)  # cos(theta)
    theta = jnp.arctan2(s, c)

    # Generic branch: w = theta * vee / sin(theta), Taylor for small theta.
    small = s < 1e-8
    scale = jnp.where(small, 1.0 + (1.0 - c) / 6.0,
                      theta / jnp.where(small, 1.0, s))
    w_generic = scale[..., None] * vee

    # Near pi: sin(theta) ~ 0, cos(theta) ~ -1. Axis from diagonal.
    near_pi = c < -0.99
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis2 = jnp.maximum((diag - c[..., None]) / (1.0 - c[..., None] + _EPS), 0.0)
    axis = jnp.sqrt(axis2)
    # Fix signs using the off-diagonal symmetric part.
    sgn = jnp.sign(jnp.where(jnp.abs(vee) > 1e-12, vee, 1.0))
    axis = axis * sgn
    axis = axis / (jnp.linalg.norm(axis, axis=-1, keepdims=True) + _EPS)
    w_pi = theta[..., None] * axis

    return jnp.where(near_pi[..., None], w_pi, w_generic)


def t_inv(R, t):
    """Inverse pose (gc.cpp:51-53)."""
    Ri = jnp.swapaxes(R, -1, -2)
    return Ri, -jnp.einsum("...ij,...j->...i", Ri, t)


def t_compose(R21, t21, R10, t10):
    """T20 = T21 * T10 (gc.cpp:164-166)."""
    return R21 @ R10, jnp.einsum("...ij,...j->...i", R21, t10) + t21


def t_rel(R20, t20, R10, t10):
    """T21 = T20 * T10^-1 (gc.cpp:169-171)."""
    Ri, ti = t_inv(R10, t10)
    return t_compose(R20, t20, Ri, ti)


def wt_to_Rt(wt):
    """6-vector (w, t) -> (R, t) (gc.cpp:173-176)."""
    return rodrigues(wt[..., :3]), wt[..., 3:]


def Rt_to_wt(R, t):
    """(R, t) -> 6-vector (gc.cpp:178-184)."""
    return jnp.concatenate([so3_log(R), t], axis=-1)


def wt_inv(wt):
    """Inverse pose in 6-vector form (po_problem.h:27-39 semantics)."""
    R, t = wt_to_Rt(wt)
    Ri, ti = t_inv(R, t)
    return jnp.concatenate([-wt[..., :3], ti], axis=-1)


def wt_compose(wt21, wt10):
    """Compose poses in 6-vector form: T20 = T21 * T10 (po_problem.h:54-64)."""
    R21, t21 = wt_to_Rt(wt21)
    R10, t10 = wt_to_Rt(wt10)
    R20, t20 = t_compose(R21, t21, R10, t10)
    return Rt_to_wt(R20, t20)


def point_to_pose(R, t, p_w):
    """World point -> camera frame (gc.cpp:55-57)."""
    return jnp.einsum("...ij,...j->...i", R, p_w) + t


def point_from_pose(R, t, p_c):
    """Camera point -> world frame (gc.cpp:59-61)."""
    Ri, ti = t_inv(R, t)
    return point_to_pose(Ri, ti, p_c)


# ---------------------------------------------------------------------------
# Lines: (cp, dv) form and Plücker (n, v) form
# ---------------------------------------------------------------------------

def line_to_pose(line_w, R, t):
    """(cp, dv) line world -> camera (gc.cpp:63-77)."""
    cp = point_to_pose(R, t, line_w[..., :3])
    dv = jnp.einsum("...ij,...j->...i", R, line_w[..., 3:])
    return jnp.concatenate([cp, dv], axis=-1)


def line_from_pose(line_c, R, t):
    """(cp, dv) line camera -> world (gc.cpp:79-81)."""
    Ri, ti = t_inv(R, t)
    return line_to_pose(line_c, Ri, ti)


def plk_to_pose(plk_w, R, t):
    """Plücker (n, v) world -> camera (gc.cpp:83-94)."""
    nw, vw = plk_w[..., :3], plk_w[..., 3:]
    Rv = jnp.einsum("...ij,...j->...i", R, vw)
    nc = jnp.einsum("...ij,...j->...i", R, nw) + jnp.cross(t, Rv)
    return jnp.concatenate([nc, Rv], axis=-1)


def plk_from_pose(plk_c, R, t):
    """Plücker (n, v) camera -> world (gc.cpp:96-98)."""
    Ri, ti = t_inv(R, t)
    return plk_to_pose(plk_c, Ri, ti)


def ppp_pi(x1, x2, x3):
    """Plane through three points (gc.cpp:100-105). Returns (..., 4)."""
    normal = jnp.cross(x1 - x3, x2 - x3)
    d = -jnp.sum(x3 * jnp.cross(x1, x2), axis=-1, keepdims=True)
    return jnp.concatenate([normal, d], axis=-1)


def pipi_plk(pi1, pi2):
    """Plücker line from two planes (gc.cpp:107-113). Returns (n, v)."""
    # dp = pi1 pi2^T - pi2 pi1^T ; plk = (dp03, dp13, dp23, -dp12, dp02, -dp01)
    dp = (pi1[..., :, None] * pi2[..., None, :]
          - pi2[..., :, None] * pi1[..., None, :])
    return jnp.stack([
        dp[..., 0, 3], dp[..., 1, 3], dp[..., 2, 3],
        -dp[..., 1, 2], dp[..., 0, 2], -dp[..., 0, 1],
    ], axis=-1)


def plucker_origin(n, v):
    """Closest point of the line to the origin (gc.cpp:115-117)."""
    return jnp.cross(v, n) / jnp.sum(v * v, axis=-1, keepdims=True)


def normalize(v):
    """Safe normalization (gc.cpp:152-157)."""
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return jnp.where(n > 0, v / jnp.where(n > 0, n, 1.0), v)


def angle_normvec(v1, v2):
    """Angle between unit vectors (gc.cpp:159-161)."""
    return jnp.arccos(jnp.clip(jnp.sum(v1 * v2, axis=-1), -1.0, 1.0))


# ---------------------------------------------------------------------------
# Endpoint interval transport (gc.cpp:125-150)
# ---------------------------------------------------------------------------

def tt_to_pose(tt0, v, R, t):
    """Transport endpoint interval scalars into a pose (gc.cpp:125-138).

    Keeps the reference's convention that (0, 0) means "uninitialized" and is
    passed through unchanged.
    """
    Ri, ti = t_inv(R, t)
    vn = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
    offset = jnp.sum(ti * vn, axis=-1, keepdims=True)
    tt1 = tt0 - offset
    uninit = jnp.logical_and(tt0[..., 0] == 0, tt0[..., 1] == 0)
    return jnp.where(uninit[..., None], jnp.zeros_like(tt1), tt1)


def tt_from_pose(tt1, v, R, t):
    """Inverse of tt_to_pose (gc.cpp:140-150). No uninitialized passthrough."""
    Ri, ti = t_inv(R, t)
    vn = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
    offset = jnp.sum(ti * vn, axis=-1, keepdims=True)
    return tt1 + offset


# ---------------------------------------------------------------------------
# 4-DoF line parameterizations (gc.cpp:188-460)
# ---------------------------------------------------------------------------

def av_to_orth(av):
    """(cp, dv) line -> orthonormal 4-vector (gc.cpp:361-417).

    The rotation [x y z] = [n_hat v_hat n_hat x v_hat] is encoded as intrinsic
    Euler angles (alpha, beta, gamma); theta encodes depth via the (|n|, |v|)
    unit 2-vector.
    """
    a = av[..., :3]                  # closest point
    v = av[..., 3:]                  # direction
    n = jnp.cross(a, v)              # moment

    x = normalize(n)
    y = normalize(v)
    z = jnp.cross(x, y)

    # The rotation [x y z] is decomposed as R = Rz(gamma) Ry(beta) Rx(alpha).
    # The reference's extraction (gc.cpp:372-374) is the standard one and is
    # degenerate at gimbal lock (x parallel to +-z axis, beta = +-pi/2) —
    # measure-zero on real data but exact for axis-aligned synthetic lines,
    # so we handle it: gamma := 0 and alpha from the remaining DoF.
    beta = jnp.arcsin(jnp.clip(-x[..., 2], -1.0, 1.0))
    alpha_reg = jnp.arctan2(y[..., 2], z[..., 2])
    gamma_reg = jnp.arctan2(x[..., 1], x[..., 0])

    lock = jnp.abs(jnp.abs(x[..., 2]) - 1.0) < 1e-12
    # R[0,1] = y[0], R[1,1] = y[1]; beta=+pi/2: alpha-gamma = atan2(y0, y1);
    # beta=-pi/2: alpha+gamma = atan2(-y0, y1).
    sign_term = jnp.where(x[..., 2] < 0, y[..., 0], -y[..., 0])
    alpha_lock = jnp.arctan2(sign_term, y[..., 1])
    alpha = jnp.where(lock, alpha_lock, alpha_reg)
    gamma = jnp.where(lock, 0.0, gamma_reg)

    nn = jnp.linalg.norm(n, axis=-1)
    vn = jnp.linalg.norm(v, axis=-1)
    wnorm = jnp.sqrt(nn * nn + vn * vn)
    theta = jnp.arcsin(jnp.clip(vn / jnp.maximum(wnorm, _EPS), -1.0, 1.0))

    return jnp.stack([alpha, beta, gamma, theta], axis=-1)


def orth_rotation(orth):
    """Euler angles (alpha, beta, gamma) -> R (gc.cpp:427-438)."""
    a, b, g = orth[..., 0], orth[..., 1], orth[..., 2]
    s1, c1 = jnp.sin(a), jnp.cos(a)
    s2, c2 = jnp.sin(b), jnp.cos(b)
    s3, c3 = jnp.sin(g), jnp.cos(g)
    row0 = jnp.stack([c2 * c3, s1 * s2 * c3 - c1 * s3, c1 * s2 * c3 + s1 * s3],
                     axis=-1)
    row1 = jnp.stack([c2 * s3, s1 * s2 * s3 + c1 * c3, c1 * s2 * s3 - s1 * c3],
                     axis=-1)
    row2 = jnp.stack([-s2, s1 * c2, c1 * c2], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def orth_to_av(orth):
    """Orthonormal 4-vector -> (cp, dv) line (gc.cpp:419-460).

    d = cos(theta)/sin(theta); cp = -R[:, 2] * d; dv = R[:, 1].
    """
    R = orth_rotation(orth)
    t = orth[..., 3]
    d = jnp.cos(t) / jnp.sin(t)
    cp = -R[..., :, 2] * d[..., None]
    dv = R[..., :, 1]
    return jnp.concatenate([cp, dv], axis=-1)


def av_to_aid(av):
    """(cp, dv) -> angle-axis frame + inverse depth (gc.cpp:188-226)."""
    a = av[..., :3]
    x = av[..., 3:]                  # v
    y = jnp.cross(a, x)              # n
    d_inv = jnp.linalg.norm(x, axis=-1) / jnp.linalg.norm(y, axis=-1)
    xn = normalize(x)
    yn = normalize(y)
    z = jnp.cross(xn, yn)
    R = jnp.stack([xn, yn, z], axis=-1)
    aa = so3_log(R)
    return jnp.concatenate([aa, d_inv[..., None]], axis=-1)


def aid_to_av(aid):
    """Inverse of av_to_aid (gc.cpp:228-261)."""
    aa = aid[..., :3]
    d = 1.0 / aid[..., 3]
    R = rodrigues(aa)
    cp = R[..., :, 2] * d[..., None]
    dv = R[..., :, 0]
    return jnp.concatenate([cp, dv], axis=-1)


def av_to_asd(av):
    """(cp, dv) -> angle-axis frame + sigmoid depth (gc.cpp:265-321)."""
    a = av[..., :3]
    x = av[..., 3:]
    y = jnp.cross(a, x)
    depth = jnp.linalg.norm(x, axis=-1) / jnp.linalg.norm(y, axis=-1)
    sig_d = jnp.exp(depth)           # 1/exp(-depth), gc.cpp:291
    xn = normalize(x)
    yn = normalize(y)
    z = jnp.cross(xn, yn)
    R = jnp.stack([xn, yn, z], axis=-1)
    aa = so3_log(R)
    return jnp.concatenate([aa, sig_d[..., None]], axis=-1)


def asd_to_av(asd):
    """Inverse of av_to_asd (gc.cpp:323-356)."""
    aa = asd[..., :3]
    sig_d_inv = jnp.log(asd[..., 3])
    R = rodrigues(aa)
    cp = R[..., :, 2] * sig_d_inv[..., None]
    dv = R[..., :, 0]
    return jnp.concatenate([cp, dv], axis=-1)
