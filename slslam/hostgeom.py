"""NumPy (float64) mirror of the scalar geometry used by the engine shell.

The imperative engine shell (graph bookkeeping, metric embedding, window
selection) composes a few hundred poses per frame.  Doing that through jnp
would cost a device dispatch per op, so the shell uses this plain-NumPy
mirror; the jitted device kernels use :mod:`slslam.geometry`.  The two are
cross-checked against each other in tests/test_geometry.py.

Reference semantics: /root/reference/src/gc.cpp (see geometry.py docstrings
for per-function line citations).
"""

from __future__ import annotations

import numpy as np


class Pose:
    """SE(3) pose p_c = R p_w + t (reference pose_t, src/all.h:42-49)."""

    __slots__ = ("R", "t")

    def __init__(self, R=None, t=None):
        self.R = np.eye(3) if R is None else np.asarray(R, dtype=np.float64)
        self.t = np.zeros(3) if t is None else np.asarray(t, dtype=np.float64)

    def inv(self) -> "Pose":
        Ri = self.R.T
        return Pose(Ri, -Ri @ self.t)

    def __matmul__(self, other: "Pose") -> "Pose":
        """T20 = self * other (gc_T_20)."""
        return Pose(self.R @ other.R, self.R @ other.t + self.t)

    def rel_to(self, other: "Pose") -> "Pose":
        """T21 = self * other^-1 (gc_T_21)."""
        return self @ other.inv()

    def copy(self) -> "Pose":
        return Pose(self.R.copy(), self.t.copy())

    def wt(self) -> np.ndarray:
        return np.concatenate([so3_log(self.R), self.t])

    @staticmethod
    def from_wt(wt) -> "Pose":
        wt = np.asarray(wt, dtype=np.float64)
        return Pose(rodrigues(wt[:3]), wt[3:])

    def __repr__(self):
        return f"Pose(w={so3_log(self.R)}, t={self.t})"


def skew(v):
    return np.array([
        [0.0, -v[2], v[1]],
        [v[2], 0.0, -v[0]],
        [-v[1], v[0], 0.0],
    ])


def rodrigues(w):
    """Angle-axis -> rotation matrix."""
    w = np.asarray(w, dtype=np.float64)
    theta2 = float(w @ w)
    W = skew(w)
    if theta2 < 1e-16:
        a = 1.0 - theta2 / 6.0
        b = 0.5 - theta2 / 24.0
    else:
        theta = np.sqrt(theta2)
        a = np.sin(theta) / theta
        b = (1.0 - np.cos(theta)) / theta2
    return np.eye(3) + a * W + b * (W @ W)


def so3_log(R):
    """Rotation matrix -> angle-axis (robust near 0 and pi)."""
    R = np.asarray(R, dtype=np.float64)
    vee = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                          R[1, 0] - R[0, 1]])
    s = np.linalg.norm(vee)
    c = 0.5 * (np.trace(R) - 1.0)
    theta = np.arctan2(s, c)
    if c < -0.99:
        diag = np.diag(R)
        axis2 = np.maximum((diag - c) / (1.0 - c + 1e-300), 0.0)
        axis = np.sqrt(axis2)
        sgn = np.sign(np.where(np.abs(vee) > 1e-12, vee, 1.0))
        axis = axis * sgn
        axis /= (np.linalg.norm(axis) + 1e-300)
        return theta * axis
    if s < 1e-8:
        return (1.0 + (1.0 - c) / 6.0) * vee
    return (theta / s) * vee


def line_to_pose(line_w, T: Pose):
    cp = T.R @ line_w[:3] + T.t
    dv = T.R @ line_w[3:]
    return np.concatenate([cp, dv])


def line_from_pose(line_c, T: Pose):
    return line_to_pose(line_c, T.inv())


def normalize(v):
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def angle_normvec(v1, v2):
    return np.arccos(np.clip(v1 @ v2, -1.0, 1.0))


def rotation_angle(R) -> float:
    """|angle| of a rotation matrix, for threshold checks."""
    return float(np.linalg.norm(so3_log(R)))


# ---------------------------------------------------------------------------
# Vectorized line transforms / parameterizations (NumPy mirrors of
# geometry.py, used by the engine shell to avoid device round-trips for
# cheap host-side conversions).  Semantics: gc.cpp:361-460 (orth),
# :188-261 (aid); see geometry.py for the gimbal-lock handling notes.
# ---------------------------------------------------------------------------

def lines_from_pose(lines_c, T: Pose):
    """(N, 6) (cp, dv) lines camera -> world, batched."""
    Ti = T.inv()
    cp = lines_c[:, :3] @ Ti.R.T + Ti.t
    dv = lines_c[:, 3:] @ Ti.R.T
    return np.concatenate([cp, dv], axis=1)


def _normalize_rows(v):
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return np.where(n > 0, v / np.where(n > 0, n, 1.0), v)


def av_to_orth_np(av):
    """(N, 6) -> (N, 4), batched NumPy mirror of geometry.av_to_orth."""
    a = av[:, :3]
    v = av[:, 3:]
    n = np.cross(a, v)
    x = _normalize_rows(n)
    y = _normalize_rows(v)
    z = np.cross(x, y)

    beta = np.arcsin(np.clip(-x[:, 2], -1.0, 1.0))
    alpha_reg = np.arctan2(y[:, 2], z[:, 2])
    gamma_reg = np.arctan2(x[:, 1], x[:, 0])
    lock = np.abs(np.abs(x[:, 2]) - 1.0) < 1e-12
    sign_term = np.where(x[:, 2] < 0, y[:, 0], -y[:, 0])
    alpha = np.where(lock, np.arctan2(sign_term, y[:, 1]), alpha_reg)
    gamma = np.where(lock, 0.0, gamma_reg)

    nn = np.linalg.norm(n, axis=1)
    vn = np.linalg.norm(v, axis=1)
    wnorm = np.sqrt(nn * nn + vn * vn)
    theta = np.arcsin(np.clip(vn / np.maximum(wnorm, 1e-300), -1.0, 1.0))
    return np.stack([alpha, beta, gamma, theta], axis=1)


def orth_to_av_np(orth):
    """(N, 4) -> (N, 6), batched NumPy mirror of geometry.orth_to_av."""
    a, b, g, t = orth[:, 0], orth[:, 1], orth[:, 2], orth[:, 3]
    s1, c1 = np.sin(a), np.cos(a)
    s2, c2 = np.sin(b), np.cos(b)
    s3, c3 = np.sin(g), np.cos(g)
    d = np.cos(t) / np.sin(t)
    col2 = np.stack([c1 * s2 * c3 + s1 * s3,
                     c1 * s2 * s3 - s1 * c3,
                     c1 * c2], axis=1)
    col1 = np.stack([s1 * s2 * c3 - c1 * s3,
                     s1 * s2 * s3 + c1 * c3,
                     s1 * c2], axis=1)
    return np.concatenate([-col2 * d[:, None], col1], axis=1)


def av_to_aid_np(av):
    """(N, 6) -> (N, 4), batched NumPy mirror of geometry.av_to_aid."""
    a = av[:, :3]
    x = av[:, 3:]
    y = np.cross(a, x)
    d_inv = np.linalg.norm(x, axis=1) / np.linalg.norm(y, axis=1)
    xn = _normalize_rows(x)
    yn = _normalize_rows(y)
    z = np.cross(xn, yn)
    aa = np.stack([so3_log(np.stack([xn[i], yn[i], z[i]], axis=1))
                   for i in range(len(av))])
    return np.concatenate([aa, d_inv[:, None]], axis=1)


def aid_to_av_np(aid):
    """(N, 4) -> (N, 6), batched NumPy mirror of geometry.aid_to_av."""
    out = np.empty((len(aid), 6))
    for i, row in enumerate(aid):
        R = rodrigues(row[:3])
        d = 1.0 / row[3]
        out[i, :3] = R[:, 2] * d
        out[i, 3:] = R[:, 0]
    return out
