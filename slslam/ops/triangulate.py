"""Batched stereo line triangulation.

Reference: SLAM::initialize_lm (/root/reference/src/slam.cpp:190-219).  One
stereo line observation (8 normalized endpoint coords: left pair then right
pair) is back-projected to two planes — through the left camera at the origin
and the right camera at (baseline, 0, 0) — whose intersection is the 3D line
in Plücker form; returned as a (closest point, direction) 6-vector with the
reference's degenerate-depth regularization (slam.cpp:206-213).

The whole landmark batch is triangulated in one fused jnp call; there is no
per-landmark loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import geometry as geo


def triangulate_lines_host(obs, baseline, *, inverse_depth=0.1,
                           dtype=None,
                           buckets=(64, 256, 1024, 4096, 16384)):
    """Host-side entry: pad the row count to a capacity bucket before the
    jitted kernel, returning an f64 array of the first n rows.

    Host callers concatenating data-dependent row counts (the refine's
    init, the loop-confirm group fits) otherwise hand jit a NOVEL shape
    per call — and every novel shape of even this trivial kernel costs a
    fresh XLA compile, far longer than the warm call.  All-zero padding rows
    triangulate to the 10 m depth-clamped default (slam.cpp:206-213) and
    never NaN.  Rows past the last bucket round up to its next multiple.
    """
    import numpy as np

    from ..config import bucket_for
    obs = np.asarray(obs)
    n = obs.shape[0]
    Nb = (bucket_for(n, buckets) if n <= buckets[-1]
          else -(-n // buckets[-1]) * buckets[-1])
    padded = np.zeros((Nb, 8), obs.dtype)
    padded[:n] = obs
    arr = (jnp.asarray(padded, dtype) if dtype is not None
           else jnp.asarray(padded))
    return np.asarray(triangulate_lines(
        arr, baseline, inverse_depth=inverse_depth), np.float64)[:n]


@functools.partial(jax.jit, static_argnames=("inverse_depth",))
def triangulate_lines(obs, baseline, inverse_depth=0.1):
    """Triangulate a batch of stereo line observations.

    Args:
      obs: (..., 8) normalized endpoints (x0 y0 x1 y1 | x2 y2 x3 y3),
        left image pair first (slam.cpp:190-196).
      baseline: stereo baseline (scalar).
      inverse_depth: regularization depth prior (parameter.h:55).

    Returns:
      (..., 6) lines as (closest point cp, direction v) in the camera frame.
    """
    dtype = obs.dtype
    one = jnp.ones(obs.shape[:-1] + (1,), dtype)
    zero3 = jnp.zeros(obs.shape[:-1] + (3,), dtype)

    p1 = jnp.concatenate([obs[..., 0:2], one], axis=-1)
    p2 = jnp.concatenate([obs[..., 2:4], one], axis=-1)
    p3 = jnp.concatenate([obs[..., 4:5] + baseline, obs[..., 5:6], one],
                         axis=-1)
    p4 = jnp.concatenate([obs[..., 6:7] + baseline, obs[..., 7:8], one],
                         axis=-1)

    cam_r = zero3.at[..., 0].set(baseline)
    pi1 = geo.ppp_pi(p1, p2, zero3)
    pi2 = geo.ppp_pi(p3, p4, cam_r)

    plk = geo.pipi_plk(pi1, pi2)
    n, v = plk[..., :3], plk[..., 3:]
    # NaN-safe plucker_origin: padded/degenerate observations (v ~ 0) must
    # not poison a batch; they fall into the depth clamp below instead.
    vv = jnp.sum(v * v, axis=-1, keepdims=True)
    cp = jnp.cross(v, n) / jnp.maximum(vv, 1e-30)

    # Degenerate-depth clamp (slam.cpp:206-213): if the closest point is
    # closer than 0.1 or farther than 10, snap it to 1/inverse_depth along
    # its direction; then flip to positive z.
    cpn = jnp.linalg.norm(cp, axis=-1, keepdims=True)
    bad = jnp.logical_or(cpn < 0.1, cpn > 10.0)
    cp = jnp.where(bad, cp / jnp.maximum(cpn, 1e-12) / inverse_depth, cp)
    cp = jnp.where(cp[..., 2:3] < 0, -cp, cp)

    return jnp.concatenate([cp, v], axis=-1)
