"""Line segment detector (LSD-style), built fresh.

The reference ships no detector ("due to license problem", README:31-33);
only the line-track file contract exists.  This is a from-scratch two-stage
detector:

  * device stage (jit, convolutions): Gaussian smoothing, Sobel
    gradients, gradient magnitude + level-line angle — one fused kernel over
    the whole image (or a batch of images);
  * host stage: anchor-seeded region growing along level-lines (the LSD
    recipe), PCA line fit, and density validation.

Output segments are (x1, y1, x2, y2) in pixels, ordered so they can feed the
stereo/temporal matcher.
"""

from __future__ import annotations

import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np


def _gaussian_kernel(sigma: float, radius: int):
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


@functools.partial(jax.jit, static_argnames=("sigma_radius",))
def image_gradients(img, sigma_radius=(1.0, 2)):
    """(H, W) grayscale -> (magnitude, angle) maps.

    Separable Gaussian blur then Sobel; angle is the level-line angle
    (perpendicular to the gradient), in [-pi, pi).
    """
    img = img.astype(jnp.float32)
    sigma, radius = sigma_radius
    k = _gaussian_kernel(sigma, radius)

    def conv1d(x, k, axis):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (len(k) // 2, len(k) // 2)
        x = jnp.pad(x, pad, mode="edge")
        window = len(k)
        idx = jnp.arange(x.shape[axis] - window + 1)[:, None] + \
            jnp.arange(window)[None, :]
        if axis == 0:
            xs = x[idx, :]                       # (H, win, W)
            return jnp.tensordot(xs, k, axes=([1], [0]))
        xs = x[:, idx]                            # (H, W, win)
        return jnp.tensordot(xs, k, axes=([2], [0]))

    sm = conv1d(conv1d(img, k, 0), k, 1)

    sobel_x = jnp.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]],
                        jnp.float32) / 8.0
    sobel_y = sobel_x.T

    def conv2(x, k2):
        x = jnp.pad(x, ((1, 1), (1, 1)), mode="edge")
        out = jnp.zeros_like(x[1:-1, 1:-1])
        for dy in range(3):
            for dx in range(3):
                out = out + k2[dy, dx] * x[dy:dy + x.shape[0] - 2,
                                           dx:dx + x.shape[1] - 2]
        return out

    gx = conv2(sm, sobel_x)
    gy = conv2(sm, sobel_y)
    mag = jnp.sqrt(gx * gx + gy * gy)
    # level-line angle: perpendicular to gradient
    angle = jnp.arctan2(gx, -gy)
    return mag, angle


def _angle_diff(a, b):
    d = np.abs(a - b) % (2 * np.pi)
    return np.minimum(d, 2 * np.pi - d)


def fuse_stroke_edge_pairs(segs, grad_dirs, angle_tol=3.0 * np.pi / 180.0,
                           max_sep=5.0, min_sep=0.5, min_overlap=0.3):
    """Fuse the two edges of a dark/bright stroke into its centerline.

    A thin stroke produces two parallel detections with anti-parallel
    gradients (both pointing out of — or into — the stroke).  Pairing them
    and averaging removes the systematic half-stroke offset that otherwise
    biases stereo disparity by a full stroke width when the two cameras
    lock onto opposite edges.  Unpaired segments pass through unchanged
    (real-world intensity edges are single-sided).
    """
    n = len(segs)
    if n <= 1:
        return segs
    d = segs[:, 2:4] - segs[:, 0:2]
    length = np.hypot(d[:, 0], d[:, 1])
    u = d / np.maximum(length, 1e-9)[:, None]
    ang = np.arctan2(u[:, 1], u[:, 0]) % np.pi
    mid = (segs[:, 0:2] + segs[:, 2:4]) / 2

    # pair pre-filter as (n, n) broadcasts — the per-pair Python loop was
    # ~70 ms/image at 280 detections (r5 profile), dominated by pairs
    # rejected at the first gate
    da = np.abs(ang[:, None] - ang[None, :])
    ok = np.minimum(da, np.pi - da) <= angle_tol
    ok &= (grad_dirs @ grad_dirs.T) <= -0.5      # anti-parallel gradients
    dmid = mid[None, :, :] - mid[:, None, :]     # (i, j, 2)
    off_m = np.abs(u[:, None, 0] * dmid[..., 1]
                   - u[:, None, 1] * dmid[..., 0])
    ok &= (off_m >= min_sep) & (off_m <= max_sep)
    r0 = segs[None, :, 0:2] - segs[:, None, 0:2]
    r1 = segs[None, :, 2:4] - segs[:, None, 0:2]
    t0 = np.einsum("ik,ijk->ij", u, r0)
    t1 = np.einsum("ik,ijk->ij", u, r1)
    tj_lo, tj_hi = np.minimum(t0, t1), np.maximum(t0, t1)
    inter = np.minimum(length[:, None], tj_hi) - np.maximum(0.0, tj_lo)
    ok &= inter >= min_overlap * np.minimum(length[:, None],
                                            length[None, :])
    ok &= np.triu(np.ones((n, n), bool), 1)      # i < j once
    ii, jj = np.nonzero(ok)
    cands = sorted(zip(off_m[ii, jj], ii.tolist(), jj.tolist()))
    used = set()
    out = []
    for off, i, j in cands:
        if i in used or j in used:
            continue
        used.add(i)
        used.add(j)
        # centerline: project both segments' endpoints onto the average
        # direction through the midpoint between the two lines
        w = np.array([length[i], length[j]])
        a2 = 2 * np.array([ang[i], ang[j]])
        avg = 0.5 * np.arctan2((w * np.sin(a2)).sum(),
                               (w * np.cos(a2)).sum())
        uu = np.array([np.cos(avg), np.sin(avg)])
        c = (mid[i] * length[i] + mid[j] * length[j]) / (length[i]
                                                         + length[j])
        pts = np.concatenate([segs[i].reshape(2, 2), segs[j].reshape(2, 2)])
        ts = (pts - c) @ uu
        out.append(np.concatenate([c + ts.min() * uu, c + ts.max() * uu]))
    for k in range(n):
        if k not in used:
            out.append(segs[k])
    return np.stack(out) if out else segs


def merge_collinear_segments(segs, angle_tol=2.0 * np.pi / 180.0,
                             offset_tol=2.5, gap_tol=8.0):
    """Fuse fragments lying on the same infinite image line.

    Region growing breaks lines at junctions and detects both edges of a
    thick stroke; fragments whose direction agrees within angle_tol, whose
    perpendicular offset is under offset_tol px, and whose extents touch
    within gap_tol px are merged (union-find), keeping the extreme
    endpoints projected onto the average direction.
    """
    n = len(segs)
    if n <= 1:
        return segs
    d = segs[:, 2:4] - segs[:, 0:2]
    length = np.hypot(d[:, 0], d[:, 1])
    u = d / np.maximum(length, 1e-9)[:, None]
    ang = np.arctan2(u[:, 1], u[:, 0]) % np.pi
    mid = (segs[:, 0:2] + segs[:, 2:4]) / 2

    parent = np.arange(n)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    # pair pre-filter as (n, n) broadcasts (see fuse_stroke_edge_pairs);
    # union-find runs only over the surviving pairs
    da = np.abs(ang[:, None] - ang[None, :])
    ok = np.minimum(da, np.pi - da) <= angle_tol
    dm = mid[None, :, :] - segs[:, None, 0:2]
    off_m = np.abs(u[:, None, 0] * dm[..., 1]
                   - u[:, None, 1] * dm[..., 0])
    ok &= off_m <= offset_tol
    r0 = segs[None, :, 0:2] - segs[:, None, 0:2]
    r1 = segs[None, :, 2:4] - segs[:, None, 0:2]
    t0 = np.einsum("ik,ijk->ij", u, r0)
    t1 = np.einsum("ik,ijk->ij", u, r1)
    tj_lo, tj_hi = np.minimum(t0, t1), np.maximum(t0, t1)
    gap = np.maximum(0.0, tj_lo) - np.minimum(length[:, None], tj_hi)
    ok &= gap <= gap_tol
    ok &= np.triu(np.ones((n, n), bool), 1)
    for i, j in zip(*np.nonzero(ok)):
        parent[find(i)] = find(j)

    groups = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)

    out = []
    for members in groups.values():
        if len(members) == 1:
            out.append(segs[members[0]])
            continue
        w = length[members]
        # average direction (mod pi, via doubled-angle trick)
        a2 = 2 * ang[members]
        avg = 0.5 * np.arctan2((w * np.sin(a2)).sum(),
                               (w * np.cos(a2)).sum())
        uu = np.array([np.cos(avg), np.sin(avg)])
        c = (mid[members] * w[:, None]).sum(axis=0) / w.sum()
        pts = np.concatenate([segs[members][:, 0:2], segs[members][:, 2:4]])
        ts = (pts - c) @ uu
        out.append(np.concatenate([c + ts.min() * uu, c + ts.max() * uu]))
    return np.stack(out)


class LineSegmentDetector:
    def __init__(self, mag_threshold: float = 5.0,
                 angle_tolerance: float = 22.5 * np.pi / 180.0,
                 min_length: float = 20.0, min_density: float = 0.6,
                 merge_collinear: bool = True,
                 fuse_stroke_edges: bool = True,
                 stroke_max_sep: float = 5.0):
        self.mag_threshold = mag_threshold
        self.angle_tol = angle_tolerance
        self.min_length = min_length
        self.min_density = min_density
        self.merge_collinear = merge_collinear
        self.fuse_stroke_edges = fuse_stroke_edges
        self.stroke_max_sep = stroke_max_sep

    def detect(self, img: np.ndarray) -> np.ndarray:
        """(H, W) grayscale -> (N, 4) segments (x1, y1, x2, y2)."""
        return self.detect_with_gradients(img)[0]

    def detect_with_gradients(self, img: np.ndarray):
        """detect() that also returns the (magnitude, angle) gradient
        maps it computed — the descriptor stage needs the same maps, and
        recomputing them cost ~2x the gradient wall per frame (r5
        front-end profile).

        The region-growing pass runs in the native runtime library when
        available (60x the pure-Python fallback below; same semantics,
        cross-checked in tests/test_native.py)."""
        mag, angle = image_gradients(jnp.asarray(img, jnp.float32))
        mag = np.asarray(mag)
        angle = np.asarray(angle)

        from .. import native
        nat = native.lsd_detect(mag, angle, self.mag_threshold,
                                self.angle_tol, self.min_length,
                                self.min_density)
        if nat is not None:
            out, gd = nat
            return self._postprocess(out, gd), mag, angle
        return (self._postprocess(*self._grow_regions(mag, angle)),
                mag, angle)

    def _postprocess(self, out, gd):
        if self.fuse_stroke_edges and len(out):
            out = fuse_stroke_edge_pairs(out, gd,
                                         max_sep=self.stroke_max_sep)
        if self.merge_collinear and len(out):
            out = merge_collinear_segments(out)
            out = out[np.hypot(out[:, 2] - out[:, 0],
                               out[:, 3] - out[:, 1]) >= self.min_length] \
                if len(out) else out
        return out

    def _grow_regions(self, mag, angle):
        """Pure-Python region growing (the native kernel's reference)."""
        H, W = mag.shape
        used = mag < self.mag_threshold      # True = not usable
        # anchors: strongest gradients first (LSD's pseudo-ordering)
        ys, xs = np.nonzero(~used)
        if len(ys) == 0:
            return np.zeros((0, 4)), np.zeros((0, 2))
        order = np.argsort(-mag[ys, xs])
        ys, xs = ys[order], xs[order]

        segments: List[np.ndarray] = []
        grad_dirs: List[np.ndarray] = []
        neigh = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1),
                 (1, -1), (1, 0), (1, 1)]

        for y0, x0 in zip(ys, xs):
            if used[y0, x0]:
                continue
            # region growing along the level-line direction
            region = [(y0, x0)]
            used[y0, x0] = True
            theta = angle[y0, x0]
            sx, sy = np.cos(theta), np.sin(theta)
            head = 0
            while head < len(region):
                cy, cx = region[head]
                head += 1
                for dy, dx in neigh:
                    ny, nx = cy + dy, cx + dx
                    if ny < 0 or ny >= H or nx < 0 or nx >= W:
                        continue
                    if used[ny, nx]:
                        continue
                    if _angle_diff(angle[ny, nx], theta) > self.angle_tol:
                        continue
                    used[ny, nx] = True
                    region.append((ny, nx))
                    # region angle update (LSD: running mean direction)
                    sx += np.cos(angle[ny, nx])
                    sy += np.sin(angle[ny, nx])
                    theta = np.arctan2(sy, sx)

            if len(region) < self.min_length:
                continue
            # mean gradient direction of the region (for stroke-edge
            # polarity: level-line angle a => gradient unit (sin a, -cos a))
            ridx = np.asarray(region)
            ra = angle[ridx[:, 0], ridx[:, 1]]
            gvec = np.array([np.sin(ra).sum(), -np.cos(ra).sum()])
            gn = np.linalg.norm(gvec)
            gvec = gvec / gn if gn > 0 else gvec

            pts = np.asarray(region, np.float64)       # (n, 2) (y, x)
            w = mag[pts[:, 0].astype(int), pts[:, 1].astype(int)]
            w = w / w.sum()
            c = (pts * w[:, None]).sum(axis=0)
            d = pts - c
            cov = (d * w[:, None]).T @ d
            evals, evecs = np.linalg.eigh(cov)
            v = evecs[:, -1]                           # (dy, dx) major axis
            t = d @ v
            t0, t1 = t.min(), t.max()
            length = t1 - t0
            if length < self.min_length:
                continue
            # density validation (rectangle width from minor eigenvalue)
            width = max(2.0 * np.sqrt(max(evals[0], 1e-12)) * 2.0, 1.0)
            density = len(region) / (length * width)
            if density < self.min_density:
                continue
            p1 = c + t0 * v
            p2 = c + t1 * v
            segments.append(np.array([p1[1], p1[0], p2[1], p2[0]]))
            grad_dirs.append(gvec)

        out = np.stack(segments) if segments else np.zeros((0, 4))
        gd = np.stack(grad_dirs) if grad_dirs else np.zeros((0, 2))
        return out, gd
