"""Headless visualization.

Replaces the reference's GLFW/OpenGL + OpenCV viewer (src/cplot.{h,cpp}:
floor grid, trajectory polyline, 3D map lines, stereo observation overlay)
with matplotlib renderings to PNG — usable on headless hosts and in CI.
Not performance-relevant; reads host copies only.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def plot_map(trajectory, segments, out_path: str,
             gt_trajectory: Optional[np.ndarray] = None,
             title: str = "slslam map"):
    """Top-down (x-z plane of the world frame) map + trajectory figure.

    trajectory: list of camera-to-world Pose (engine.trajectory()).
    segments: (N, 6) world line segments (engine._landmark_world_segments).
    gt_trajectory: optional (M, >=4) rows in the save_trajectory format.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(9, 9))

    for s in segments:
        # world frame = first keyframe camera frame: x right, y down,
        # z forward.  Plot top-down: (x, z).
        ax.plot([s[0], s[3]], [s[2], s[5]], color="#888888", lw=0.8)

    if trajectory:
        xs = [T.t[0] for T in trajectory]
        zs = [T.t[2] for T in trajectory]
        ax.plot(xs, zs, color="#cc3311", lw=1.6, label="estimate")
        ax.scatter(xs[:1], zs[:1], color="#cc3311", marker="o", s=25)

    if gt_trajectory is not None and len(gt_trajectory):
        # save_trajectory format: cols (i, t_z, -t_x, -t_y, ...)
        ax.plot(-gt_trajectory[:, 2], gt_trajectory[:, 1],
                color="#0077bb", lw=1.2, ls="--", label="ground truth")

    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.legend(loc="best")
    ax.set_title(title)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_observations(img_left, img_right, obs, out_path: str,
                      image_size=(640, 480), title: str = None):
    """Stereo image pair with tracked segments overlaid in per-id colors
    (the reference's live tracking view: drawObservation /
    drawImageTracking, cplot.cpp:260-340).  Images may be None (sequences
    replayed from line-track files have no pixels) — segments then draw on
    a blank canvas of ``image_size``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if img_left is None:
        img_left = np.full((image_size[1], image_size[0]), 235, np.uint8)
    if img_right is None:
        img_right = np.full((image_size[1], image_size[0]), 235, np.uint8)

    fig, axes = plt.subplots(1, 2, figsize=(14, 5))
    if title:
        fig.suptitle(title)
    for ax, img in zip(axes, (img_left, img_right)):
        ax.imshow(img, cmap="gray", vmin=0, vmax=255)
        ax.axis("off")
    rng = np.random.default_rng(0)
    for fid, o in obs.items():
        col = tuple(rng.random(3) * 0.7 + 0.2)
        rs = np.random.default_rng(fid)
        col = tuple(rs.random(3) * 0.7 + 0.15)
        axes[0].plot([o[0], o[2]], [o[1], o[3]], color=col, lw=1.4)
        axes[1].plot([o[4], o[6]], [o[5], o[7]], color=col, lw=1.4)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
