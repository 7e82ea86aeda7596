"""The two simulated workloads that the benchmark and the smoke run drive.

* house replay: the reference's own simulation benchmark — the house world
  along the wave trajectory, 0.2 px observation noise, every frame a
  keyframe (the reference's 400-keyframe run,
  matlab_script/result_comp_ancdir_orthonorm/).
* village deferred loop closure: a drifted 170-frame orbit with revisits
  through six houses (tests/test_batch_lc.py guards its closures).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple

import numpy as np

from ..config import SlamConfig
from .house import house_segments
from .render import StereoLineRenderer
from .tracks import SegmentDescriptorSource, TrackIdAssigner
from .village import village_segments, village_trajectory
from .wave import wave_trajectory


def house_replay_config(dtype: str) -> SlamConfig:
    """Every frame a keyframe, capacity buckets sized to the workload
    (74 landmarks, ~74 observations per frame): the default 128 buckets
    would pad 60% garbage rows into every per-LM-iteration op."""
    return dataclasses.replace(
        SlamConfig(), compute_dtype=dtype, kf_rot_thr=1e-9, kf_tr_thr=1e-9,
        obs_buckets=(80, 2048), line_buckets=(80, 2048),
        corr_buckets=(80, 256))


def house_replay(cfg: SlamConfig, num_frames: int = 400, seed: int = 4,
                 noise_px: float = 0.2):
    """(frames, ground-truth camera-to-world poses) of the house replay."""
    poses_gt = wave_trajectory(num_frames=400)[:num_frames]
    ren = StereoLineRenderer(house_segments(), cfg.camera,
                             noise_px=noise_px, seed=seed)
    return [ren.observe(T) for T in poses_gt], poses_gt


def rooted_ate(traj, poses_gt, kf_idx) -> float:
    """Mean position error of an estimated camera-to-world trajectory (one
    pose per keyframe in ``kf_idx``) against ground truth, both rooted at
    the first keyframe (calc_traj_err.m:27-40 semantics)."""
    T0 = poses_gt[kf_idx[0]]
    gt = [(poses_gt[i] @ T0.inv()).inv() for i in kf_idx]
    return float(np.mean([np.linalg.norm(a.t - b.t)
                          for a, b in zip(traj, gt)]))


class VillageLC(NamedTuple):
    cfg: SlamConfig
    frames: List[dict]
    poses_gt: list
    make_engine: Callable   # () -> a fresh BatchSlamLC


def village_lc(dtype: str, num_frames: int = 170, seed: int = 1,
               overlap_descriptors: bool = False) -> VillageLC:
    """The deferred-loop-closure workload: village orbit with revisits ->
    batch replay + voctree recognition + device relative poses + PGO +
    merged global refine (engine/batch_lc.py)."""
    from ..engine.batch_lc import BatchSlamLC
    from ..loopclosure import VocTree, build_vocabulary
    from ..loopclosure.batch import BatchPlaceRecognizer
    from ..loopclosure.voctree import VocTreeParams

    # capacity buckets sized to the village workload; the small leading
    # entries keep the confirm stages' per-span problems tightly padded
    cfg = dataclasses.replace(
        SlamConfig(), compute_dtype=dtype, kf_rot_thr=1e-9, kf_tr_thr=1e-9,
        obs_buckets=(64, 80, 128, 256, 512, 1024, 2048),
        line_buckets=(32, 64, 128, 320, 512, 1024, 2048),
        corr_buckets=(80, 256))
    segs = village_segments(n_houses=6, ring_radius=9.0)
    poses_gt = village_trajectory(num_frames=170, arc=2.7 * np.pi,
                                  orbit_radius=3.8)[:num_frames]
    ren = StereoLineRenderer(segs, cfg.camera, noise_px=0.3, seed=seed)
    assigner = TrackIdAssigner(max_gap=5)
    desc_src = SegmentDescriptorSource(assigner, len(segs), noise=0.01,
                                       seed=7)
    frames = [assigner.assign(i, ren.observe(T))
              for i, T in enumerate(poses_gt)]

    # the vocabulary is a prebuilt artifact in the reference (trees/ dir)
    rng0 = np.random.default_rng(0)
    samples = np.concatenate([
        desc_src.base + rng0.standard_normal(
            desc_src.base.shape).astype(np.float32) * 0.02
        for _ in range(3)])
    samples /= np.linalg.norm(samples, axis=1, keepdims=True)
    vocab = build_vocabulary(samples, seed=0, kmeans_iters=2)
    params = VocTreeParams(non_consider_recent=10, consider_seq_length=4,
                           threshold=0.25, num_avg_words=30)

    def make_engine():
        rec = BatchPlaceRecognizer(VocTree(vocab, params), min_matches=8,
                                   min_similarity=0.8)
        return BatchSlamLC(cfg, recognizer=rec, descriptor_source=desc_src,
                           refine=True, refine_rounds=2,
                           overlap_descriptors=overlap_descriptors)

    return VillageLC(cfg, frames, poses_gt, make_engine)
