"""Front-end tests: detector, descriptor, stereo/temporal matcher, loader."""

import numpy as np
import pytest

from slslam.config import CameraConfig
from slslam.frontend.detector import (LineSegmentDetector,
                                      merge_collinear_segments)
from slslam.frontend.io import ObsFileLoader, parse_obs_file
from slslam.frontend.matcher import StereoLineMatcher
from slslam.sim import house_segments, wave_trajectory
from slslam.sim.images import StereoImageRenderer, draw_segments

CAM = CameraConfig()


@pytest.fixture(scope="module")
def stereo_frame():
    segs = house_segments()
    poses = wave_trajectory(num_frames=100)
    ren = StereoImageRenderer(segs, CAM, noise=2.0)
    img_l, img_r, gt_obs = ren.render(poses[0])
    return img_l, img_r, gt_obs


class TestDetector:
    def test_detects_clean_lines(self):
        img = draw_segments(
            np.array([[50.0, 50.0, 500.0, 80.0],
                      [100.0, 400.0, 480.0, 120.0],
                      [320.0, 30.0, 330.0, 450.0]]),
            640, 480, noise=1.0)
        det = LineSegmentDetector()
        found = det.detect(img)
        assert 3 <= len(found) <= 8
        # each true line recovered by some detection (angle + offset)
        gt = np.array([[50, 50, 500, 80], [100, 400, 480, 120],
                       [320, 30, 330, 450]], float)
        for g in gt:
            gv = g[2:4] - g[0:2]
            gv = gv / np.linalg.norm(gv)
            hit = False
            for f in found:
                mid = (f[0:2] + f[2:4]) / 2
                dist = abs(gv[0] * (mid - g[0:2])[1]
                           - gv[1] * (mid - g[0:2])[0])
                fv = f[2:4] - f[0:2]
                fv = fv / np.linalg.norm(fv)
                if dist < 3 and abs(abs(gv @ fv) - 1) < 0.01:
                    hit = True
            assert hit, f"line {g} not detected"

    def test_house_frame_on_true_lines(self, stereo_frame):
        img_l, _, gt_obs = stereo_frame
        det = LineSegmentDetector()
        found = det.detect(img_l)
        assert len(found) >= 40
        gt = np.stack([o[:4] for o in gt_obs.values()])
        on_line = 0
        for f in found:
            mid = (f[0:2] + f[2:4]) / 2
            for g in gt:
                gv = g[2:4] - g[0:2]
                n = np.linalg.norm(gv)
                if n < 1:
                    continue
                gv = gv / n
                dist = abs(gv[0] * (mid - g[0:2])[1]
                           - gv[1] * (mid - g[0:2])[0])
                if dist < 3:
                    on_line += 1
                    break
        assert on_line / len(found) > 0.9

    def test_empty_image(self):
        det = LineSegmentDetector()
        found = det.detect(np.full((480, 640), 128.0))
        assert len(found) == 0

    def test_merge_collinear(self):
        segs = np.array([
            [10.0, 100.0, 200.0, 100.0],
            [205.0, 100.5, 400.0, 100.5],   # collinear continuation
            [10.0, 300.0, 200.0, 300.0],    # distinct line
        ])
        merged = merge_collinear_segments(segs)
        assert len(merged) == 2
        lengths = sorted(np.hypot(merged[:, 2] - merged[:, 0],
                                  merged[:, 3] - merged[:, 1]))
        assert lengths[-1] > 380


class TestMatcher:
    def test_stereo_and_temporal(self, stereo_frame):
        segs = house_segments()
        poses = wave_trajectory(num_frames=100)
        ren = StereoImageRenderer(segs, CAM, noise=2.0)
        m = StereoLineMatcher(CAM)
        prev = None
        for i in range(3):
            img_l, img_r, _ = ren.render(poses[i])
            obs = m.process(i, img_l, img_r)
            assert len(obs) >= 30
            for o in obs.values():
                assert o.shape == (8,)
                # positive disparity: left x > right x on average
                assert (o[0] + o[2]) / 2 >= (o[4] + o[6]) / 2 - 1.0
            ids = set(obs)
            if prev is not None:
                assert len(ids & prev) >= 20, "temporal carry-over too low"
            prev = ids


class TestLoader:
    def test_iterates_and_stops(self, tmp_path):
        d = tmp_path / "seq"
        d.mkdir()
        for i in range(3):
            (d / f"{i:04d}.txt").write_text(
                f"{i} 1 2 3 4 5 6 7 8 0\n")
        frames = list(ObsFileLoader(str(d)))
        assert [f for f, _ in frames] == [0, 1, 2]
        assert list(frames[1][1]) == [1]

    def test_missing_frame0(self, tmp_path):
        d = tmp_path / "seq"
        d.mkdir()
        (d / "0001.txt").write_text("5 1 2 3 4 5 6 7 8 0\n")
        frames = list(ObsFileLoader(str(d)))
        # frame 0 absent -> empty obs, then frame 1, then stop
        assert [f for f, _ in frames] == [0, 1]
        assert frames[0][1] == {}


def test_image_pipeline_end_to_end_ba_grade():
    """Rendered stereo images -> detector -> matcher -> batch engine ->
    refine reaches BA-grade ATE (VERDICT r3 item 6) — the full
    from-scratch front-end driving the device pipeline, no oracle
    tracks anywhere."""
    import dataclasses

    from slslam.config import SlamConfig
    from slslam.engine.batch import BatchSlam, normalize_frames
    from slslam.engine.refine import global_refine
    from slslam.frontend.matcher import StereoLineMatcher
    from slslam.sim import house_segments, wave_trajectory
    from slslam.sim.images import StereoImageRenderer

    cfg = dataclasses.replace(SlamConfig(), compute_dtype="float64",
                              kf_rot_thr=1e-9, kf_tr_thr=1e-9)
    segs = house_segments()
    poses_gt = wave_trajectory(num_frames=400)[::3][:25]
    matcher = StereoLineMatcher(cfg.camera)
    ren = StereoImageRenderer(segs, cfg.camera)
    frames = []
    for i, T in enumerate(poses_gt):
        img_l, img_r, _ = ren.render(T)
        frames.append(matcher.process(i, img_l, img_r))
    assert np.mean([len(f) for f in frames]) > 20, "tracker starved"

    frames_n = normalize_frames(frames, cfg.camera)
    res = BatchSlam(cfg).run(frames_n)
    assert res.kf_count == len(frames)
    ref = global_refine(frames_n, res.is_kf, res.trajectory, config=cfg)

    T0 = poses_gt[0]
    gt = [(g @ T0.inv()).inv() for g in poses_gt]
    ate = float(np.mean([np.linalg.norm(a.t - b.t)
                         for a, b in zip(ref.trajectory, gt)]))
    # image-pipeline tracks carry rasterization + detection noise well
    # above the oracle tracks' 0.5 px; BA-grade here means decimeters
    # over the ~8 m path, an order under the raw VO drift
    assert ate < 0.35, f"image-pipeline refined ATE {ate}"
