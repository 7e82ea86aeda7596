"""Interactive HTML map viewer (viz_interactive.py)."""

import json
import re

import numpy as np

from slslam.hostgeom import Pose, rodrigues
from slslam.viz_interactive import export_interactive_map


def _toy_run(n=12, segs=5):
    rng = np.random.default_rng(0)
    traj = [Pose(rodrigues(rng.standard_normal(3) * 0.05),
                 rng.standard_normal(3)) for _ in range(n)]
    s = rng.standard_normal((segs, 6)) * 3.0
    gt = np.concatenate([np.arange(n)[:, None],
                         rng.standard_normal((n, 6))], axis=1)
    return traj, s, gt


def test_export_embeds_valid_data(tmp_path):
    traj, segs, gt = _toy_run()
    out = tmp_path / "map.html"
    export_interactive_map(str(out), traj, segs, gt_rows=gt,
                           first_seen=list(range(len(segs))),
                           frame_stats=[{"obs": i} for i in range(len(traj))],
                           title="toy")
    html = out.read_text()
    m = re.search(r"const D = (.*?);\n", html, re.S)
    d = json.loads(m.group(1))
    assert len(d["traj"]) == len(traj)
    assert len(d["rots"]) == len(traj)
    assert len(d["segs"]) == len(segs)
    assert len(d["gt"]) == len(gt)
    assert d["first_seen"] == list(range(len(segs)))
    assert d["stats"][3] == {"obs": 3}
    # self-contained: no external scripts or stylesheets
    assert "src=" not in html and "href=" not in html


def test_export_handles_empty_map(tmp_path):
    traj, _, _ = _toy_run(n=3)
    out = tmp_path / "m.html"
    export_interactive_map(str(out), traj, np.zeros((0, 6)))
    d = json.loads(re.search(r"const D = (.*?);\n",
                             out.read_text(), re.S).group(1))
    assert d["segs"] == [] and d["gt"] is None
