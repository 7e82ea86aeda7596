"""Native C++ runtime components vs their Python reference implementations."""

import numpy as np
import pytest

from slslam import native
from slslam.engine.embedding import _python_embedding, metric_embedding
from slslam.engine.state import Edge, Keyframe, MapState
from slslam.hostgeom import Pose, rodrigues

needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native library not built")


@needs_native
class TestNativeLoader:
    def test_roundtrip(self, tmp_path):
        p = tmp_path / "0001.txt"
        rows = [
            (3, np.arange(8) * 1.5),
            (7, np.arange(8) * -0.25 + 100),
            (12, np.random.default_rng(0).standard_normal(8) * 300),
        ]
        with open(p, "w") as f:
            for fid, o in rows:
                f.write(f"{fid} " + " ".join(f"{v:.6f}" for v in o) + " 0\n")
        out = native.parse_obs_file(str(p))
        assert set(out) == {3, 7, 12}
        for fid, o in rows:
            np.testing.assert_allclose(out[fid], np.round(o, 6), atol=1e-9)

    def test_missing_file(self):
        assert native.parse_obs_file("/nonexistent/file.txt") is None

    def test_malformed_lines_skipped(self, tmp_path):
        p = tmp_path / "bad.txt"
        p.write_text("not a row\n5 1 2 3 4 5 6 7 8 0\n\n9 1 2 3\n")
        out = native.parse_obs_file(str(p))
        assert set(out) == {5}


def chain_state(n=12, seed=0):
    """A keyframe chain with a few extra (loop) edges."""
    rng = np.random.default_rng(seed)
    st = MapState()
    for i in range(n):
        st.kfs[i] = Keyframe(T=Pose())
    def add_edge(i, j):
        T = Pose(rodrigues(rng.standard_normal(3) * 0.1),
                 rng.standard_normal(3))
        st.edges[(i, j)] = Edge.from_pose(T)
        st.edges[(j, i)] = Edge(T.inv(), T.inv())
        st.edge_set.add((i, j))
        st.kfs[i].neighbor_kfs.add(j)
        st.kfs[j].neighbor_kfs.add(i)
    for i in range(n - 1):
        add_edge(i, i + 1)
    add_edge(0, n - 1)
    add_edge(2, 7)
    return st


@needs_native
class TestNativeEmbedding:
    def test_matches_python(self):
        import copy
        st_a = chain_state()
        st_b = copy.deepcopy(st_a)
        order_a = _python_embedding(st_a, root_id=5)
        order_b = metric_embedding(st_b, root_id=5)  # native path
        # same reachable set and same poses (order can differ on exact ties,
        # which don't occur with random edges)
        assert [k for _, k in order_a] == [k for _, k in order_b]
        for k in st_a.kfs:
            np.testing.assert_allclose(st_b.kfs[k].T.R, st_a.kfs[k].T.R,
                                       atol=1e-12)
            np.testing.assert_allclose(st_b.kfs[k].T.t, st_a.kfs[k].T.t,
                                       atol=1e-12)
        # distances agree
        np.testing.assert_allclose([d for d, _ in order_a],
                                   [d for d, _ in order_b], atol=1e-12)

    def test_root_identity(self):
        st = chain_state()
        metric_embedding(st, root_id=3)
        np.testing.assert_allclose(st.kfs[3].T.R, np.eye(3), atol=1e-15)
        np.testing.assert_allclose(st.kfs[3].T.t, 0, atol=1e-15)
