"""Metric embedding: re-root the relative map's pose field.

Port of SLAM::metric_embedding (/root/reference/src/slam.cpp:1317-1366): a
best-first traversal from the root keyframe ordered by accumulated edge
translation norm; each reached keyframe's transient pose T is assigned by
composing the edge transform onto its parent's pose at insertion time.

This is a tiny host-side graph walk (O(V log V + E) on a few hundred nodes,
microseconds) — keeping it on host is the device-first choice: it sequences the
device kernels rather than competing with them.
"""

from __future__ import annotations

import heapq
from typing import List, Tuple

import numpy as np

from .. import native
from ..hostgeom import Pose
from .state import MapState


def metric_embedding(state: MapState, root_id: int) -> List[Tuple[float, int]]:
    """Assign kfs[k].T for every keyframe reachable from root_id.

    Returns the embedding order [(accumulated_distance, kf_id), ...] sorted
    by distance (the reference's me_map multimap).  Uses the native C++
    walker (native/slslam_native.cpp) when built; the pure-Python walk below
    is the reference implementation of the semantics.
    """
    if native.available() and len(state.kfs) > 2:
        out = _native_embedding(state, root_id)
        if out is not None:
            return out
    return _python_embedding(state, root_id)


def _native_embedding(state: MapState, root_id: int):
    n = max(state.kfs) + 1
    E = len(state.edges)
    ei = np.empty(E, np.int32)
    ej = np.empty(E, np.int32)
    eT = np.empty((E, 12), np.float64)
    for k, ((i, j), e) in enumerate(state.edges.items()):
        ei[k] = i
        ej[k] = j
        eT[k, :9] = e.T.R.reshape(-1)
        eT[k, 9:] = e.T.t
    res = native.metric_embedding(n, ei, ej, eT, root_id)
    if res is None:
        return None
    order, T_out, dist = res
    out = []
    for rank, kid in enumerate(order):
        kid = int(kid)
        kf = state.kfs.get(kid)
        if kf is None:
            continue
        kf.T = Pose(T_out[kid, :9].reshape(3, 3), T_out[kid, 9:])
        out.append((float(dist[rank]), kid))
    return out


def _python_embedding(state: MapState, root_id: int):
    state.kfs[root_id].T = Pose()
    heap: List[Tuple[float, int, int]] = [(0.0, 0, root_id)]
    embedded = {root_id}
    order: List[Tuple[float, int]] = []
    tiebreak = 0

    while heap:
        d, _, kid = heapq.heappop(heap)
        order.append((d, kid))
        kf = state.kfs[kid]
        T = kf.T

        for nb in sorted(kf.neighbor_kfs):
            if nb in embedded:
                continue
            edge = state.edges[(kid, nb)]
            new_T = edge.T
            new_d = float(pow(new_T.t @ new_T.t, 0.5))
            state.kfs[nb].T = new_T @ T
            embedded.add(nb)
            tiebreak += 1
            heapq.heappush(heap, (d + new_d, tiebreak, nb))

    return order
