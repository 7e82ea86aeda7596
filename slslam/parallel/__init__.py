"""Distributed execution over a jax.sharding.Mesh.

The reference is single-process single-thread (SURVEY.md §2 #26); this
subsystem is new capability: line-sharded distributed bundle adjustment
(per-LM-iteration collective volume independent of map size) and
edge-sharded distributed pose-graph optimization, with XLA collectives
(psum, handed to NCCL on GPUs) as the communication backend.
"""

from .dist_ba import (dist_local_ba_lines,  # noqa: F401
                      make_mesh, partition_by_line)
from .dist_pgo import dist_pose_graph_opt  # noqa: F401
