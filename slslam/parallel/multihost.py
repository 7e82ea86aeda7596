"""Multi-host startup (single-program multi-host JAX).

The reference is single-process (SURVEY.md §2 #26); scaling past one host
uses jax.distributed: every host runs the same program, sees the global
device set, and the engine's mesh_devices option spans them.  The mesh
follows the algorithm (one line-shard axis), not the interconnect.

Usage (one command per host):

  python -m slslam.cli sim ... --multihost \\
      --coordinator host0:8476 --num-processes 4 --process-id $ID

or programmatically: initialize_multihost(...) before building the engine.
"""

from __future__ import annotations

from typing import Optional


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None):
    """jax.distributed.initialize with explicit or auto-detected topology.

    On clusters that JAX recognizes (e.g. SLURM) the arguments
    auto-detect from the environment; pass them explicitly elsewhere.  Must run before any other jax call.
    """
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def is_primary() -> bool:
    """True on the host that should write outputs / logs."""
    import jax
    return jax.process_index() == 0
