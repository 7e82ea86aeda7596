"""Persistent XLA compilation cache.

The big device kernels (the batch-replay scan, the CG Schur solver) take
long to compile, and every new process compiles them again.  XLA can cache
compiled executables on disk, keyed by HLO + compile options; with the
cache enabled a process after the first loads them instead.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads that variable itself; this module then sets no other directory),
otherwise the fixed ``<checkout>/.jax_cache``.  The directory is part of
what makes a later process find the entries, so it is never derived from
a pid, a temp name or the time.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory enable_persistent_cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_persistent_cache() -> str:
    """Point JAX's compilation cache at cache_dir(); returns it."""
    import jax

    d = cache_dir()
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    # keep every kernel that takes >= 1 s to compile, however small
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return d
