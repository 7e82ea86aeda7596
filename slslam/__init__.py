"""slslam: a stereo line-SLAM framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of cleinc/slslam
(the reference implementation): stereo line-track replay or live
line front-end, Plücker-line triangulation, RANSAC line visual odometry,
windowed local bundle adjustment with the orthonormal 4-DoF line
parameterization (Schur complement, Levenberg–Marquardt), loop closure with
vocabulary-tree place recognition, and pose-graph optimization — with the hot
math running as batched jitted kernels and scaling over a `jax.sharding.Mesh`.
"""

__version__ = "0.1.0"

import jax as _jax

# The solvers form and factor normal equations in float32 on a GPU, where a
# float32 dot defaults to TF32 (a 10-bit mantissa) — too coarse for their
# conditioning.  Set full-precision dots once, here, because every entry
# point (engines, global_refine, the ops called directly) imports this
# package first; a setting made later would miss kernels already traced.
_jax.config.update("jax_default_matmul_precision", "highest")

from .config import CameraConfig, SequenceConfig, SlamConfig  # noqa: F401
