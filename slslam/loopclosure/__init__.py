"""Loop closure: vocabulary-tree place recognition + landmark matching.

Recreates the reference's (shipped-but-not-compiled) voctree backend
(/root/reference/src/voctree_bf.h) and the never-released
place_recognition.h glue: tree descent and descriptor matching run as
batched dot-product kernels on the device; the sparse inverted file and
the tiny Bayesian temporal filter stay on host.
"""

from .voctree import VocTree, build_vocabulary  # noqa: F401
from .recognizer import PlaceRecognizer  # noqa: F401
