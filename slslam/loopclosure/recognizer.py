"""Place recognition: the glue the reference never released.

The reference's SLAM::place_recognized is stubbed (slam.cpp:1088-1104); its
commented body shows the intended contract: per keyframe, query a database
with the current observations and, on a hit, produce ``lc_kf_id`` (the
recognized old keyframe) and ``match_result`` (current feature id -> old
landmark id).  This module implements that contract on top of the voctree:

  1. query the vocabulary tree with the current keyframe's descriptors,
  2. run the Bayesian temporal filter and the consecutive-sequence
     acceptance test,
  3. on acceptance, match current descriptors against the recognized
     keyframe's stored descriptors (mutual nearest neighbor on the device,
     one batched dot-product), yielding match_result.

Each keyframe is inserted as a document after the quarantine window
(NUM_NON_CONSIDER_RECENT_FRAMES), so recent frames can never match.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .voctree import VocTree


@jax.jit
def _mutual_nn(desc_a, desc_b):
    """Mutual nearest-neighbor match scores: (A, D) x (B, D) -> dots,
    best_b_for_a, best_a_for_b.  Padded rows are zero vectors: their dots
    are 0, below any min_similarity gate, so they never match."""
    dots = desc_a @ desc_b.T
    return dots, jnp.argmax(dots, axis=1), jnp.argmax(dots, axis=0)


def _pad_bucket(a, buckets=(32, 64, 128, 256, 512, 1024)):
    n = len(a)
    for b in buckets:
        if n <= b:
            break
    out = np.zeros((b, a.shape[1]), a.dtype)
    out[:n] = a
    return out


class PlaceRecognizer:
    def __init__(self, tree: VocTree, min_matches: int = 8,
                 min_similarity: float = 0.8):
        self.tree = tree
        self.min_matches = min_matches
        self.min_similarity = min_similarity
        # doc index -> (kf_id, feature ids, descriptors)
        self.docs: List[Tuple[int, List[int], np.ndarray]] = []
        self._doc_of_kf: Dict[int, int] = {}
        # observability counters
        self.stats = {"queries": 0, "filter_hits": 0, "match_fails": 0,
                      "detections": 0}

    def query_and_insert(self, kf_id: int, feat_ids: List[int],
                         descriptors: np.ndarray
                         ) -> Optional[Tuple[int, Dict[int, int]]]:
        """Process one keyframe.  Returns (lc_kf_id, match_result) on a
        loop-closure detection, else None."""
        descriptors = np.asarray(descriptors, np.float32)

        hit = None
        if self.tree.doc_size > 0 and len(descriptors):
            self.stats["queries"] += 1
            _, likelihood = self.tree.query(descriptors)
            lc_prob = self.tree.update_posterior(likelihood)
            doc = self.tree.is_loop_closing(lc_prob)
            if doc is not None and 0 <= doc < len(self.docs):
                self.stats["filter_hits"] += 1
                hit = self._match(doc, feat_ids, descriptors)
                if hit is None:
                    self.stats["match_fails"] += 1
                else:
                    self.stats["detections"] += 1

        doc_idx = len(self.docs)
        self.docs.append((kf_id, list(feat_ids), descriptors))
        self._doc_of_kf[kf_id] = doc_idx
        self.tree.insert_doc(doc_idx, descriptors)
        return hit

    def _match(self, doc: int, feat_ids: List[int], descriptors: np.ndarray
               ) -> Optional[Tuple[int, Dict[int, int]]]:
        old_kf, old_ids, old_desc = self.docs[doc]
        if len(old_desc) == 0 or len(descriptors) == 0:
            return None
        # pad to capacity buckets: one jit compile per bucket pair, not one
        # per keyframe shape
        dots, a2b, b2a = _mutual_nn(jnp.asarray(_pad_bucket(descriptors)),
                                    jnp.asarray(_pad_bucket(old_desc)))
        dots = np.asarray(dots)
        a2b = np.asarray(a2b)
        b2a = np.asarray(b2a)

        match_result: Dict[int, int] = {}
        for a in range(len(descriptors)):
            b = a2b[a]
            if b < len(old_ids) and b2a[b] == a \
                    and dots[a, b] >= self.min_similarity:
                match_result[feat_ids[a]] = old_ids[b]
        if len(match_result) < self.min_matches:
            return None
        return old_kf, match_result
