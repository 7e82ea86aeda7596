"""Whole-sequence place recognition as ONE device dispatch.

The online recognizer (recognizer.py / voctree.py) makes three jitted
calls per keyframe (descent, scoring, posterior) — correct for the causal
engine, but each call pays a dispatch and a fetch.  The batch engine knows
every keyframe's descriptors after the replay scan, so the entire
recognition timeline — quantization, per-step tf-idf scoring against the
documents inserted *so far*, the quarantine schedule, the Bayesian filter
recursion, and the consecutive-sequence acceptance test — runs as one
``lax.scan`` over keyframes in a single kernel.

Semantics are the online path's exactly (voctree_bf.h via voctree.py):

* document j enters the index at the END of step j + non_consider_recent,
  so the query at step k sees doc_size = max(0, k - ncr)  (the quarantine
  queue, voctree_bf.h:199-244);
* scoring: the tf-idf L1 similarity reduces to
  ``2 * idf(leaf) * min(n_query, w_doc)`` per shared leaf
  (|a-b| - a - b = -2 min(a,b)), with the virtual average document over
  the top-num_avg_words populated leaves and the mean fill-in for
  untouched documents (voctree_bf.h:381-558);
* likelihood, Gaussian-transition posterior, and the windowed acceptance
  test follow voctree.py's jitted kernels verbatim (:517-748).

Host-side work is one pass to build dense (K, U) query/document weight
tables over the compact universe U of observed leaves.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .voctree import (_GAUSS_REACH, DESC_DIM, VocTree, VocTreeParams,
                      _bucket, _descend)


def _quantize_all(tree: VocTree, kf_descs: List[np.ndarray]) -> List[np.ndarray]:
    """Leaf indices for every keyframe's descriptors — one device call."""
    sizes = [len(d) for d in kf_descs]
    total = sum(sizes)
    if total == 0:
        return [np.zeros(0, np.int32) for _ in kf_descs]
    Fb = _bucket(total, buckets=(256, 1024, 4096, 16384, 65536, 262144))
    flat = np.zeros((Fb, DESC_DIM), np.float32)
    off = 0
    for d in kf_descs:
        if len(d):
            flat[off:off + len(d)] = np.asarray(d, np.float32)[:, :DESC_DIM]
            off += len(d)
    valid = np.zeros(Fb, bool)
    valid[:total] = True
    idx = np.asarray(_descend(tree.centroids, jnp.asarray(flat),
                              jnp.asarray(valid)))[:total] - tree.num_int
    out, off = [], 0
    for n in sizes:
        out.append(idx[off:off + n].astype(np.int32))
        off += n
    return out


def recognize_sequence(tree: VocTree, kf_descs: List[np.ndarray]
                       ) -> np.ndarray:
    """Run the full recognition timeline; returns (K,) hit doc per step
    (-1 = no loop-closure candidate), identical to feeding the online
    VocTree query/update_posterior/is_loop_closing/insert_doc cycle.

    Layout: each keyframe's bag-of-words is SPARSE — (K, Q) padded unique
    leaf ids + tf weights, Q = the max unique-leaf count of any keyframe
    (r2 built dense (K, U) tables over the observed-leaf universe; at city
    scale U approaches the vocabulary's leaf count and per-step scoring
    cost O(K*U) — the sparse form is O(K*Q^2) with Q ~ features/frame,
    independent of vocabulary size, and bounds table memory by K*Q).
    Only the leaf-population vector for idf stays dense over U.
    """
    p = tree.params
    K = len(kf_descs)
    if K == 0:
        return np.zeros(0, np.int32)

    leaves = _quantize_all(tree, kf_descs)

    # compact universe of observed leaves (population counts / top-A only)
    all_leaves = np.concatenate([l for l in leaves]) if any(
        len(l) for l in leaves) else np.zeros(0, np.int32)
    uni = np.unique(all_leaves)
    U = max(len(uni), 1)
    remap = {int(v): i for i, v in enumerate(uni)}

    rows = []
    featcnt = np.zeros(K, np.int32)
    for k, l in enumerate(leaves):
        featcnt[k] = len(l)
        if len(l) == 0:
            rows.append((np.zeros(0, np.int64), np.zeros(0, np.float32)))
            continue
        u, c = np.unique(l, return_counts=True)
        cols = np.array([remap[int(x)] for x in u], np.int64)
        rows.append((cols, (c / float(len(l))).astype(np.float32)))
    Q = _bucket(max((len(r[0]) for r in rows), default=1) or 1,
                buckets=(8, 16, 32, 64, 128, 256, 512, 1024))
    bw_id = np.full((K, Q), -1, np.int32)    # compact leaf id, -1 = pad
    bw_w = np.zeros((K, Q), np.float32)      # tf weight (count / featcnt)
    for k, (cols, w) in enumerate(rows):
        bw_id[k, :len(cols)] = cols
        bw_w[k, :len(cols)] = w

    ncr = p.non_consider_recent
    A = p.num_avg_words
    w_len = p.consider_seq_length + 1
    s = p.sigma
    d = np.abs(np.arange(-(_GAUSS_REACH - 1), _GAUSS_REACH))
    gauss = jnp.asarray(1.0 / math.sqrt(2 * math.pi * s * s)
                        * np.exp(-(d * d) / (2 * s * s)), jnp.float32)

    hits = _recognition_scan(jnp.asarray(bw_id), jnp.asarray(bw_w),
                             jnp.asarray(featcnt), gauss, U=U, ncr=ncr,
                             A=A, w_len=w_len,
                             threshold=float(p.threshold))
    return np.asarray(hits, np.int32)


@functools.partial(jax.jit,
                   static_argnames=("U", "ncr", "A", "w_len", "threshold"))
def _recognition_scan(IdJ, WJ, fcJ, gauss, U, ncr, A, w_len, threshold):
    """The jitted whole-timeline scan (cached globally by shapes +
    static params — an unjitted lax.scan re-traced per call, even with
    identical shapes)."""
    K = IdJ.shape[0]
    karr = jnp.arange(K, dtype=jnp.int32)

    def step(carry, k):
        pop, post = carry                     # (U,) f32, (K+1,) f32
        doc_size = jnp.maximum(k - ncr, 0)
        qid = IdJ[k]                          # (Q,) compact ids, -1 pad
        nq = WJ[k]                            # (Q,)
        q_has = qid >= 0

        # --- virtual average document over the top-A populated leaves ---
        n_pop = jnp.sum((pop > 0).astype(jnp.int32))
        have_avg = n_pop > A
        topv, topi = jax.lax.top_k(pop, A)
        in_avg_u = jnp.zeros(U, bool).at[topi].set(topv > 0)
        in_avg = jnp.logical_and(in_avg_u[jnp.maximum(qid, 0)], q_has)
        in_avg = jnp.logical_and(in_avg, have_avg)

        # --- idf over the query's leaves (avg doc counts as a member) ---
        pop_q = jnp.where(q_has, pop[jnp.maximum(qid, 0)], 0.0)
        n_docs_leaf = pop_q + in_avg.astype(jnp.float32)
        has_docs = jnp.logical_and(q_has, n_docs_leaf > 0)
        n_total = (doc_size + have_avg.astype(jnp.int32)).astype(jnp.float32)
        idf = jnp.log10(n_total / jnp.maximum(n_docs_leaf, 1.0))
        idf = jnp.where(has_docs, idf, 0.0)
        n_idf = nq * idf                      # (Q,)

        # --- score every inserted document: 2*idf*min(n, w) per shared
        # leaf, matched by id equality over the sparse rows (K, Q, Q) ---
        doc_valid = karr < doc_size           # (K,)
        eq = jnp.logical_and(IdJ[:, :, None] == qid[None, None, :],
                             qid[None, None, :] >= 0)          # (K,Q,Qq)
        touched_pair = jnp.logical_and(eq, has_docs[None, None, :])
        contrib = 2.0 * idf[None, None, :] * jnp.minimum(
            nq[None, None, :], WJ[:, :, None])
        scores = jnp.sum(jnp.where(touched_pair, contrib, 0.0),
                         axis=(1, 2))
        scores = scores * doc_valid.astype(jnp.float32)
        hit = jnp.logical_and(jnp.any(touched_pair, axis=(1, 2)),
                              doc_valid)

        # --- the average document's own score ---
        m_a = (1.0 / A) * idf
        touched_a = jnp.logical_and(has_docs, in_avg)
        l1_a = jnp.where(touched_a,
                         -(jnp.abs(n_idf - m_a) - n_idf - m_a), 0.0)
        avg_score = jnp.sum(l1_a) * have_avg.astype(jnp.float32)
        avg_hit = jnp.logical_and(have_avg, jnp.any(touched_a))

        # --- mean fill-in for untouched docs (voctree.py:_score_query) ---
        total = jnp.sum(scores) + avg_score
        n_hit = (1 + jnp.sum(hit.astype(jnp.int32))
                 + avg_hit.astype(jnp.int32)).astype(jnp.float32)
        mean_fill = total / n_hit
        scores = jnp.where(jnp.logical_and(doc_valid, ~hit), mean_fill,
                           scores)
        avg_score = jnp.where(jnp.logical_and(have_avg, ~avg_hit),
                              mean_fill, avg_score)

        # --- likelihood transform (:517-534) ---
        nd = jnp.maximum(doc_size.astype(jnp.float32)
                         + have_avg.astype(jnp.float32), 1.0)
        s_sum = jnp.sum(jnp.where(doc_valid, scores, 0.0)) \
            + jnp.where(have_avg, avg_score, 0.0)
        s_sq = jnp.sum(jnp.where(doc_valid, scores * scores, 0.0)) \
            + jnp.where(have_avg, avg_score * avg_score, 0.0)
        mean = s_sum / nd
        std = jnp.sqrt(jnp.maximum(s_sq / nd - mean * mean, 0.0))

        def lhood(x):
            take = jnp.logical_and(x > mean + 2.0 * std, mean != 0.0)
            return jnp.where(take, (x - 2.0 * std) / mean, 1.0)

        lh = jnp.where(doc_valid, lhood(scores), 1.0)
        lh_avg = lhood(avg_score)

        # --- posterior recursion (voctree.py:_posterior_update) ---
        nf = jnp.maximum(doc_size.astype(jnp.float32), 1.0)
        p_no = post[0]
        p_docs = post[1:] * doc_valid.astype(jnp.float32)
        bel_no = 0.9 * p_no + 0.1 * jnp.sum(p_docs)
        conv = jnp.convolve(p_docs, gauss, mode="same")
        bel = p_no * (0.1 / nf) + conv
        new_post = jnp.concatenate([(lh_avg * bel_no)[None], lh * bel])
        mask = jnp.concatenate([jnp.ones(1, bool), doc_valid])
        new_post = new_post * mask.astype(jnp.float32)
        eta = jnp.sum(new_post)
        nstates = 1.0 + doc_size.astype(jnp.float32)
        uniform = mask.astype(jnp.float32) / nstates
        new_post = jnp.where(eta > 0, new_post / jnp.maximum(eta, 1e-30),
                             uniform)

        # skip the whole update when the online path would not query
        do = jnp.logical_and(doc_size > 0, fcJ[k] > 0)
        new_post = jnp.where(do, new_post, post)

        # --- acceptance (voctree.py:is_loop_closing) ---
        probs = new_post[1:]
        csum = jnp.concatenate([jnp.zeros(1, jnp.float32),
                                jnp.cumsum(probs)])
        window = csum[w_len:] - csum[:-w_len]          # (K - w_len + 1,)
        widx = jnp.arange(window.shape[0], dtype=jnp.int32)
        w_ok = (widx + w_len) <= doc_size              # window inside docs
        window = jnp.where(w_ok, window, -jnp.inf)
        best = jnp.argmax(window).astype(jnp.int32)
        seg = jax.lax.dynamic_slice(probs, (best,), (w_len,))
        cand = best + jnp.argmax(seg).astype(jnp.int32)
        ok = jnp.logical_and(
            jnp.logical_and(do, doc_size >= ncr),
            jnp.logical_and(doc_size >= w_len,
                            jnp.max(window) >= threshold))
        hit_doc = jnp.where(ok, cand, -1)

        # --- end-of-step insertion of doc (k - ncr): scatter the doc's
        # unique leaves into the population vector (pads id=-1 add 0) ---
        ins = k - ncr
        ins_c = jnp.maximum(ins, 0)
        do_ins = jnp.logical_and(ins >= 0, fcJ[ins_c] > 0)
        iid = IdJ[ins_c]                      # (Q,)
        inc = jnp.logical_and(iid >= 0, do_ins).astype(jnp.float32)
        pop = pop.at[jnp.maximum(iid, 0)].add(inc)

        return (pop, new_post), hit_doc

    pop0 = jnp.zeros(U, jnp.float32)
    post0 = jnp.zeros(K + 1, jnp.float32)   # the reference's empty prior
    (_, _), hits = jax.lax.scan(step, (pop0, post0), karr)
    return hits


@functools.lru_cache(maxsize=None)
def _mutual_nn_batch():
    def one(da, db):
        dots = da @ db.T
        return dots, jnp.argmax(dots, axis=1), jnp.argmax(dots, axis=0)
    return jax.jit(jax.vmap(one))


class BatchPlaceRecognizer:
    """Drop-in for PlaceRecognizer on the replay path: the recognition
    timeline runs as one scan, and ALL per-hit mutual-NN descriptor
    matches run as one batched dot-product dispatch instead of one device
    call per hit."""

    def __init__(self, tree: VocTree, min_matches: int = 8,
                 min_similarity: float = 0.8):
        from .recognizer import PlaceRecognizer
        self._online = PlaceRecognizer(tree, min_matches, min_similarity)
        self.tree = tree
        self.stats = self._online.stats

    def recognize_all(self, kf_ids: List[int],
                      feat_ids_list: List[List[int]],
                      descs: List[np.ndarray]
                      ) -> List[Optional[Tuple[int, dict]]]:
        hits = recognize_sequence(self.tree, descs)
        self._online.docs = [(kf, list(f), np.asarray(d, np.float32))
                             for kf, f, d in zip(kf_ids, feat_ids_list,
                                                 descs)]
        out: List[Optional[Tuple[int, dict]]] = [None] * len(kf_ids)
        pairs = [(k, int(h)) for k, h in enumerate(hits)
                 if 0 <= int(h) < len(kf_ids)
                 and len(descs[k]) and len(descs[int(h)])]
        for k, h in enumerate(hits):
            # empty-descriptor hits keep the online path's stats exactly
            if 0 <= int(h) < len(kf_ids) and (k, int(h)) not in pairs:
                self.stats["queries"] += 1
                self.stats["filter_hits"] += 1
                self.stats["match_fails"] += 1
        if not pairs:
            return out

        H = len(pairs)
        Hb = _bucket(H, buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
        A = _bucket(max(len(descs[k]) for k, _ in pairs),
                    buckets=(32, 64, 128, 256, 512, 1024))
        B = _bucket(max(len(descs[h]) for _, h in pairs),
                    buckets=(32, 64, 128, 256, 512, 1024))
        da = np.zeros((Hb, A, DESC_DIM), np.float32)
        db = np.zeros((Hb, B, DESC_DIM), np.float32)
        for i, (k, h) in enumerate(pairs):
            da[i, :len(descs[k])] = np.asarray(descs[k],
                                               np.float32)[:, :DESC_DIM]
            db[i, :len(descs[h])] = np.asarray(descs[h],
                                               np.float32)[:, :DESC_DIM]
        dots, a2b, b2a = jax.device_get(_mutual_nn_batch()(
            jnp.asarray(da), jnp.asarray(db)))

        min_sim = self._online.min_similarity
        for i, (k, h) in enumerate(pairs):
            self.stats["queries"] += 1
            self.stats["filter_hits"] += 1
            old_kf, old_ids, _ = self._online.docs[h]
            fi = feat_ids_list[k]
            match_result = {}
            for a in range(len(descs[k])):
                b = int(a2b[i, a])
                if b < len(old_ids) and int(b2a[i, b]) == a \
                        and dots[i, a, b] >= min_sim:
                    match_result[fi[a]] = old_ids[b]
            if len(match_result) < self._online.min_matches:
                self.stats["match_fails"] += 1
            else:
                self.stats["detections"] += 1
                out[k] = (old_kf, match_result)
        return out
