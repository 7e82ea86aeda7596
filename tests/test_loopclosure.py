"""Tests for the vocabulary-tree place recognition and loop closure."""

import dataclasses

import numpy as np
import pytest

from slslam.loopclosure import PlaceRecognizer, VocTree, build_vocabulary
from slslam.loopclosure.voctree import (BRANCH_FACTOR, DESC_DIM,
                                        VocTreeParams)


def synth_descriptors(rng, n):
    d = rng.standard_normal((n, DESC_DIM)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def vocab():
    rng = np.random.default_rng(0)
    train = synth_descriptors(rng, 4000)
    return build_vocabulary(train, seed=0, kmeans_iters=3)


class TestVocTree:
    def test_build_shape_and_save_load(self, vocab, tmp_path):
        K = BRANCH_FACTOR
        assert vocab.shape == (1 + K + K * K, K, DESC_DIM)
        t = VocTree(vocab)
        p = str(tmp_path / "vocab.bin")
        t.save(p)
        t2 = VocTree.load(p)
        np.testing.assert_array_equal(np.asarray(t.centroids),
                                      np.asarray(t2.centroids))

    def test_descent_consistency(self, vocab):
        # find_leaves must agree with a brute-force greedy descent
        t = VocTree(vocab)
        rng = np.random.default_rng(1)
        feats = synth_descriptors(rng, 16)
        leaves = t.find_leaves(feats)
        K = BRANCH_FACTOR
        for f, leaf in zip(feats, leaves):
            idx = 0
            for _ in range(3):
                c = vocab[idx]
                best = int(np.argmax(c @ f))
                idx = idx * K + best + 1
            assert idx - t.num_int == leaf

    def test_quarantine(self, vocab):
        params = VocTreeParams(non_consider_recent=5)
        t = VocTree(vocab, params)
        rng = np.random.default_rng(2)
        inserted = []
        for i in range(8):
            out = t.insert_doc(i, synth_descriptors(rng, 30))
            if out is not None:
                inserted.append(out)
        # pushes 6,7,8 each flush the oldest queued doc
        assert inserted == [0, 1, 2]
        assert t.doc_size == 3

    def test_query_ranks_self_highest(self, vocab):
        params = VocTreeParams(non_consider_recent=2, num_avg_words=10)
        t = VocTree(vocab, params)
        rng = np.random.default_rng(3)
        docs = [synth_descriptors(rng, 40) for _ in range(8)]
        for i, d in enumerate(docs):
            t.insert_doc(i, d)
        # docs 0..5 are in the index now
        assert t.doc_size == 6
        noisy = docs[2] + rng.standard_normal(docs[2].shape) * 0.05
        noisy /= np.linalg.norm(noisy, axis=1, keepdims=True)
        score, likelihood = t.query(noisy.astype(np.float32))
        real = {k: v for k, v in score.items() if k >= 0}
        assert max(real, key=real.get) == 2
        assert likelihood.get(2, 0) > 1.0

    def test_bayes_filter_accepts_consistent_sequence(self, vocab):
        params = VocTreeParams(non_consider_recent=2, consider_seq_length=3,
                               threshold=0.5, num_avg_words=10)
        t = VocTree(vocab, params)
        rng = np.random.default_rng(4)
        docs = [synth_descriptors(rng, 40) for _ in range(30)]
        for i, d in enumerate(docs):
            t.insert_doc(i, d)
        t.doc_size  # 28 in index
        # simulate revisiting docs 5,6,7,8... repeatedly
        hit = None
        for k in range(6):
            q = docs[5 + k] + rng.standard_normal((40, DESC_DIM)) * 0.03
            q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(
                np.float32)
            _, lh = t.query(q)
            post = t.update_posterior(lh)
            hit = t.is_loop_closing(post)
            if hit is not None:
                break
        assert hit is not None
        assert 4 <= hit <= 10


class TestPlaceRecognizer:
    def test_detects_revisit_with_matches(self, vocab):
        params = VocTreeParams(non_consider_recent=3, consider_seq_length=3,
                               threshold=0.5, num_avg_words=10)
        rng = np.random.default_rng(5)
        # 20 distinct "places", 40 unique features each (real revisits look
        # like this: near-identical descriptors at the same place, unrelated
        # descriptors elsewhere)
        world = synth_descriptors(rng, 800)

        def frame(place, noise=0.01):
            ids = [place * 40 + k for k in range(40)]
            d = world[ids] + rng.standard_normal((40, DESC_DIM)) * noise
            d = d / np.linalg.norm(d, axis=1, keepdims=True)
            return ids, d.astype(np.float32)

        rec = PlaceRecognizer(VocTree(vocab, params), min_matches=8,
                              min_similarity=0.8)
        # first pass through all places
        for kf in range(20):
            ids, d = frame(kf)
            out = rec.query_and_insert(kf, ids, d)
        # revisit the start: same places again
        hits = []
        for k in range(10):
            ids, d = frame(k)
            out = rec.query_and_insert(100 + k, ids, d)
            if out is not None:
                hits.append((100 + k, out))
        assert hits, "revisit was not detected"
        _, (lc_kf, match_result) = hits[0]
        assert 0 <= lc_kf < 20
        assert len(match_result) >= 8
        # matches must be identity on world feature ids
        correct = sum(1 for a, b in match_result.items() if a == b)
        assert correct / len(match_result) > 0.9


class TestVocTreeScale:
    def test_500_docs_query_posterior_fast(self, vocab):
        """SURVEY §2 #16 / VERDICT r1 #7: inverted-file scoring and the
        Bayes recursion are jitted dense kernels — per-keyframe cost must
        stay flat in Python ops as the database grows.  500 documents:
        insert + query + posterior in bounded time, revisit still found."""
        import time

        params = VocTreeParams(non_consider_recent=5, consider_seq_length=3,
                               threshold=0.4, num_avg_words=20)
        t = VocTree(vocab, params)
        rng = np.random.default_rng(11)
        world = synth_descriptors(rng, 600 * 3)

        def doc(i, noise=0.02):
            d = world[(i * 3) % 1500:(i * 3) % 1500 + 40]
            d = d + rng.standard_normal(d.shape) * noise
            return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
                np.float32)

        for i in range(500):
            t.insert_doc(i, doc(i))
        assert t.doc_size >= 490

        # warm the jit caches, then time 20 query+posterior rounds
        _, lh = t.query(doc(3))
        t.update_posterior(lh)
        t0 = time.perf_counter()
        hit = None
        for k in range(20):
            q = doc(3 + k)
            _, lh = t.query(q)
            post = t.update_posterior(lh)
            hit = hit or t.is_loop_closing(post)
        dt = (time.perf_counter() - t0) / 20
        # dict-based round 1 took ~1 s/query at 1/10 this scale; the dense
        # path must stay well under 100 ms/query at 500 docs on CPU
        assert dt < 0.1, f"{dt*1e3:.1f} ms per query+posterior"
        assert hit is not None  # the revisit sequence is detected
