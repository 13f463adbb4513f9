"""Pod-scale ring dedup: top-k candidates match a brute-force oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from lbaudiodetective.oracle.pipeline import oracle_match_fingerprints
from lbaudiodetective.parallel.dedup import ring_dedup_topk
from lbaudiodetective.parallel.mesh import make_mesh
from tests.test_match import random_fp


def test_ring_dedup_topk_matches_bruteforce():
    mesh = make_mesh(8)
    rng = np.random.default_rng(60)
    l, s_max, k = 16, 6, 3
    sizes = rng.integers(2, s_max + 1, size=l)
    fps = [random_fp(rng, int(n)) for n in sizes]
    pos = np.zeros((l, s_max, 100), np.uint8)
    neg = np.zeros((l, s_max, 100), np.uint8)
    for i, (p, n) in enumerate(fps):
        pos[i, :p.shape[0]] = p
        neg[i, :n.shape[0]] = n
    counts = np.asarray(sizes, np.int32)

    scores, idx = ring_dedup_topk(jnp.asarray(pos), jnp.asarray(neg),
                                  jnp.asarray(counts), mesh, k=k)
    scores, idx = np.asarray(scores), np.asarray(idx)
    assert scores.shape == (l, k) and idx.shape == (l, k)

    # Brute force with the scalar oracle.
    full = np.zeros((l, l))
    for i in range(l):
        for j in range(l):
            full[i, j] = oracle_match_fingerprints(fps[i], fps[j]) if i != j else -np.inf
    for i in range(l):
        order = np.argsort(-full[i], kind="stable")[:k]
        np.testing.assert_allclose(np.sort(scores[i])[::-1],
                                   np.sort(full[i][order])[::-1], atol=1e-6)
        # The returned indices must achieve the same scores.
        for slot in range(k):
            np.testing.assert_allclose(full[i][idx[i, slot]], scores[i, slot],
                                       atol=1e-6)
