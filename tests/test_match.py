"""Matcher: matmul formulation vs the scalar oracle (quirks Q10/Q11)."""

import numpy as np

from lbaudiodetective.oracle.pipeline import (
    compare_subfingerprints, oracle_match_fingerprints)
from lbaudiodetective.ops.match import match_fingerprints, match_one_vs_many_padded


def random_fp(rng, n_sub, pairs=100, p_zero=0.2):
    cls = rng.choice(3, size=(n_sub, pairs), p=[p_zero, (1 - p_zero) / 2, (1 - p_zero) / 2])
    pos = (cls == 1).astype(np.uint8)
    neg = (cls == 2).astype(np.uint8)
    return pos, neg


def test_subfingerprint_similarity_cases():
    pos1 = np.array([1, 0, 0, 1], np.uint8)
    neg1 = np.array([0, 1, 0, 0], np.uint8)
    # identical -> 1.0 over 3 possible
    assert compare_subfingerprints(pos1, neg1, pos1, neg1, 4) == 1.0
    # fp2 differs on one possible pair -> 2/3
    pos2 = pos1.copy(); pos2[0] = 0
    np.testing.assert_allclose(
        compare_subfingerprints(pos1, neg1, pos2, neg1, 4), 2 / 3, rtol=1e-6)
    # fp1 all-zero -> nothing possible -> 0
    z = np.zeros(4, np.uint8)
    assert compare_subfingerprints(z, z, pos1, neg1, 4) == 0.0


def test_matmul_matcher_equals_oracle_random():
    rng = np.random.default_rng(7)
    for n1, n2 in [(10, 10), (20, 7), (5, 12), (1, 1), (48, 21)]:
        fp1 = random_fp(rng, n1)
        fp2 = random_fp(rng, n2)
        expected = oracle_match_fingerprints(fp1, fp2)
        got = match_fingerprints(fp1, fp2)
        np.testing.assert_allclose(got, expected, atol=1e-6)


def test_comparison_range_semantics():
    """Quirk Q11: range counts booleans; odd ranges round up to a full pair."""
    rng = np.random.default_rng(8)
    fp1 = random_fp(rng, 6)
    fp2 = random_fp(rng, 6)
    for rng_bools in (0, 50, 51, 200, 500):
        expected = oracle_match_fingerprints(fp1, fp2, rng_bools)
        got = match_fingerprints(fp1, fp2, rng_bools)
        np.testing.assert_allclose(got, expected, atol=1e-6, err_msg=f"range={rng_bools}")


def test_swap_symmetry():
    """The matcher swaps so fp1 is longer: score(a,b) == score(b,a)."""
    rng = np.random.default_rng(9)
    a = random_fp(rng, 15)
    b = random_fp(rng, 6)
    np.testing.assert_allclose(match_fingerprints(a, b), match_fingerprints(b, a), atol=1e-7)


def test_empty_fingerprint_scores_zero():
    rng = np.random.default_rng(10)
    a = random_fp(rng, 5)
    empty = (np.zeros((0, 100), np.uint8), np.zeros((0, 100), np.uint8))
    assert match_fingerprints(a, empty) == 0.0
    assert match_fingerprints(empty, a) == 0.0


def test_all_zero_subfingerprints_score_zero():
    z = (np.zeros((4, 100), np.uint8), np.zeros((4, 100), np.uint8))
    assert match_fingerprints(z, z) == 0.0


def test_one_vs_many_matches_pairwise():
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    s_max = 16
    query = random_fp(rng, 9)
    lib = [random_fp(rng, n) for n in (16, 3, 9, 12, 1)]

    def pad(fp, s):
        p = np.zeros((s, 100), np.uint8); n = np.zeros((s, 100), np.uint8)
        p[:fp[0].shape[0]] = fp[0]; n[:fp[1].shape[0]] = fp[1]
        return p, n

    qp, qn = pad(query, s_max)
    lp = np.stack([pad(f, s_max)[0] for f in lib])
    ln = np.stack([pad(f, s_max)[1] for f in lib])
    counts = np.array([f[0].shape[0] for f in lib], np.int32)
    scores = np.asarray(match_one_vs_many_padded(
        jnp.asarray(qp), jnp.asarray(qn), jnp.int32(9),
        jnp.asarray(lp), jnp.asarray(ln), jnp.asarray(counts)))
    for i, f in enumerate(lib):
        expected = oracle_match_fingerprints(f, query)
        np.testing.assert_allclose(scores[i], expected, atol=1e-6)
