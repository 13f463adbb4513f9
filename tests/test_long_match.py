"""Blockwise long-fingerprint matcher vs the dense matcher and oracle."""

import numpy as np
import jax.numpy as jnp

from lbaudiodetective.ops.match import match_fingerprints, match_long_padded
from lbaudiodetective.oracle.pipeline import oracle_match_fingerprints
from tests.test_match import random_fp


def test_long_matches_dense():
    rng = np.random.default_rng(91)
    n1, n2, chunk = 200, 17, 64
    fp1 = random_fp(rng, n1)
    fp2 = random_fp(rng, n2)
    s1 = ((n1 + chunk - 1) // chunk) * chunk
    p1 = np.zeros((s1, 100), np.uint8); p1[:n1] = fp1[0]
    q1 = np.zeros((s1, 100), np.uint8); q1[:n1] = fp1[1]
    p2 = np.zeros((32, 100), np.uint8); p2[:n2] = fp2[0]
    q2 = np.zeros((32, 100), np.uint8); q2[:n2] = fp2[1]
    got = float(match_long_padded(
        jnp.asarray(p1), jnp.asarray(q1), jnp.int32(n1),
        jnp.asarray(p2), jnp.asarray(q2), jnp.int32(n2), chunk=chunk))
    expected = oracle_match_fingerprints(fp1, fp2)
    np.testing.assert_allclose(got, expected, atol=1e-5)
    dense = match_fingerprints(fp1, fp2)
    np.testing.assert_allclose(got, dense, atol=1e-5)


def test_long_with_comparison_range():
    rng = np.random.default_rng(92)
    fp1 = random_fp(rng, 100)
    fp2 = random_fp(rng, 9)
    p1 = np.zeros((128, 100), np.uint8); p1[:100] = fp1[0]
    q1 = np.zeros((128, 100), np.uint8); q1[:100] = fp1[1]
    p2 = np.zeros((16, 100), np.uint8); p2[:9] = fp2[0]
    q2 = np.zeros((16, 100), np.uint8); q2[:9] = fp2[1]
    got = float(match_long_padded(
        jnp.asarray(p1), jnp.asarray(q1), jnp.int32(100),
        jnp.asarray(p2), jnp.asarray(q2), jnp.int32(9),
        comparison_range=51, chunk=64))
    expected = oracle_match_fingerprints(fp1, fp2, 51)
    np.testing.assert_allclose(got, expected, atol=1e-5)
