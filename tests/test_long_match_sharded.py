"""Cross-device long-fingerprint matching (SURVEY §5): the time-axis ring
matcher and the hierarchical coarse->fine matcher must agree with the
single-device blockwise scan (match_long_padded) and the golden oracle.

Run on the 8-virtual-CPU mesh (conftest).  The ≥10k-subfingerprint case is
the VERDICT r1 acceptance criterion.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from lbaudiodetective.ops.match import (
    match_long_hierarchical, match_long_padded)
from lbaudiodetective.parallel.long_match import match_long_time_sharded

PAIRS = 128  # pair-plane width (default config: ceil(200/2) padded to 128)


def _random_fp(rng, n, density=0.45):
    pos = (rng.random((n, PAIRS)) < density).astype(np.uint8)
    neg = ((rng.random((n, PAIRS)) < density) & (pos == 0)).astype(np.uint8)
    return pos, neg


def _embed_query(rng, pos1, neg1, at, n2, flip=0.05):
    """Query = slice of fp1 at a known offset with a fraction of pairs flipped."""
    pos2 = pos1[at: at + n2].copy()
    neg2 = neg1[at: at + n2].copy()
    fl = rng.random((n2, PAIRS)) < flip
    pos2 = np.where(fl, neg2, pos2)
    neg2 = np.where(fl, pos1[at: at + n2], neg2)
    return pos2.astype(np.uint8), neg2.astype(np.uint8)


def _pad(a, rows):
    out = np.zeros((rows, a.shape[1]), np.uint8)
    out[: a.shape[0]] = a
    return out


@pytest.fixture(scope="module")
def mesh8():
    devs = np.array(jax.devices()[:8])
    return Mesh(devs, ("time",))


def _reference_score(pos1, neg1, n1, pos2, neg2, n2, chunk=512):
    s1p = -(-n1 // chunk) * chunk
    return float(match_long_padded(
        jnp.asarray(_pad(pos1, s1p)), jnp.asarray(_pad(neg1, s1p)),
        jnp.int32(n1), jnp.asarray(pos2), jnp.asarray(neg2), jnp.int32(n2),
        chunk=chunk))


def test_time_sharded_matches_blockwise_10k(mesh8):
    """VERDICT r1 criterion: sharded == match_long_padded for S1 >= 10k."""
    rng = np.random.default_rng(5)
    n1, n2, at = 10_240, 64, 7_391
    pos1, neg1 = _random_fp(rng, n1)
    pos2, neg2 = _embed_query(rng, pos1, neg1, at, n2)

    ref = _reference_score(pos1, neg1, n1, pos2, neg2, n2)
    got = match_long_time_sharded(pos1, neg1, n1, pos2, neg2, n2,
                                  mesh8, axis="time")
    assert abs(got - ref) < 1e-5, (got, ref)
    assert ref > 0.8  # the planted match dominates


def test_time_sharded_matches_oracle_small(mesh8):
    """Oracle chain on a size where the scalar oracle is affordable."""
    from lbaudiodetective.oracle.pipeline import oracle_match_fingerprints

    rng = np.random.default_rng(11)
    n1, n2, at = 1_200, 24, 831
    pos1, neg1 = _random_fp(rng, n1)
    pos2, neg2 = _embed_query(rng, pos1, neg1, at, n2)

    oracle = oracle_match_fingerprints((pos1, neg1), (pos2, neg2))
    sharded = match_long_time_sharded(pos1, neg1, n1, pos2, neg2, n2,
                                      mesh8, axis="time")
    blockwise = _reference_score(pos1, neg1, n1, pos2, neg2, n2, chunk=256)
    assert abs(sharded - oracle) < 1e-5
    assert abs(blockwise - oracle) < 1e-5


def test_time_sharded_ragged_counts(mesh8):
    """n1/n2 far from ring multiples; no planted match (chance regime)."""
    rng = np.random.default_rng(23)
    n1, n2 = 1_037, 29
    pos1, neg1 = _random_fp(rng, n1)
    pos2, neg2 = _random_fp(rng, n2)
    ref = _reference_score(pos1, neg1, n1, pos2, neg2, n2, chunk=128)
    got = match_long_time_sharded(pos1, neg1, n1, pos2, neg2, n2,
                                  mesh8, axis="time")
    assert abs(got - ref) < 1e-5


def test_hierarchical_exact_on_planted_match():
    """Coarse->fine equals the full scan when a genuine match exists."""
    rng = np.random.default_rng(7)
    n1, n2, at = 10_240, 64, 2_977
    pos1, neg1 = _random_fp(rng, n1)
    pos2, neg2 = _embed_query(rng, pos1, neg1, at, n2, flip=0.1)

    ref = _reference_score(pos1, neg1, n1, pos2, neg2, n2)
    got = float(match_long_hierarchical(
        jnp.asarray(pos1), jnp.asarray(neg1), jnp.int32(n1),
        jnp.asarray(pos2), jnp.asarray(neg2), jnp.int32(n2)))
    assert abs(got - ref) < 1e-5, (got, ref)
    assert ref > 0.7


def test_hierarchical_never_exceeds_full_scan():
    """On matchless data the refined max is a lower bound of the true max."""
    rng = np.random.default_rng(41)
    n1, n2 = 4_096, 48
    pos1, neg1 = _random_fp(rng, n1)
    pos2, neg2 = _random_fp(rng, n2)
    ref = _reference_score(pos1, neg1, n1, pos2, neg2, n2)
    got = float(match_long_hierarchical(
        jnp.asarray(pos1), jnp.asarray(neg1), jnp.int32(n1),
        jnp.asarray(pos2), jnp.asarray(neg2), jnp.int32(n2)))
    assert got <= ref + 1e-6
    assert got >= 0.9 * ref      # coarse top-k still lands near the max
