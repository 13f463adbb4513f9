"""Multi-device sharding tests on the 8-device CPU mesh (SURVEY §4.4):
sharded results must be invariant vs single-device."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.ops.extract import extract_fingerprint_padded, required_padded_length
from lbaudiodetective.ops.match import match_one_vs_many_padded
from lbaudiodetective.oracle.pipeline import oracle_match_fingerprints
from lbaudiodetective.parallel import (
    extract_data_parallel, make_mesh, match_library_sharded, ring_all_pairs_scores)
from tests.test_match import random_fp


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return make_mesh(8)


@pytest.fixture(scope="module")
def small_config():
    return FingerprintConfig()


def test_mesh_shape(mesh):
    assert mesh.shape == {"data": 4, "library": 2}


def test_extract_data_parallel_invariance(mesh, small_config):
    cfg = small_config
    n_rows = cfg.rows_per_frame  # 1 subfingerprint per clip
    t_pad = required_padded_length(cfg, n_rows)
    rng = np.random.default_rng(20)
    audio = rng.standard_normal((8, t_pad)).astype(np.float32) * 0.1
    n_sub = np.ones(8, np.int32)
    pos_s, neg_s = extract_data_parallel(jnp.asarray(audio), jnp.asarray(n_sub),
                                         cfg, n_rows, mesh)
    pos_1, neg_1 = extract_fingerprint_padded(jnp.asarray(audio),
                                              jnp.asarray(n_sub), cfg, n_rows)
    np.testing.assert_array_equal(np.asarray(pos_s), np.asarray(pos_1))
    np.testing.assert_array_equal(np.asarray(neg_s), np.asarray(neg_1))


def _padded_library(rng, sizes, s_max=12, pairs=100):
    fps = [random_fp(rng, n, pairs) for n in sizes]
    pos = np.zeros((len(sizes), s_max, pairs), np.uint8)
    neg = np.zeros((len(sizes), s_max, pairs), np.uint8)
    for i, (p, n) in enumerate(fps):
        pos[i, :p.shape[0]] = p
        neg[i, :n.shape[0]] = n
    return fps, pos, neg, np.array(sizes, np.int32)


def test_match_library_sharded_invariance(mesh):
    rng = np.random.default_rng(21)
    sizes = [12, 3, 7, 9, 1, 12, 5, 8]  # L=8, divisible by library axis (2)
    fps, pos, neg, counts = _padded_library(rng, sizes)
    query = random_fp(rng, 6)
    qp = np.zeros((12, 100), np.uint8); qp[:6] = query[0]
    qn = np.zeros((12, 100), np.uint8); qn[:6] = query[1]

    sharded = np.asarray(match_library_sharded(
        jnp.asarray(qp), jnp.asarray(qn), jnp.int32(6),
        jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(counts), mesh))
    single = np.asarray(match_one_vs_many_padded(
        jnp.asarray(qp), jnp.asarray(qn), jnp.int32(6),
        jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(counts)))
    np.testing.assert_allclose(sharded, single, atol=1e-6)
    # And against the scalar oracle.
    for i, fp in enumerate(fps):
        expected = oracle_match_fingerprints(fp, query)
        np.testing.assert_allclose(sharded[i], expected, atol=1e-6)


def test_ring_all_pairs_matches_oracle(mesh):
    rng = np.random.default_rng(22)
    sizes = [4, 7, 2, 9, 5, 3, 8, 6]
    fps, pos, neg, counts = _padded_library(rng, sizes, s_max=9)
    scores = np.asarray(ring_all_pairs_scores(
        jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(counts), mesh))
    assert scores.shape == (8, 8)
    for i in range(8):
        for j in range(8):
            expected = oracle_match_fingerprints(fps[i], fps[j])
            np.testing.assert_allclose(scores[i, j], expected, atol=1e-6,
                                       err_msg=f"pair ({i},{j})")
    # Symmetry of the quirk-Q10 score under the longer/shorter swap.
    np.testing.assert_allclose(scores, scores.T, atol=1e-6)
