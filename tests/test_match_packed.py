"""Packed popcount matcher == unpacked matmul matcher == oracle."""

import numpy as np
import jax.numpy as jnp

from lbaudiodetective.ops.match import match_one_vs_many_padded
from lbaudiodetective.ops.match_packed import (
    match_one_vs_many_packed, pack_bits_device)
from lbaudiodetective.oracle.pipeline import oracle_match_fingerprints
from lbaudiodetective.utils import packing
from tests.test_match import random_fp


def test_device_packing_matches_host():
    rng = np.random.default_rng(96)
    plane = rng.integers(0, 2, size=(5, 100)).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(pack_bits_device(jnp.asarray(plane))),
                                  packing.pack_bits(plane))


def test_packed_matcher_equals_unpacked():
    rng = np.random.default_rng(97)
    l, s, pairs = 12, 16, 100
    sizes = rng.integers(2, s + 1, size=l).astype(np.int32)
    lib = [random_fp(rng, int(n)) for n in sizes]
    lib_pos = np.zeros((l, s, pairs), np.uint8)
    lib_neg = np.zeros((l, s, pairs), np.uint8)
    for i, (p, n) in enumerate(lib):
        lib_pos[i, :p.shape[0]] = p
        lib_neg[i, :n.shape[0]] = n
    q = random_fp(rng, 7)
    qp = np.zeros((s, pairs), np.uint8); qp[:7] = q[0]
    qn = np.zeros((s, pairs), np.uint8); qn[:7] = q[1]

    for rng_bools in (0, 77):
        unpacked = np.asarray(match_one_vs_many_padded(
            jnp.asarray(qp), jnp.asarray(qn), jnp.int32(7),
            jnp.asarray(lib_pos), jnp.asarray(lib_neg), jnp.asarray(sizes),
            rng_bools, 200))
        packed = np.asarray(match_one_vs_many_packed(
            pack_bits_device(jnp.asarray(qp)), pack_bits_device(jnp.asarray(qn)),
            jnp.int32(7),
            pack_bits_device(jnp.asarray(lib_pos)),
            pack_bits_device(jnp.asarray(lib_neg)),
            jnp.asarray(sizes), pairs, rng_bools, 200))
        np.testing.assert_allclose(packed, unpacked, atol=1e-6)
        # Against the scalar oracle too (same comparison range).
        for i, fp in enumerate(lib):
            np.testing.assert_allclose(
                packed[i], oracle_match_fingerprints(fp, q, rng_bools),
                atol=1e-6)
