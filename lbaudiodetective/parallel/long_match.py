"""Cross-device long-fingerprint matching (SURVEY §5 long-context axis).

The reference pays O(n1·n2) serially in the offset slide
(LBAudioDetectiveFingerprint.m:136-146) and never meets a long fingerprint
(a 9 s clip is ~48 subfingerprints).  For hours-long audio the similarity
work is a large matmul and the longer side's time axis must scale across the
mesh:

- :func:`match_long_time_sharded` shards fp1's time axis over a mesh axis;
  the query's blocks rotate around the ring via ``lax.ppermute``
  (ring-attention style).  Each step matches the resident fp1 block against
  the visiting query block and accumulates its banded-diagonal sums into a
  local offset window; windows combine with one small ``psum``.  No device
  ever holds more than ``S1/n + S2/n`` rows, and traffic rides the ICI ring.
- :func:`match_long_hierarchical` (single device, in ops.match) is the
  coarse->fine complement for when the problem fits one chip but the full
  column matmul is too expensive.

Both reproduce the exact reference score semantics (quirk Q10/Q11); the
sharded matcher is bit-identical to ops.match.match_long_padded (float32
banded sums, same contraction) and validated against it and the oracle on
the CPU mesh in tests/test_long_match_sharded.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lbaudiodetective.ops.match import _pair_mask


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    out = np.zeros((rows, a.shape[1]), dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def match_long_time_sharded(pos1, neg1, n1, pos2, neg2, n2, mesh: Mesh,
                            axis: str = "data",
                            comparison_range: int = 0,
                            subfingerprint_length: int = 200) -> float:
    """One-vs-one long match with fp1's TIME axis sharded over ``axis``.

    pos1/neg1: ``[S1, pairs]`` uint8 planes of the LONGER fingerprint (the
    caller swaps, as in match_long_padded); pos2/neg2: ``[S2, pairs]``;
    n1/n2: valid counts.  Host wrapper pads S1/S2 to ring multiples, lays the
    shards out, and returns the scalar score.

    Device d holds fp1 rows [d*C, (d+1)*C) and initially query block d; at
    ring step s it matches its resident rows against the block that started
    on device (d-s) mod n, then passes the block along.  Column i of a block
    with global row base g0 contributes sim[r, i] to offset o = g0 + r - i;
    every step lands in a [C + S2]-wide local window (static roll-shifts per
    local column + one dynamic window add per step), and the windows overlap-
    add into the global offset accumulator via psum.
    """
    n_ring = mesh.shape[axis]
    s1_raw, pairs = pos1.shape
    s2_raw = pos2.shape[0]
    if s2_raw == 0 or s1_raw == 0:
        return 0.0
    if s1_raw < s2_raw:
        raise ValueError("fp1 must be the longer side (caller swaps)")

    # Pad so both time axes divide the ring.
    c = -(-s1_raw // n_ring)            # rows per device
    c = max(c, 1)
    s1p = c * n_ring
    qb = max(-(-s2_raw // n_ring), 1)   # query block rows
    s2p = qb * n_ring

    pos1p, neg1p = _pad_rows(np.asarray(pos1), s1p), _pad_rows(np.asarray(neg1), s1p)
    pos2p, neg2p = _pad_rows(np.asarray(pos2), s2p), _pad_rows(np.asarray(neg2), s2p)

    score = _match_long_ring(
        jax.device_put(pos1p, NamedSharding(mesh, P(axis, None))),
        jax.device_put(neg1p, NamedSharding(mesh, P(axis, None))),
        jnp.int32(n1),
        jax.device_put(pos2p, NamedSharding(mesh, P(axis, None))),
        jax.device_put(neg2p, NamedSharding(mesh, P(axis, None))),
        jnp.int32(n2),
        mesh=mesh, axis=axis, comparison_range=comparison_range,
        subfingerprint_length=subfingerprint_length)
    return float(score[0])


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "axis", "comparison_range", "subfingerprint_length"))
def _match_long_ring(pos1, neg1, n1, pos2, neg2, n2, *, mesh, axis,
                     comparison_range, subfingerprint_length):
    n_ring = mesh.shape[axis]
    s1p, pairs = pos1.shape
    s2p = pos2.shape[0]
    c = s1p // n_ring
    qb = s2p // n_ring
    mask = jnp.asarray(_pair_mask(pairs, comparison_range, subfingerprint_length))

    # Keep other mesh axes out of the specs: inputs replicate over them.
    spec2 = P(axis, None)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(spec2, spec2, P(), spec2, spec2, P()),
        out_specs=P(axis),
        check_vma=False,
    )
    def run(lp1, ln1, n1_, lp2, ln2, n2_):
        ring_idx = jax.lax.axis_index(axis)
        g0 = ring_idx * c
        mb = mask.astype(jnp.bfloat16)
        rp = lp1.astype(jnp.bfloat16) * mb           # resident fp1 block
        rn = ln1.astype(jnp.bfloat16) * mb
        w = jnp.sum((rp + rn).astype(jnp.float32), axis=-1)       # [C]
        # Rows at/after n1 are zero-padded (w=0 -> sim=0); no extra mask.
        inv_w = jnp.where(w > 0.0, 1.0 / jnp.maximum(w, 1.0), 0.0)

        perm = [(i, (i + 1) % n_ring) for i in range(n_ring)]
        acc = jnp.zeros((c + s2p,), jnp.float32)     # window anchor g0 - S2p
        vis_p, vis_n = lp2, ln2
        for step in range(n_ring):
            src = (ring_idx - step) % n_ring
            q0 = src * qb
            hits = (jnp.dot(rp, vis_p.astype(jnp.bfloat16).T,
                            preferred_element_type=jnp.float32)
                    + jnp.dot(rn, vis_n.astype(jnp.bfloat16).T,
                              preferred_element_type=jnp.float32))   # [C, Qb]
            sim = hits * inv_w[:, None]
            col_valid = (q0 + jnp.arange(qb)) < n2_
            sim = sim * col_valid[None, :].astype(jnp.float32)
            # Static roll-shifts into a block window, then one dynamic add.
            bl = jnp.zeros((c + qb - 1,), jnp.float32)
            for j in range(qb):
                bl = bl.at[qb - 1 - j: qb - 1 - j + c].add(sim[:, j])
            start = s2p - q0 - qb + 1
            acc = jax.lax.dynamic_update_slice(
                acc, jax.lax.dynamic_slice(acc, (start,), (c + qb - 1,)) + bl,
                (start,))
            if step + 1 < n_ring:
                vis_p = jax.lax.ppermute(vis_p, axis, perm)
                vis_n = jax.lax.ppermute(vis_n, axis, perm)

        # Overlap-add local windows into the global offset accumulator.
        d_global = jnp.zeros((s1p + s2p,), jnp.float32)      # index = o + S2p
        d_global = jax.lax.dynamic_update_slice(d_global, acc, (g0,))
        d_global = jax.lax.psum(d_global, axis)
        means = d_global[s2p:] / jnp.maximum(n2_, 1).astype(jnp.float32)
        o_valid = jnp.arange(s1p) <= (n1_ - n2_)
        means = jnp.where(o_valid, means, 0.0)
        score = jnp.where(n2_ > 0, jnp.max(means), 0.0)
        return score[None]

    return run(pos1, neg1, n1, pos2, neg2, n2)
