"""Fingerprint matching as matrix multiplication.

The reference's matcher is a triple scalar loop: offsets x subfingerprints x
bit-pairs (LBAudioDetectiveFingerprint.m:119-176).  The quirk-Q10 similarity
factorises exactly into two inner products: encoding each subfingerprint as
sign-class indicator planes P, N in {0,1}^pairs (never both set),

    possible(fp1_j)    = sum_i (P1[j,i] | N1[j,i]) = sum_i P1[j,i] + N1[j,i]
    hits(fp1_j, fp2_k) = sum_i P1[j,i]*P2[k,i] + N1[j,i]*N2[k,i]

because a pair scores a hit iff fp1's class is nonzero and fp2's class equals
it.  So the full [n1, n2] similarity matrix is two bf16 matmuls with f32
accumulation (exact: products are 0/1, sums <= pairs < 2^24), and the
offset-sliding score is a masked banded-diagonal mean + max.  One-vs-many
matching batches the library axis through the same contraction.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _pair_mask(pairs: int, comparison_range: int, subfingerprint_length: int) -> np.ndarray:
    """Quirk Q11: ``comparison_range`` caps *booleans* compared (0 -> all);
    pairs beyond ceil(min(range, length)/2) are excluded."""
    if comparison_range == 0:
        comparison_range = subfingerprint_length
    n_bools = min(comparison_range, subfingerprint_length)
    n_pairs = (n_bools + 1) // 2
    mask = np.zeros(pairs, dtype=np.float32)
    mask[:n_pairs] = 1.0
    return mask


def similarity_matrix(pos1: jnp.ndarray, neg1: jnp.ndarray,
                      pos2: jnp.ndarray, neg2: jnp.ndarray,
                      pair_mask: jnp.ndarray) -> jnp.ndarray:
    """``[..., n1, pairs] x [..., n2, pairs] -> [..., n1, n2]`` per-pair
    similarity (hits / possibleHits, 0 where nothing possible)."""
    m = pair_mask.astype(jnp.bfloat16)
    p1 = pos1.astype(jnp.bfloat16) * m
    n1 = neg1.astype(jnp.bfloat16) * m
    p2 = pos2.astype(jnp.bfloat16)
    n2 = neg2.astype(jnp.bfloat16)
    hits = (jnp.einsum("...ip,...jp->...ij", p1, p2, preferred_element_type=jnp.float32)
            + jnp.einsum("...ip,...jp->...ij", n1, n2, preferred_element_type=jnp.float32))
    possible = jnp.sum((p1 + n1).astype(jnp.float32), axis=-1)      # [..., n1]
    safe = jnp.maximum(possible, 1.0)
    sim = hits / safe[..., :, None]
    return jnp.where(possible[..., :, None] > 0.0, sim, 0.0)


def banded_diagonal_sums(sim: jnp.ndarray, n2: jnp.ndarray) -> jnp.ndarray:
    """``D[..., o] = sum_{i < n2} sim[..., o+i, i]`` for o in [0, S1).

    Gather-free: column i contributes ``sim[:, o+i, i]``, i.e. column i
    circularly shifted up by i — so D is a sum of S2 static rolls (vectorised
    shifts, no per-element gather).  Columns
    ``i >= n2`` are masked to zero first; circular wrap only touches offsets
    ``o > S1 - 1 - i``, which are invalid (o <= n1 - n2 < S1 - i for every
    contributing i < n2) and masked by the caller.
    """
    s2 = sim.shape[-1]
    i_idx = jnp.arange(s2)
    masked = sim * (i_idx < n2[..., None, None]).astype(sim.dtype)
    total = jnp.zeros(masked.shape[:-1], masked.dtype)
    for i in range(s2):
        total = total + jnp.roll(masked[..., i], -i, axis=-1)
    return total


def offset_scores(sim: jnp.ndarray, n1: jnp.ndarray, n2: jnp.ndarray) -> jnp.ndarray:
    """Offset-sliding max of banded-diagonal means.

    sim: ``[..., S1, S2]`` similarity matrix (padded entries must be zero).
    n1, n2: ``[...]`` int32 valid counts, with n1 >= n2 (caller swaps).
    Returns ``[...]`` float32 match scores, 0 when n2 == 0.

    Replicates LBAudioDetectiveFingerprint.m:133-148: for offset o in
    [0, n1-n2], score(o) = mean_{i<n2} sim[i+o, i]; result = max_o score(o).
    """
    s1 = sim.shape[-2]
    sums = banded_diagonal_sums(sim, n2)                    # [..., S1]
    n2f = jnp.maximum(n2, 1).astype(sim.dtype)
    means = sums / n2f[..., None]
    o_valid = jnp.arange(s1) <= (n1 - n2)[..., None]
    means = jnp.where(o_valid, means, 0.0)
    score = jnp.max(means, axis=-1)
    return jnp.where(n2 > 0, score, 0.0)


@partial(jax.jit, static_argnames=("comparison_range", "subfingerprint_length"))
def _match_padded(pos1, neg1, n1, pos2, neg2, n2,
                  comparison_range: int, subfingerprint_length: int):
    pairs = pos1.shape[-1]
    mask = jnp.asarray(_pair_mask(pairs, comparison_range, subfingerprint_length))
    # Swap so fp1 is the longer (LBAudioDetectiveFingerprint.m:123-131).
    swap = n1 < n2
    swap_b = swap.reshape(swap.shape + (1, 1))
    pos_l = jnp.where(swap_b, pos2, pos1)
    neg_l = jnp.where(swap_b, neg2, neg1)
    pos_s = jnp.where(swap_b, pos1, pos2)
    neg_s = jnp.where(swap_b, neg1, neg2)
    n_l = jnp.where(swap, n2, n1)
    n_s = jnp.where(swap, n1, n2)
    sim = similarity_matrix(pos_l, neg_l, pos_s, neg_s, mask)
    return offset_scores(sim, n_l, n_s)


def match_fingerprints(fp1: tuple[np.ndarray, np.ndarray],
                       fp2: tuple[np.ndarray, np.ndarray],
                       comparison_range: int = 0,
                       subfingerprint_length: int = 200) -> float:
    """One-vs-one match score between two (pos, neg) uint8 fingerprints."""
    from lbaudiodetective.ops.extract import bucket_subfingerprints

    (pos1, neg1), (pos2, neg2) = fp1, fp2
    n1, n2 = pos1.shape[0], pos2.shape[0]
    if n1 == 0 or n2 == 0:
        return 0.0
    s = bucket_subfingerprints(max(n1, n2))  # shared jit cache across lengths
    pairs = pos1.shape[1]

    def pad(a):
        out = np.zeros((s, pairs), dtype=np.uint8)
        out[:a.shape[0]] = a
        return jnp.asarray(out)

    score = _match_padded(pad(pos1), pad(neg1), jnp.int32(n1),
                          pad(pos2), pad(neg2), jnp.int32(n2),
                          comparison_range, subfingerprint_length)
    return float(score)


@partial(jax.jit, static_argnames=("comparison_range", "subfingerprint_length",
                                   "chunk"))
def match_long_padded(pos1, neg1, n1, pos2, neg2, n2,
                      comparison_range: int = 0,
                      subfingerprint_length: int = 200,
                      chunk: int = 512):
    """Long-context one-vs-one matcher: fp1 may be hours long.

    Never materialises the full [S1, S2] similarity matrix: fp1 is scanned in
    ``chunk``-row blocks (SURVEY §5 long-context axis); each block's
    similarity [chunk, S2] contributes its banded-diagonal sums to the global
    offset accumulator via the same roll-sum reduction.  fp1 must be the
    longer side (no swap here) and padded to a multiple of ``chunk``.
    """
    s1, pairs = pos1.shape
    s2 = pos2.shape[0]
    if s1 % chunk:
        raise ValueError("pos1 must be padded to a multiple of chunk")
    mask = jnp.asarray(_pair_mask(pairs, comparison_range, subfingerprint_length))
    mb = mask.astype(jnp.bfloat16)
    p2 = pos2.astype(jnp.bfloat16)
    q2 = neg2.astype(jnp.bfloat16)
    i_idx = jnp.arange(s2)
    i_mask = (i_idx < n2).astype(jnp.float32)

    n_blocks = s1 // chunk
    p1b = pos1.reshape(n_blocks, chunk, pairs)
    n1b = neg1.reshape(n_blocks, chunk, pairs)

    def block(carry, inp):
        d_acc = carry
        blk_idx, bp, bn = inp
        lp = bp.astype(jnp.bfloat16) * mb
        ln = bn.astype(jnp.bfloat16) * mb
        hits = (jnp.dot(lp, p2.T, preferred_element_type=jnp.float32)
                + jnp.dot(ln, q2.T, preferred_element_type=jnp.float32))
        w = jnp.sum((lp + ln).astype(jnp.float32), axis=-1)
        sim = jnp.where(w[:, None] > 0.0, hits / jnp.maximum(w, 1.0)[:, None], 0.0)
        sim = sim * i_mask[None, :]
        #

        # Block rows r correspond to global rows g = blk_idx*chunk + r; the
        # diagonal element (o+i == g) lands at offset o = g - i.  Column i of
        # this block therefore contributes to offsets [g0 - i, g0 - i + chunk)
        # — accumulate each rolled column into a (chunk + S2)-wide window and
        # scatter-add it at the block's base offset.
        local = jnp.zeros((chunk + s2,), jnp.float32)
        for i in range(s2):
            local = local.at[s2 - i:s2 - i + chunk].add(sim[:, i])
        start = blk_idx * chunk - s2
        padded_acc = jnp.pad(d_acc, (s2, s2))
        padded_acc = jax.lax.dynamic_update_slice(
            padded_acc,
            jax.lax.dynamic_slice(padded_acc, (start + s2,), (chunk + s2,)) + local,
            (start + s2,))
        return padded_acc[s2:-s2], None

    d0 = jnp.zeros((s1,), jnp.float32)
    d_final, _ = jax.lax.scan(
        block, d0, (jnp.arange(n_blocks), p1b, n1b))
    means = d_final / jnp.maximum(n2, 1).astype(jnp.float32)
    o_valid = jnp.arange(s1) <= (n1 - n2)
    means = jnp.where(o_valid, means, 0.0)
    return jnp.where(n2 > 0, jnp.max(means), 0.0)


@partial(jax.jit, static_argnames=(
    "comparison_range", "subfingerprint_length", "col_stride", "n_candidates",
    "refine_radius"))
def match_long_hierarchical(pos1, neg1, n1, pos2, neg2, n2,
                            comparison_range: int = 0,
                            subfingerprint_length: int = 200,
                            col_stride: int = 4,
                            n_candidates: int = 16,
                            refine_radius: int = 2):
    """Hierarchical coarse->fine long matcher (SURVEY §5).

    Coarse pass: estimate every offset's score from every ``col_stride``-th
    query subfingerprint — the expensive [S1, S2] similarity matmul shrinks
    by ``col_stride`` while the offset axis stays at full resolution (the
    true match peak is 1-2 offsets wide, so subsampling offsets would miss
    it; subsampling the mean's terms only adds noise ~sigma/sqrt(n2/stride)).
    Fine pass: exactly re-score the ``n_candidates`` best coarse offsets and
    their ±``refine_radius`` neighbourhoods with the full column set, and
    return the exact maximum over the refined set.

    Exact-equal to the full scan whenever the true argmax survives the
    coarse top-k (holds with wide margin for genuine matches; for
    guaranteed-exact scores on adversarial data use match_long_padded).
    fp1 must be the longer side, zero-padded; same contract as
    match_long_padded.  Reference semantics: Fingerprint.m:119-176.
    """
    s1, pairs = pos1.shape
    s2 = pos2.shape[0]
    mask = jnp.asarray(_pair_mask(pairs, comparison_range, subfingerprint_length))
    mb = mask.astype(jnp.bfloat16)
    p1 = pos1.astype(jnp.bfloat16) * mb
    q1 = neg1.astype(jnp.bfloat16) * mb
    w = jnp.sum((p1 + q1).astype(jnp.float32), axis=-1)              # [S1]
    inv_w = jnp.where(w > 0.0, 1.0 / jnp.maximum(w, 1.0), 0.0)

    # -- coarse: subsampled columns, all offsets -----------------------------
    cols = np.arange(0, s2, col_stride)
    cp = pos2[cols].astype(jnp.bfloat16)
    cq = neg2[cols].astype(jnp.bfloat16)
    hits_c = (jnp.dot(p1, cp.T, preferred_element_type=jnp.float32)
              + jnp.dot(q1, cq.T, preferred_element_type=jnp.float32))
    sim_c = hits_c * inv_w[:, None]                                  # [S1, Sc]
    col_valid = (jnp.asarray(cols) < n2).astype(jnp.float32)
    sim_c = sim_c * col_valid[None, :]
    d_c = jnp.zeros((s1,), jnp.float32)
    for j, i in enumerate(cols):
        d_c = d_c + jnp.roll(sim_c[:, j], -int(i))
    means_c = d_c / jnp.maximum(col_valid.sum(), 1.0)
    o_valid = jnp.arange(s1) <= (n1 - n2)
    means_c = jnp.where(o_valid, means_c, -1.0)
    _, cand = jax.lax.top_k(means_c, n_candidates)                   # [K]

    # -- fine: exact re-score around each candidate --------------------------
    p2 = pos2.astype(jnp.bfloat16)
    q2 = neg2.astype(jnp.bfloat16)
    i_valid = (jnp.arange(s2) < n2).astype(jnp.float32)

    def exact_at(offset):
        o = jnp.clip(offset, 0, s1 - s2)
        rp = jax.lax.dynamic_slice(p1, (o, 0), (s2, pairs))
        rn = jax.lax.dynamic_slice(q1, (o, 0), (s2, pairs))
        riw = jax.lax.dynamic_slice(inv_w, (o,), (s2,))
        hits = (jnp.sum((rp * p2).astype(jnp.float32), axis=-1)
                + jnp.sum((rn * q2).astype(jnp.float32), axis=-1))   # [S2]
        sim = hits * riw * i_valid
        mean = jnp.sum(sim) / jnp.maximum(n2, 1).astype(jnp.float32)
        return jnp.where((offset >= 0) & (offset <= n1 - n2), mean, 0.0)

    deltas = np.arange(-refine_radius, refine_radius + 1)
    offsets = (cand[:, None] + jnp.asarray(deltas)[None, :]).reshape(-1)
    scores = jax.vmap(exact_at)(offsets)
    return jnp.where(n2 > 0, jnp.max(scores), 0.0)


@partial(jax.jit, static_argnames=("comparison_range", "subfingerprint_length"))
def match_one_vs_many_padded(query_pos, query_neg, n_query,
                             lib_pos, lib_neg, n_lib,
                             comparison_range: int = 0,
                             subfingerprint_length: int = 200):
    """Query vs a padded fingerprint library.

    query: ``[Sq, pairs]`` uint8 planes + scalar count; library:
    ``[L, Sl, pairs]`` + ``[L]`` counts.  Returns ``[L]`` match scores.

    The hit counts are symmetric in the two fingerprints, so they collapse to
    TWO large matmuls over the flattened library ``[L*Sl, pairs] @
    [pairs, Sq]`` — far better utilisation than L batched 64x64 matmuls.
    Only the possible-hit denominator and the offset-scan direction depend on
    which side is longer (quirk Q10), handled by computing both orientations
    of the cheap banded-diagonal reduction and selecting per entry.
    """
    l, s_lib, pairs = lib_pos.shape
    s_q = query_pos.shape[0]
    mask = jnp.asarray(_pair_mask(pairs, comparison_range, subfingerprint_length))
    mb = mask.astype(jnp.bfloat16)

    lp = lib_pos.reshape(l * s_lib, pairs).astype(jnp.bfloat16) * mb
    ln = lib_neg.reshape(l * s_lib, pairs).astype(jnp.bfloat16) * mb
    qp = query_pos.astype(jnp.bfloat16)
    qn = query_neg.astype(jnp.bfloat16)
    hits = (jnp.dot(lp, qp.T, preferred_element_type=jnp.float32)
            + jnp.dot(ln, qn.T, preferred_element_type=jnp.float32))
    hits = hits.reshape(l, s_lib, s_q)

    w_lib = jnp.sum((lp + ln).astype(jnp.float32), axis=-1).reshape(l, s_lib)
    w_q = jnp.sum(((qp + qn) * mb).astype(jnp.float32), axis=-1)       # [Sq]
    inv_lib = jnp.where(w_lib > 0.0, 1.0 / jnp.maximum(w_lib, 1.0), 0.0)
    inv_q = jnp.where(w_q > 0.0, 1.0 / jnp.maximum(w_q, 1.0), 0.0)

    nq = jnp.broadcast_to(n_query, (l,))
    return _both_orientation_scores(hits, inv_lib, inv_q, n_lib, nq)


def _both_orientation_scores(hits, inv_lib, inv_q, n_lib, nq):
    """Offset-sliding scores for both swap orientations from one shared
    ``hits`` tensor (quirk Q10: only the possible-hits denominator and the
    slide direction depend on which side is longer).

    hits: ``[L, Sl, Sq]`` raw hit counts; inv_lib: ``[L, Sl]`` reciprocal
    possible-hits of library rows (0 where none); inv_q: ``[Sq]`` likewise
    for the query; n_lib/nq: ``[L]`` valid counts.  The per-orientation sim
    tensors are formed by row scaling (never transposed/copied) and reduced
    by the same static-roll banded-diagonal sum as offset_scores.
    """
    l, s_lib, s_q = hits.shape
    # Orientation A: library entry is fp1 (slid, longer).  Scale rows.
    sim_a = hits * inv_lib[..., None]
    score_a = offset_scores(sim_a, n_lib, nq)
    # Orientation B: query is fp1.  Scale columns; the diagonal sum
    # D[l, o] = sum_i sim_b[l, i, o+i] needs rolls along the LAST axis of the
    # untransposed tensor: row i of hits contributes hits[l, i, o+i]*inv_q[o+i].
    sim_b = hits * inv_q[None, None, :]
    i_idx = jnp.arange(s_lib)
    masked_b = sim_b * (i_idx < n_lib[:, None])[..., None].astype(sim_b.dtype)
    total_b = jnp.zeros((l, s_q), sim_b.dtype)
    for i in range(s_lib):
        total_b = total_b + jnp.roll(masked_b[:, i, :], -i, axis=-1)
    means_b = total_b / jnp.maximum(n_lib, 1).astype(sim_b.dtype)[:, None]
    o_valid_b = jnp.arange(s_q)[None, :] <= (nq - n_lib)[:, None]
    score_b = jnp.max(jnp.where(o_valid_b, means_b, 0.0), axis=-1)
    score_b = jnp.where(n_lib > 0, score_b, 0.0)
    return jnp.where(n_lib < nq, score_b, score_a)
