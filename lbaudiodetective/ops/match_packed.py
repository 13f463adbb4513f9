"""Packed-bit (popcount) matching for memory-bound library scales.

The matmul matcher (ops.match) holds each subfingerprint as two bf16-able
{0,1} planes — ~51 KB per 64-subfingerprint library entry once broadcast.  At
pod scale (BASELINE config 5: 1M tracks) the library must live packed: two
uint32 planes of ceil(pairs/32) words (= 3.2 KB per entry, 16x less), with the
quirk-Q10 similarity computed by AND + population count:

    hits(i, j)  = popcount(P1_i & P2_j) + popcount(N1_i & N2_j)
    possible(i) = popcount(P1_i | N1_i)          (fp1 = the longer side)

The offset-sliding reduction is shared with the matmul matcher
(ops.match.offset_scores).  Scores are exactly equal to the unpacked path.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from lbaudiodetective.ops.match import _pair_mask, offset_scores
from lbaudiodetective.utils.packing import words_per_plane


def pack_bits_device(plane: jnp.ndarray) -> jnp.ndarray:
    """``[..., pairs] {0,1} -> [..., ceil(pairs/32)] uint32`` on device
    (little-endian bit order, same layout as utils.packing.pack_bits)."""
    *lead, pairs = plane.shape
    w = words_per_plane(pairs)
    pad = w * 32 - pairs
    bits = jnp.pad(plane.astype(jnp.uint32), [(0, 0)] * len(lead) + [(0, pad)])
    bits = bits.reshape(*lead, w, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(bits << shifts, axis=-1, dtype=jnp.uint32)


def _mask_words(pairs: int, comparison_range: int, subfingerprint_length: int
                ) -> np.ndarray:
    mask = _pair_mask(pairs, comparison_range, subfingerprint_length)
    w = words_per_plane(pairs)
    padded = np.zeros(w * 32, np.uint32)
    padded[:pairs] = mask.astype(np.uint32)
    out = np.zeros(w, np.uint32)
    for i in range(32):
        out |= padded[i::32][:w] << np.uint32(i)
    return out


@partial(jax.jit, static_argnames=("comparison_range", "subfingerprint_length",
                                   "pairs"))
def match_one_vs_many_packed(q_pos_w, q_neg_w, n_query,
                             lib_pos_w, lib_neg_w, n_lib,
                             pairs: int,
                             comparison_range: int = 0,
                             subfingerprint_length: int = 200):
    """Query vs packed library: ``[Sq, W]``/``[L, Sl, W]`` uint32 planes ->
    ``[L]`` float32 scores (identical to ops.match.match_one_vs_many_padded).
    """
    from lbaudiodetective.ops.match import _both_orientation_scores

    mask_np = _mask_words(pairs, comparison_range, subfingerprint_length)
    mask_w = jnp.asarray(mask_np)
    lp = lib_pos_w & mask_w
    ln = lib_neg_w & mask_w
    qp = q_pos_w & mask_w
    qn = q_neg_w & mask_w

    # hits[l, i, j] summed over words (python loop keeps peak memory at one
    # [L, Sl, Sq] plane).  Words fully masked by a short comparison_range
    # are statically known to contribute 0 — skip them (a range-64 coarse
    # pass over pairs=100 planes touches 1 word instead of 4).
    w = lp.shape[-1]
    hits = None
    for k in range(w):
        if int(mask_np[k]) == 0:
            continue
        h = (jax.lax.population_count(lp[..., k][..., None] & qp[:, k][None, None, :])
             + jax.lax.population_count(ln[..., k][..., None] & qn[:, k][None, None, :]))
        hits = h if hits is None else hits + h
    if hits is None:
        hits = jnp.zeros(lp.shape[:2] + (qp.shape[0],), jnp.int32)
    hits = hits.astype(jnp.float32)                               # [L, Sl, Sq]

    w_lib = jnp.sum(jax.lax.population_count(lp | ln), axis=-1).astype(jnp.float32)
    w_q = jnp.sum(jax.lax.population_count(qp | qn), axis=-1).astype(jnp.float32)
    inv_lib = jnp.where(w_lib > 0.0, 1.0 / jnp.maximum(w_lib, 1.0), 0.0)
    inv_q = jnp.where(w_q > 0.0, 1.0 / jnp.maximum(w_q, 1.0), 0.0)

    l = lib_pos_w.shape[0]
    nq = jnp.broadcast_to(n_query, (l,))
    return _both_orientation_scores(hits, inv_lib, inv_q, n_lib, nq)


def phase_strided_query_planes(qp, qn, n, stride: int,
                               phases: int | None = None):
    """Phase-shifted strided query planes for the phase-robust coarse pass.

    ``[S, pairs]`` uint8 planes (or batched ``[B, S, pairs]``) ->
    ``([P, Sc, pairs], [P, Sc, pairs], [P])`` (batched: leading ``B``),
    where phase ``p`` holds ``q[p::stride]`` zero-padded to
    ``Sc = ceil(S/stride)`` and its subfingerprint count.

    Why phases: the coarse pass strides BOTH query and library
    subfingerprint axes, so its offset slide is quantised to multiples of
    ``stride`` — phase ``p`` restores alignment for true offsets
    ``k ≡ -p (mod stride)`` (k = o*stride - p at strided offset o).
    Consecutive subfingerprints cover DISJOINT audio (128-row frames,
    LBAudioDetective.m:262-293), so a misaligned coarse compare scores
    ~chance and a crop at k % stride != 0 would otherwise fall out of the
    shortlist entirely (measured: 2-5/10 recall at shortlist = L/2).
    Scanning all ``stride`` phases and taking the max restores recall at
    ``stride``x the coarse compute — still ``stride``x cheaper than the
    exact scan on the subfingerprint axes alone, plus the coarse-range
    word skip.  ``phases`` < stride trades recall back for speed
    (phases=1 == the legacy phase-0-only coarse).
    """
    qp = np.asarray(qp)
    qn = np.asarray(qn)
    batched = qp.ndim == 3
    if not batched:
        qp, qn = qp[None], qn[None]
    n_arr = np.atleast_1d(np.asarray(n, np.int32))
    b, s, pairs = qp.shape
    sc = -(-s // stride)
    p_total = stride if phases is None else max(1, min(phases, stride))
    out_p = np.zeros((b, p_total, sc, pairs), np.uint8)
    out_n = np.zeros_like(out_p)
    ncs = np.zeros((b, p_total), np.int32)
    for p in range(p_total):
        sl = qp[:, p::stride]
        out_p[:, p, : sl.shape[1]] = sl
        sl = qn[:, p::stride]
        out_n[:, p, : sl.shape[1]] = sl
        ncs[:, p] = np.maximum(0, -(-(n_arr - p) // stride))
    if not batched:
        return out_p[0], out_n[0], ncs[0]
    return out_p, out_n, ncs


@partial(jax.jit, static_argnames=("pairs", "comparison_range",
                                   "subfingerprint_length", "coarse_range",
                                   "chunk", "shortlist", "top_k"))
def two_stage_search_packed(q_pos_w, q_neg_w, n_query,
                            qc_pos_w, qc_neg_w, n_query_c,
                            lib_pos_w, lib_neg_w, n_lib,
                            libc_pos_w, libc_neg_w, n_lib_c,
                            pairs: int,
                            comparison_range: int = 0,
                            subfingerprint_length: int = 200,
                            coarse_range: int = 64,
                            chunk: int = 65536,
                            shortlist: int = 1024,
                            top_k: int = 5):
    """Coarse->exact library search in ONE device dispatch.

    The coarse planes (``libc_*``: subfingerprint axis subsampled, entry
    axis zero-padded to a ``chunk`` multiple) are scanned chunkwise with
    ``lax.map`` (bounding the [chunk, Sc, Sc] hit transient), the
    ``shortlist`` best coarse entries are picked with an on-device
    ``top_k``, gathered from the FULL planes, and re-scored exactly.
    Returns ``(indices[top_k], exact scores[top_k])`` by descending exact
    score — no host round-trip until the final [top_k] fetch, which is
    what makes this fast over a high-latency link (the host-chunked
    variant measured 0.87 s vs 0.39 s for even a FULL scan at 1M).

    ``qc_*`` carry a leading PHASE axis ``[P, Sc, W]`` (+ counts ``[P]``),
    built by :func:`phase_strided_query_planes`; each chunk's coarse score
    is the max over phases, making the shortlist robust to query offsets
    that are not multiples of the coarse stride.  ``lax.map`` over the
    phase axis keeps the [chunk, Sc, Sc] transient single-phase.
    """
    lp = libc_pos_w.shape[0]
    sc_len, w = libc_pos_w.shape[1], libc_pos_w.shape[2]
    if lp % chunk:
        raise ValueError("coarse plane entry axis must be zero-padded to a "
                         "multiple of chunk")
    n_chunks = lp // chunk
    n_phases = qc_pos_w.shape[0]

    def body(i):
        start = i * chunk
        lcp = jax.lax.dynamic_slice(libc_pos_w, (start, 0, 0),
                                    (chunk, sc_len, w))
        lcn = jax.lax.dynamic_slice(libc_neg_w, (start, 0, 0),
                                    (chunk, sc_len, w))
        nlc = jax.lax.dynamic_slice(n_lib_c, (start,), (chunk,))

        def phase(p):
            return match_one_vs_many_packed(
                qc_pos_w[p], qc_neg_w[p], n_query_c[p], lcp, lcn, nlc,
                pairs, coarse_range, subfingerprint_length)

        if n_phases == 1:
            return phase(jnp.int32(0))
        return jax.lax.map(phase, jnp.arange(n_phases)).max(axis=0)

    if n_chunks > 1:
        coarse = jax.lax.map(body, jnp.arange(n_chunks)).reshape(lp)
    else:
        coarse = body(jnp.int32(0))
    l = lib_pos_w.shape[0]
    coarse = jnp.where(jnp.arange(lp) < l, coarse, -jnp.inf)
    _, cand = jax.lax.top_k(coarse, shortlist)

    exact = match_one_vs_many_packed(
        q_pos_w, q_neg_w, n_query,
        jnp.take(lib_pos_w, cand, axis=0),
        jnp.take(lib_neg_w, cand, axis=0),
        jnp.take(n_lib, cand, axis=0),
        pairs, comparison_range, subfingerprint_length)
    top_scores, oi = jax.lax.top_k(exact, top_k)
    return jnp.take(cand, oi), top_scores
