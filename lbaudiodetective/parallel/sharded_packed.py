"""Packed (pod-residency) sharded matching and ring dedup.

The unpacked mesh paths (parallel.sharded / parallel.dedup) operate on
{0,1} uint8 planes — 16x the memory of the packed uint32 word form that the
1M-track scenario requires (ops.match_packed: 3.2 KB vs 51 KB per entry).
This module provides the same three mesh capabilities directly on packed
planes, so the library never needs to be unpacked for distribution:

- **Library sharding**: one-vs-many popcount matching with the packed DB
  sharded over ``"library"`` (scores exactly equal the unpacked and scalar
  paths; reference semantics LBAudioDetectiveFingerprint.m:119-176).
- **Ring all-pairs**: many-vs-many via ``lax.ppermute`` of *packed* blocks —
  16x less ICI traffic per ring step than the unpacked ring.
- **Ring dedup top-k**: streaming per-track candidate fold at pod scale
  (BASELINE config 5) without materialising O(L^2) scores.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lbaudiodetective.ops.match import offset_scores
from lbaudiodetective.ops.match_packed import (_mask_words,
                                                  match_one_vs_many_packed)


@functools.lru_cache(maxsize=128)
def _match_runner(mesh: Mesh, pairs: int, comparison_range: int,
                  subfingerprint_length: int, batched: bool):
    """Build (once per static config) the jitted sharded match runner.

    Constructing the jit inside the public functions would re-trace and
    re-compile the whole mesh program on EVERY call (each fresh closure
    starts with an empty jit cache) — a serving request must reuse one
    compiled executable.  The cache holds only callables and the hashable
    mesh, never arrays (tracer-leak gotcha).
    """
    lib_sh = NamedSharding(mesh, P("library", None, None))
    cnt_sh = NamedSharding(mesh, P("library"))
    rep = NamedSharding(mesh, P())
    out_sh = NamedSharding(mesh, P(None, "library")) if batched else cnt_sh

    @functools.partial(
        jax.jit,
        in_shardings=(rep, rep, rep, lib_sh, lib_sh, cnt_sh),
        out_shardings=out_sh,
    )
    def run(qp, qn, nq, lp, ln, nl):
        def one(qp1, qn1, n1):
            return match_one_vs_many_packed(
                qp1, qn1, n1, lp, ln, nl, pairs,
                comparison_range, subfingerprint_length)

        return jax.vmap(one)(qp, qn, nq) if batched else one(qp, qn, nq)

    return run


def match_library_sharded_packed(q_pos_w, q_neg_w, n_query,
                                 lib_pos_w, lib_neg_w, n_lib,
                                 pairs: int, mesh: Mesh,
                                 comparison_range: int = 0,
                                 subfingerprint_length: int = 200):
    """One-vs-many on a packed library sharded over ``"library"``.

    query: ``[Sq, W]`` uint32 words + scalar count (replicated); library:
    ``[L, Sl, W]`` + ``[L]`` counts, L divisible by the library-axis size.
    Returns ``[L]`` scores sharded over ``"library"``.  Embarrassingly
    parallel — each device runs the popcount matcher on its resident shard.
    """
    run = _match_runner(mesh, pairs, comparison_range,
                        subfingerprint_length, False)
    return run(q_pos_w, q_neg_w, n_query, lib_pos_w, lib_neg_w, n_lib)


def match_many_library_sharded_packed(q_pos_w, q_neg_w, n_query,
                                      lib_pos_w, lib_neg_w, n_lib,
                                      pairs: int, mesh: Mesh,
                                      comparison_range: int = 0,
                                      subfingerprint_length: int = 200):
    """Batched :func:`match_library_sharded_packed`: B queries (leading axis
    on ``q*``, replicated) -> ``[B, L]`` scores sharded over ``"library"``,
    in ONE mesh dispatch (each device vmaps the popcount matcher over the
    query batch on its resident shard)."""
    run = _match_runner(mesh, pairs, comparison_range,
                        subfingerprint_length, True)
    return run(q_pos_w, q_neg_w, n_query, lib_pos_w, lib_neg_w, n_lib)


def _packed_block_scores(res, vis, mask_w):
    """All-pairs offset-slide scores of a resident packed block against a
    visiting packed block: ``([lr, S, W], [lr]) x ([lv, S, W], [lv]) ->
    [lr, lv]`` float32.

    Same orientation-swap construction as the unpacked ring
    (parallel.sharded.ring_all_pairs_scores) with hits/possible computed by
    AND/OR + popcount; integers throughout, so scores are exactly equal.
    """
    res_pos, res_neg, res_cnt = res
    vis_pos, vis_neg, vis_cnt = vis
    rp = res_pos & mask_w
    rn = res_neg & mask_w
    vp = vis_pos & mask_w
    vn = vis_neg & mask_w
    lr, lv = rp.shape[0], vp.shape[0]
    rp_b = jnp.broadcast_to(rp[:, None], (lr, lv, *rp.shape[1:]))
    rn_b = jnp.broadcast_to(rn[:, None], (lr, lv, *rn.shape[1:]))
    vp_b = jnp.broadcast_to(vp[None, :], (lr, lv, *vp.shape[1:]))
    vn_b = jnp.broadcast_to(vn[None, :], (lr, lv, *vn.shape[1:]))
    rc = jnp.broadcast_to(res_cnt[:, None], (lr, lv))
    vc = jnp.broadcast_to(vis_cnt[None, :], (lr, lv))
    swap = (rc < vc)[..., None, None]
    pos_l = jnp.where(swap, vp_b, rp_b)
    neg_l = jnp.where(swap, vn_b, rn_b)
    pos_s = jnp.where(swap, rp_b, vp_b)
    neg_s = jnp.where(swap, rn_b, vn_b)

    w = pos_l.shape[-1]
    hits = None
    for k in range(w):          # word loop bounds the [lr, lv, S, S] peak
        h = (jax.lax.population_count(
                pos_l[..., k][..., :, None] & pos_s[..., k][..., None, :])
             + jax.lax.population_count(
                neg_l[..., k][..., :, None] & neg_s[..., k][..., None, :]))
        hits = h if hits is None else hits + h
    hits = hits.astype(jnp.float32)                         # [lr, lv, S, S]

    possible = jnp.sum(jax.lax.population_count(pos_l | neg_l),
                       axis=-1).astype(jnp.float32)         # [lr, lv, S]
    inv = jnp.where(possible > 0.0, 1.0 / jnp.maximum(possible, 1.0), 0.0)
    sim = hits * inv[..., :, None]
    return offset_scores(sim, jnp.maximum(rc, vc), jnp.minimum(rc, vc))


def ring_all_pairs_scores_packed(pos_w, neg_w, counts, pairs: int, mesh: Mesh,
                                 axis: str = "library",
                                 comparison_range: int = 0,
                                 subfingerprint_length: int = 200):
    """Many-vs-many scores via a ppermute ring of packed blocks.

    pos_w/neg_w: ``[L, S, W]`` uint32, L divisible by the ring size;
    counts: ``[L]``.  Returns ``[L, L]`` float32, rows sharded over ``axis``;
    exactly equal to parallel.sharded.ring_all_pairs_scores on the unpacked
    planes.
    """
    run = _ring_packed_runner(mesh, axis, pairs, comparison_range,
                              subfingerprint_length)
    return run(pos_w, neg_w, counts)


@functools.lru_cache(maxsize=128)
def _ring_packed_runner(mesh: Mesh, axis: str, pairs: int,
                        comparison_range: int, subfingerprint_length: int):
    n_ring = mesh.shape[axis]
    shard = NamedSharding(mesh, P(axis, None, None))
    cnt_sh = NamedSharding(mesh, P(axis))
    out_sh = NamedSharding(mesh, P(axis, None))
    mask_w = _mask_words(pairs, comparison_range, subfingerprint_length)

    @functools.partial(
        jax.jit,
        in_shardings=(shard, shard, cnt_sh),
        out_shardings=out_sh,
    )
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None, None), P(axis)),
        out_specs=P(axis, None),
    )
    def run(local_pos, local_neg, local_cnt):
        ring_idx = jax.lax.axis_index(axis)
        l_local = local_pos.shape[0]
        perm = [(i, (i + 1) % n_ring) for i in range(n_ring)]
        mw = jnp.asarray(mask_w)

        vis = (local_pos, local_neg, local_cnt)
        out = jnp.zeros((l_local, l_local * n_ring), jnp.float32)
        for step in range(n_ring):
            src = (ring_idx - step) % n_ring
            block = _packed_block_scores(
                (local_pos, local_neg, local_cnt), vis, mw)
            out = jax.lax.dynamic_update_slice(out, block, (0, src * l_local))
            if step + 1 < n_ring:
                vis = tuple(jax.lax.ppermute(v, axis, perm) for v in vis)
        return out

    return run


def ring_dedup_topk_packed(pos_w, neg_w, counts, pairs: int, mesh: Mesh,
                           k: int = 8, axis: str = "library",
                           comparison_range: int = 0,
                           subfingerprint_length: int = 200):
    """All-pairs candidate search with streaming top-k on packed planes.

    Same contract as parallel.dedup.ring_dedup_topk: returns
    ``(scores, indices)`` each ``[L, k]`` — the k best-matching *other*
    tracks per track, rows sharded over ``axis`` — but the ring rotates
    packed uint32 words (16x less ICI traffic per step) and the resident
    shard stays packed in device memory (the only form that fits 1M tracks).
    """
    run = _dedup_packed_runner(mesh, axis, pairs, k, comparison_range,
                               subfingerprint_length)
    return run(pos_w, neg_w, counts)


@functools.lru_cache(maxsize=128)
def _dedup_packed_runner(mesh: Mesh, axis: str, pairs: int, k: int,
                         comparison_range: int, subfingerprint_length: int):
    n_ring = mesh.shape[axis]
    shard = NamedSharding(mesh, P(axis, None, None))
    cnt_sh = NamedSharding(mesh, P(axis))
    out_sh = NamedSharding(mesh, P(axis, None))
    mask_w = _mask_words(pairs, comparison_range, subfingerprint_length)

    @functools.partial(
        jax.jit,
        in_shardings=(shard, shard, cnt_sh),
        out_shardings=(out_sh, out_sh),
    )
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None, None), P(axis)),
        out_specs=(P(axis, None), P(axis, None)),
    )
    def run(local_pos, local_neg, local_cnt):
        ring_idx = jax.lax.axis_index(axis)
        l_local = local_pos.shape[0]
        perm = [(i, (i + 1) % n_ring) for i in range(n_ring)]
        my_rows = ring_idx * l_local + jnp.arange(l_local)
        mw = jnp.asarray(mask_w)

        best_scores = jnp.full((l_local, k), -jnp.inf, jnp.float32)
        best_idx = jnp.full((l_local, k), -1, jnp.int32)

        vis = (local_pos, local_neg, local_cnt)
        for step in range(n_ring):
            src = (ring_idx - step) % n_ring
            block = _packed_block_scores(
                (local_pos, local_neg, local_cnt), vis, mw)
            cols = src * l_local + jnp.arange(l_local)
            block = jnp.where(my_rows[:, None] == cols[None, :],
                              -jnp.inf, block)
            merged = jnp.concatenate([best_scores, block], axis=1)
            merged_idx = jnp.concatenate(
                [best_idx,
                 jnp.broadcast_to(cols[None, :], block.shape).astype(jnp.int32)],
                axis=1)
            top_vals, top_pos = jax.lax.top_k(merged, k)
            best_scores = top_vals
            best_idx = jnp.take_along_axis(merged_idx, top_pos, axis=1)
            if step + 1 < n_ring:
                vis = tuple(jax.lax.ppermute(v, axis, perm) for v in vis)
        return best_scores, best_idx

    return run


def search_library_sharded_packed(q_pos_w, q_neg_w, n_query,
                                  qc_pos_w, qc_neg_w, n_query_c,
                                  lib_pos_w, lib_neg_w, n_lib,
                                  libc_pos_w, libc_neg_w, n_lib_c,
                                  pairs: int, mesh: Mesh,
                                  comparison_range: int = 0,
                                  subfingerprint_length: int = 200,
                                  coarse_range: int = 64,
                                  chunk: int = 65536,
                                  shortlist: int = 1024,
                                  top_k: int = 5):
    """Two-stage coarse->exact search with the packed library sharded over
    ``"library"`` (models.library.FingerprintLibrary.search semantics at
    pod scale).

    Each device runs the fused coarse-scan -> top-k -> gather -> exact
    re-score on its resident shard (``shortlist``/``chunk`` apply
    per-shard) and contributes its local top-k with globally-offset
    indices; the ``[n_shards * top_k]`` candidates are merged host-side.
    Exact whenever every true global top-k entry survives its own shard's
    shortlist — the same recall property as the single-device search,
    per shard.  Returns ``(indices [top_k], exact scores [top_k])``.
    """
    import numpy as np

    n_sh = mesh.shape["library"]
    l_local = lib_pos_w.shape[0] // n_sh
    chunk = min(chunk, libc_pos_w.shape[0] // n_sh)
    k_local = min(top_k, l_local)
    # The exact stage re-scores `shortlist` candidates and the local top-k
    # draws from them, so the shortlist must cover k_local (tiny shards).
    shortlist = max(min(shortlist, l_local), k_local)
    run = _search_runner(mesh, pairs, comparison_range,
                         subfingerprint_length, coarse_range, chunk,
                         shortlist, k_local, False)
    idx_all, sc_all = run(q_pos_w, q_neg_w, n_query,
                          qc_pos_w, qc_neg_w, n_query_c,
                          lib_pos_w, lib_neg_w, n_lib,
                          libc_pos_w, libc_neg_w, n_lib_c)
    idx_all = np.asarray(idx_all)
    sc_all = np.asarray(sc_all)
    order = np.argsort(-sc_all, kind="stable")[:top_k]
    return idx_all[order].astype(np.int64), sc_all[order]


@functools.lru_cache(maxsize=128)
def _search_runner(mesh: Mesh, pairs: int, comparison_range: int,
                   subfingerprint_length: int, coarse_range: int,
                   chunk: int, shortlist: int, k_local: int, batched: bool):
    """Build (once per static config) the jitted sharded search runner.

    Per-shard, the coarse planes are zero-padded up to a ``chunk`` multiple
    INSIDE the shard_map body — two_stage_search_packed requires it, and a
    real shard size (e.g. 1M/8 = 125,000) is rarely divisible by the chunk;
    the padded entries are masked by the exact-plane length, so scores are
    unaffected.  See :func:`_match_runner` for why construction is cached.
    """
    from lbaudiodetective.ops.match_packed import two_stage_search_packed

    shard = NamedSharding(mesh, P("library", None, None))
    cnt_sh = NamedSharding(mesh, P("library"))
    rep = NamedSharding(mesh, P())
    out_spec = P(None, "library") if batched else P("library")
    out_sh = NamedSharding(mesh, out_spec)

    @functools.partial(
        jax.jit,
        in_shardings=(rep, rep, rep, rep, rep, rep,
                      shard, shard, cnt_sh, shard, shard, cnt_sh),
        out_shardings=(out_sh, out_sh),
    )
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(),
                  P("library", None, None), P("library", None, None),
                  P("library"),
                  P("library", None, None), P("library", None, None),
                  P("library")),
        out_specs=(out_spec, out_spec),
    )
    def run(qp, qn, nq, qcp, qcn, nqc, lp, ln, nl, lcp, lcn, nlc):
        pad = (-lcp.shape[0]) % chunk
        if pad:
            lcp = jnp.pad(lcp, ((0, pad), (0, 0), (0, 0)))
            lcn = jnp.pad(lcn, ((0, pad), (0, 0), (0, 0)))
            nlc = jnp.pad(nlc, (0, pad))

        def one(qp1, qn1, n1, qcp1, qcn1, nc1):
            return two_stage_search_packed(
                qp1, qn1, n1, qcp1, qcn1, nc1, lp, ln, nl, lcp, lcn, nlc,
                pairs, comparison_range, subfingerprint_length,
                coarse_range, chunk, shortlist, k_local)

        if batched:
            idx, sc = jax.vmap(one)(qp, qn, nq, qcp, qcn, nqc)
        else:
            idx, sc = one(qp, qn, nq, qcp, qcn, nqc)
        offset = jax.lax.axis_index("library").astype(idx.dtype) * lp.shape[0]
        return idx + offset, sc

    return run


def search_many_library_sharded_packed(q_pos_w, q_neg_w, n_query,
                                       qc_pos_w, qc_neg_w, n_query_c,
                                       lib_pos_w, lib_neg_w, n_lib,
                                       libc_pos_w, libc_neg_w, n_lib_c,
                                       pairs: int, mesh: Mesh,
                                       comparison_range: int = 0,
                                       subfingerprint_length: int = 200,
                                       coarse_range: int = 64,
                                       chunk: int = 65536,
                                       shortlist: int = 1024,
                                       top_k: int = 5):
    """Batched :func:`search_library_sharded_packed`: B queries (leading
    axis on every ``q*`` input, replicated) run through ONE mesh dispatch —
    each device vmaps the fused two-stage search over the query batch on
    its resident shard.  Returns ``(indices [B, top_k], scores [B, top_k])``
    merged host-side per query — the pod-serving batcher's search stage
    (B serving requests cost one collective dispatch, not B).
    """
    import numpy as np

    n_sh = mesh.shape["library"]
    l_local = lib_pos_w.shape[0] // n_sh
    chunk = min(chunk, libc_pos_w.shape[0] // n_sh)
    k_local = min(top_k, l_local)
    shortlist = max(min(shortlist, l_local), k_local)
    run = _search_runner(mesh, pairs, comparison_range,
                         subfingerprint_length, coarse_range, chunk,
                         shortlist, k_local, True)
    idx_all, sc_all = run(q_pos_w, q_neg_w, n_query,
                          qc_pos_w, qc_neg_w, n_query_c,
                          lib_pos_w, lib_neg_w, n_lib,
                          libc_pos_w, libc_neg_w, n_lib_c)
    idx_all = np.asarray(idx_all)                            # [B, n_sh*k_local]
    sc_all = np.asarray(sc_all)
    order = np.argsort(-sc_all, axis=1, kind="stable")[:, :top_k]
    return (np.take_along_axis(idx_all, order, axis=1).astype(np.int64),
            np.take_along_axis(sc_all, order, axis=1))
