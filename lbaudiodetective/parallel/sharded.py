"""Sharded extraction and matching over a device mesh.

Three scale axes (SURVEY.md §2.3):

- **Data parallelism**: batched extraction with the clip axis sharded over
  ``"data"`` — pure pjit sharding annotation, no collectives needed.
- **Library sharding**: one-vs-many matching with the fingerprint DB sharded
  over ``"library"``; the query is replicated, per-shard scores come back
  sharded (argmax/aggregation is a cheap host or psum step).
- **Ring all-pairs**: many-vs-many candidate matching (pod-scale dedup,
  BASELINE config 5).  Query blocks rotate around the ``"library"`` ring via
  ``lax.ppermute`` (ring-attention style): each of n steps matches the
  resident library shard against the visiting query block, so no device ever
  holds the full O(B x L) problem and traffic rides the ICI ring.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.ops.extract import extract_fingerprint_padded
from lbaudiodetective.ops.match import _pair_mask, offset_scores, similarity_matrix


@functools.lru_cache(maxsize=128)
def _extract_dp_runner(mesh: Mesh, config: FingerprintConfig, n_rows: int):
    """Cached jitted runner — rebuilding the jit per call would retrace
    and recompile the mesh program every time (see sharded_packed)."""
    data_sharding = NamedSharding(mesh, P("data", None))
    out_sharding = NamedSharding(mesh, P("data", None, None))
    return jax.jit(
        functools.partial(extract_fingerprint_padded, config=config, n_rows=n_rows),
        in_shardings=(data_sharding, NamedSharding(mesh, P("data"))),
        out_shardings=(out_sharding, out_sharding),
    )


def extract_data_parallel(audio, n_valid_sub, config: FingerprintConfig,
                          n_rows: int, mesh: Mesh):
    """Batched extraction with the clip axis sharded over the "data" axis.

    audio: ``[B, T]`` float32 (B divisible by the data-axis size);
    n_valid_sub: ``[B]`` int32.  Returns (pos, neg) sharded the same way.
    """
    return _extract_dp_runner(mesh, config, n_rows)(audio, n_valid_sub)


@functools.lru_cache(maxsize=128)
def _match_sharded_runner(mesh: Mesh, comparison_range: int,
                          subfingerprint_length: int):
    lib_sharding = NamedSharding(mesh, P("library", None, None))
    cnt_sharding = NamedSharding(mesh, P("library"))
    rep = NamedSharding(mesh, P())

    @functools.partial(
        jax.jit,
        in_shardings=(rep, rep, rep, lib_sharding, lib_sharding, cnt_sharding),
        out_shardings=cnt_sharding,
    )
    def run(qp, qn, nq, lp, ln, nl):
        pairs = qp.shape[-1]
        mask = jnp.asarray(_pair_mask(pairs, comparison_range, subfingerprint_length))
        l = lp.shape[0]
        qp_b = jnp.broadcast_to(qp[None], (l, *qp.shape))
        qn_b = jnp.broadcast_to(qn[None], (l, *qn.shape))
        nq_b = jnp.broadcast_to(nq, (l,))
        # Library entries are the longer side by convention here; the swap of
        # the scalar matcher is preserved via element-wise selection.
        swap = (nl < nq_b)[:, None, None]
        pos_l = jnp.where(swap, qp_b, lp)
        neg_l = jnp.where(swap, qn_b, ln)
        pos_s = jnp.where(swap, lp, qp_b)
        neg_s = jnp.where(swap, ln, qn_b)
        n_l = jnp.maximum(nl, nq_b)
        n_s = jnp.minimum(nl, nq_b)
        sim = similarity_matrix(pos_l, neg_l, pos_s, neg_s, mask)
        return offset_scores(sim, n_l, n_s)

    return run


def match_library_sharded(query_pos, query_neg, n_query,
                          lib_pos, lib_neg, n_lib, mesh: Mesh,
                          comparison_range: int = 0,
                          subfingerprint_length: int = 200):
    """One-vs-many with the library axis sharded over "library".

    query: ``[S, pairs]`` + scalar count (replicated); library: ``[L, S,
    pairs]`` + ``[L]`` counts, L divisible by the library-axis size.  Returns
    ``[L]`` scores sharded over "library".  Embarrassingly parallel: each
    device matches its shard; no collective beyond the final gather the
    caller chooses to do.
    """
    run = _match_sharded_runner(mesh, comparison_range, subfingerprint_length)
    return run(query_pos, query_neg, n_query, lib_pos, lib_neg, n_lib)


def ring_all_pairs_scores(pos, neg, counts, mesh: Mesh, axis: str = "library",
                          comparison_range: int = 0,
                          subfingerprint_length: int = 200):
    """Many-vs-many match scores via a ppermute ring (pod-scale dedup).

    pos/neg: ``[L, S, pairs]`` uint8 planes, L divisible by the ring size;
    counts: ``[L]``.  Returns ``[L, L]`` float32 scores, rows sharded over
    ``axis``: ``scores[i, j]`` = match of track i (as the slid/shorter side)
    against track j.  Each ring step matches the resident shard against the
    visiting block, then rotates the block; n_steps = ring size.
    """
    run = _ring_runner(mesh, axis, int(pos.shape[-1]), comparison_range,
                       subfingerprint_length)
    return run(pos, neg, counts)


@functools.lru_cache(maxsize=128)
def _ring_runner(mesh: Mesh, axis: str, pairs: int, comparison_range: int,
                 subfingerprint_length: int):
    n_ring = mesh.shape[axis]
    shard = NamedSharding(mesh, P(axis, None, None))
    cnt_sh = NamedSharding(mesh, P(axis))
    out_sh = NamedSharding(mesh, P(axis, None))
    mask = _pair_mask(pairs, comparison_range, subfingerprint_length)

    def step_scores(res_pos, res_neg, res_cnt, vis_pos, vis_neg, vis_cnt):
        # Match every resident i against every visiting j with full
        # offset-slide semantics (swap so the longer is slid over).
        lr, lv = res_pos.shape[0], vis_pos.shape[0]
        rp = jnp.broadcast_to(res_pos[:, None], (lr, lv, *res_pos.shape[1:]))
        rn = jnp.broadcast_to(res_neg[:, None], (lr, lv, *res_neg.shape[1:]))
        vp = jnp.broadcast_to(vis_pos[None, :], (lr, lv, *vis_pos.shape[1:]))
        vn = jnp.broadcast_to(vis_neg[None, :], (lr, lv, *vis_neg.shape[1:]))
        rc = jnp.broadcast_to(res_cnt[:, None], (lr, lv))
        vc = jnp.broadcast_to(vis_cnt[None, :], (lr, lv))
        swap = (rc < vc)[..., None, None]
        pos_l = jnp.where(swap, vp, rp)
        neg_l = jnp.where(swap, vn, rn)
        pos_s = jnp.where(swap, rp, vp)
        neg_s = jnp.where(swap, rn, vn)
        sim = similarity_matrix(pos_l, neg_l, pos_s, neg_s, jnp.asarray(mask))
        return offset_scores(sim, jnp.maximum(rc, vc), jnp.minimum(rc, vc))

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

        vis_pos, vis_neg, vis_cnt = local_pos, local_neg, local_cnt
        blocks = []
        block_src = []
        for step in range(n_ring):
            # Source shard currently visiting this device.
            src = (ring_idx - step) % n_ring
            blocks.append(step_scores(local_pos, local_neg, local_cnt,
                                      vis_pos, vis_neg, vis_cnt))
            block_src.append(src)
            if step + 1 < n_ring:
                vis_pos = jax.lax.ppermute(vis_pos, axis, perm)
                vis_neg = jax.lax.ppermute(vis_neg, axis, perm)
                vis_cnt = jax.lax.ppermute(vis_cnt, axis, perm)

        # Scatter the per-step column blocks into global column order.
        out = jnp.zeros((l_local, l_local * n_ring), jnp.float32)
        for step in range(n_ring):
            start = block_src[step] * l_local
            out = jax.lax.dynamic_update_slice(out, blocks[step], (0, start))
        return out

    return run
