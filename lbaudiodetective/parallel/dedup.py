"""Pod-scale library deduplication / candidate indexing (BASELINE config 5).

Builds on the ring all-pairs matcher: every track is matched against every
other over the ``"library"`` ring (``lax.ppermute`` candidate exchange), then
per-track top-k candidates are reduced locally — no device ever holds the
full O(L^2) score matrix for large L because the ring processes one visiting
block at a time and the top-k fold happens per step.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lbaudiodetective.ops.match import _pair_mask, offset_scores, similarity_matrix


def ring_dedup_topk(pos, neg, counts, mesh: Mesh, k: int = 8,
                    axis: str = "library",
                    comparison_range: int = 0,
                    subfingerprint_length: int = 200):
    """All-pairs candidate search with streaming top-k.

    pos/neg: ``[L, S, pairs]`` uint8 planes (L divisible by the ring size);
    counts: ``[L]``.  Returns ``(scores, indices)`` each ``[L, k]`` — the k
    best-matching *other* tracks per track (self-matches masked out), rows
    sharded over ``axis``.
    """
    run = _dedup_runner(mesh, axis, int(pos.shape[-1]), k,
                        comparison_range, subfingerprint_length)
    return run(pos, neg, counts)


@functools.lru_cache(maxsize=128)
def _dedup_runner(mesh: Mesh, axis: str, pairs: int, k: int,
                  comparison_range: int, subfingerprint_length: int):
    """Cached jitted runner (see parallel.sharded: per-call jit construction
    retraces the mesh program every time)."""
    n_ring = mesh.shape[axis]
    shard = NamedSharding(mesh, P(axis, None, None))
    cnt_sh = NamedSharding(mesh, P(axis))
    out_sh = NamedSharding(mesh, P(axis, None))
    mask = _pair_mask(pairs, comparison_range, subfingerprint_length)

    def block_scores(res, vis):
        res_pos, res_neg, res_cnt = res
        vis_pos, vis_neg, vis_cnt = vis
        lr, lv = res_pos.shape[0], vis_pos.shape[0]
        rp = jnp.broadcast_to(res_pos[:, None], (lr, lv, *res_pos.shape[1:]))
        rn = jnp.broadcast_to(res_neg[:, None], (lr, lv, *res_neg.shape[1:]))
        vp = jnp.broadcast_to(vis_pos[None, :], (lr, lv, *vis_pos.shape[1:]))
        vn = jnp.broadcast_to(vis_neg[None, :], (lr, lv, *vis_neg.shape[1:]))
        rc = jnp.broadcast_to(res_cnt[:, None], (lr, lv))
        vc = jnp.broadcast_to(vis_cnt[None, :], (lr, lv))
        swap = (rc < vc)[..., None, None]
        sim = similarity_matrix(jnp.where(swap, vp, rp), jnp.where(swap, vn, rn),
                                jnp.where(swap, rp, vp), jnp.where(swap, rn, vn),
                                jnp.asarray(mask))
        return offset_scores(sim, jnp.maximum(rc, vc), jnp.minimum(rc, vc))

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

        best_scores = jnp.full((l_local, k), -jnp.inf, jnp.float32)
        best_idx = jnp.full((l_local, k), -1, jnp.int32)

        vis = (local_pos, local_neg, local_cnt)
        for step in range(n_ring):
            src = (ring_idx - step) % n_ring
            block = block_scores((local_pos, local_neg, local_cnt), vis)
            cols = src * l_local + jnp.arange(l_local)
            # Mask self-matches.
            block = jnp.where(my_rows[:, None] == cols[None, :], -jnp.inf, block)
            # Streaming top-k fold: merge this block with the running best.
            merged = jnp.concatenate([best_scores, block], axis=1)
            merged_idx = jnp.concatenate(
                [best_idx, jnp.broadcast_to(cols[None, :], block.shape).astype(jnp.int32)],
                axis=1)
            top_vals, top_pos = jax.lax.top_k(merged, k)
            best_scores = top_vals
            best_idx = jnp.take_along_axis(merged_idx, top_pos, axis=1)
            if step + 1 < n_ring:
                vis = tuple(jax.lax.ppermute(v, axis, perm) for v in vis)
        return best_scores, best_idx

    return run
