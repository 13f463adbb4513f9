"""Incremental streaming library matching: O(new subfingerprints) per tick.

The straightforward streaming identify loop re-matches every stream's FULL
accumulated fingerprint against the library each tick
(streaming/identify.py::_match_now) — per-tick cost grows linearly with
stream age, O(n · S · L) for n accumulated subfingerprints.  But the
quirk-Q10 offset-slide score (LBAudioDetectiveFingerprint.m:119-176) is a
max over banded-diagonal MEANS, and each diagonal's sum is a running sum
over query subfingerprints: a new subfingerprint only APPENDS terms.  This
module maintains those diagonal sums as device state:

  orientation A (entry is fp1, used while n <= n_lib):
      D_A[b, e, d] = sum_{i<n} hits[e, d+i, i] * inv_lib[e, d+i]
      new sub i adds its [S] column, shifted to diagonal origin
  orientation B (query is fp1, used once n > n_lib):
      D_B[b, e, d] = sum_{j<n_lib} hits[e, j, d+j] * inv_q[d+j]
      new sub i adds its reversed [S] row at window [i-S+1, i]

so each tick costs O(k · S · L) for k new subfingerprints — independent of
stream age.  Scores are BITWISE equal to
ops.match.match_one_vs_many_padded on the accumulated planes: hit counts
are exact f32 integers (products are {0,1}, sums < 2^24), and the
accumulation order over query subfingerprints (ascending arrival) is the
same order `_both_orientation_scores` uses in its roll-sum loop.

Mesh scaling: every update/score op is elementwise or batched along the
library axis, so with a :class:`ShardedFingerprintLibrary` the planes AND
the diagonal state shard over the mesh's ``"library"`` axis with ZERO
per-tick collectives (the only cross-device traffic is the [batch, L]
score fetch).  The state is the scaling pressure — batch·L·(S + n_cap)·4
bytes (e.g. 256 streams × 16k entries × (32+256) diags ≈ 4.7 GB) — and
library-axis sharding divides it across the pod.
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np

import jax
import jax.numpy as jnp

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.models.library import FingerprintLibrary
from lbaudiodetective.ops.match import _pair_mask


@lru_cache(maxsize=None)
def _state_init_fn(g: int, l: int, s: int, d_cap: int, sharding):
    """Cached jitted zero-state initializer (one compile per geometry —
    per-session clones must NOT retrace; shardings are hashable)."""
    fn = lambda: (jnp.zeros((g, l, s), jnp.float32),      # noqa: E731
                  jnp.zeros((g, l, d_cap), jnp.float32))
    if sharding is not None:
        return jax.jit(fn, out_shardings=(sharding, sharding))
    return jax.jit(fn)


@lru_cache(maxsize=None)
def _grow_fn(extra: int, sharding):
    """Cached jitted orientation-B capacity growth: appending zero diagonal
    slots is EXACT — diagonal ``d`` only receives contributions from arrival
    indices ``i`` in ``[d, d+S)``, so every slot at ``d >= n`` is still
    all-zero when the stream age is ``n``."""
    fn = lambda d_b: jnp.pad(d_b, ((0, 0), (0, 0), (0, extra)))  # noqa: E731
    if sharding is not None:
        return jax.jit(fn, out_shardings=sharding)
    return jax.jit(fn)


@partial(jax.jit, static_argnames=("comparison_range", "subfingerprint_length",
                                   "slotted"))
def _update_group(d_a, d_b, lib_pos, lib_neg, n_lib,
                  qp_new, qn_new, k_valid, base,
                  comparison_range: int, subfingerprint_length: int,
                  slotted: bool = False):
    """Fold ``k`` new subfingerprints (per stream of one group) into the
    diagonal accumulators.

    d_a: [G, L, S]; d_b: [G, L, Dcap]; lib planes: [L, S, pairs] uint8;
    qp_new/qn_new: [G, k, pairs] uint8; k_valid: scalar int32 (<= k);
    base: scalar int32 — the arrival index of qp_new[:, 0].

    ``slotted=True`` is the asynchronous-sessions form: ``k_valid`` and
    ``base`` are ``[G]`` vectors (each slot advances by its own count from
    its own age), and the per-arrival diagonal shifts vmap over slots.
    Each slot's terms still accumulate in its own ascending arrival order,
    so per-slot scores stay bitwise equal to a dedicated per-stream
    matcher.  The lockstep form keeps the cheaper shared dynamic slices.
    """
    g, l, s = d_a.shape
    pairs = lib_pos.shape[-1]
    k = qp_new.shape[1]
    mask = jnp.asarray(_pair_mask(pairs, comparison_range,
                                  subfingerprint_length))
    mb = mask.astype(jnp.bfloat16)

    lp = lib_pos.reshape(l * s, pairs).astype(jnp.bfloat16) * mb
    ln = lib_neg.reshape(l * s, pairs).astype(jnp.bfloat16) * mb
    qp = qp_new.astype(jnp.bfloat16)
    qn = qn_new.astype(jnp.bfloat16)
    # hits[gr, e, j, t]: same contraction as match_one_vs_many_padded
    # ([L*S, pairs] @ [pairs, G*k]) — exact integers in f32.
    hits = (jnp.dot(lp, qp.reshape(g * k, pairs).T,
                    preferred_element_type=jnp.float32)
            + jnp.dot(ln, qn.reshape(g * k, pairs).T,
                      preferred_element_type=jnp.float32))
    hits = hits.reshape(l, s, g, k).transpose(2, 0, 1, 3)      # [G, L, S, k]

    w_lib = jnp.sum((lp + ln).astype(jnp.float32), axis=-1).reshape(l, s)
    inv_lib = jnp.where(w_lib > 0.0, 1.0 / jnp.maximum(w_lib, 1.0), 0.0)
    w_q = jnp.sum(((qp + qn) * mb).astype(jnp.float32), axis=-1)   # [G, k]
    inv_q = jnp.where(w_q > 0.0, 1.0 / jnp.maximum(w_q, 1.0), 0.0)

    d_idx = jnp.arange(s)
    lib_row_valid = (d_idx[None, :] < n_lib[:, None]).astype(jnp.float32)

    d_cap = d_b.shape[-1]
    d_b_pad = jnp.pad(d_b, ((0, 0), (0, 0), (s, s)))

    def fold_one(t, carry):
        # Sequential ascending-arrival fold (fori_loop, NOT an unrolled
        # Python loop: k buckets up to 256 and an unrolled body of [G,L,S]
        # ops at that size compiles for minutes; the loop form compiles
        # once and small).  Order — and therefore f32 accumulation — is
        # identical to the unrolled form, keeping the bitwise claim.
        d_a, d_b_pad = carry
        # live: scalar (lockstep) or [G] (slotted) -> [G-or-1, 1, 1].
        live = jnp.atleast_1d((t < k_valid).astype(jnp.float32))[:, None, None]
        i = base + t                     # arrival index (scalar or [G])
        h_t = jax.lax.dynamic_index_in_dim(hits, t, axis=3, keepdims=False)
        # Orientation A: column i contributes sim_a[e, d+i] to diagonal d
        # (dynamic left-shift with zero fill via pad + dynamic_slice).
        col = h_t * inv_lib[None, :, :] * live                 # [G, L, S]
        col_p = jnp.pad(col, ((0, 0), (0, 0), (0, s)))
        if slotted:
            shifted = jax.vmap(
                lambda c, ig: jax.lax.dynamic_slice(c, (0, ig), (l, s))
            )(col_p, i)
        else:
            shifted = jax.lax.dynamic_slice(col_p, (0, 0, i), (g, l, s))
        d_a = d_a + shifted
        # Orientation B: row j of the library contributes at d = i - j;
        # reversed row rev[sidx] = hits[.., s-1-sidx, t] lands at
        # d = i - s + 1 + sidx, i.e. padded index i + 1 + sidx.
        inv_q_t = jax.lax.dynamic_index_in_dim(inv_q, t, axis=1,
                                               keepdims=False)
        row = h_t * lib_row_valid[None, :, :] \
            * inv_q_t[:, None, None] * live
        rev = jnp.flip(row, axis=-1)
        if slotted:
            def one(plane, add, ig):
                win = jax.lax.dynamic_slice(plane, (0, ig + 1), (l, s))
                return jax.lax.dynamic_update_slice(plane, win + add,
                                                    (0, ig + 1))

            d_b_pad = jax.vmap(one)(d_b_pad, rev, i)
        else:
            window = jax.lax.dynamic_slice(
                d_b_pad, (0, 0, i + 1), (g, l, s))
            d_b_pad = jax.lax.dynamic_update_slice(
                d_b_pad, window + rev, (0, 0, i + 1))
        return d_a, d_b_pad

    d_a, d_b_pad = jax.lax.fori_loop(0, k, fold_one, (d_a, d_b_pad))
    d_b = jax.lax.dynamic_slice(d_b_pad, (0, 0, s), (g, l, d_cap))
    return d_a, d_b


def _library_state_key(library, g: int, l: int, s: int, batch: int,
                       pairs: int, comparison_range: int,
                       subfingerprint_length: int) -> str:
    """Library-content + geometry hash guarding checkpoint restores.
    Shared by the per-session matcher and the pool so a single-session
    checkpoint (g=1, batch=1) restores interchangeably between them."""
    import hashlib

    inner = (library.inner
             if getattr(library, "mesh", None) is not None else library)
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(np.asarray(inner.pos_words)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(inner.neg_words)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(inner.counts)).tobytes())
    h.update(f"{g},{l},{s},{batch},{pairs},{comparison_range},"
             f"{subfingerprint_length}".encode())
    return h.hexdigest()[:16]


@lru_cache(maxsize=None)
def _place_slot_fn(sharding):
    """Cached jitted single-slot state placement (checkpoint restore into
    a pool slot)."""

    def fn(d_a, d_b, slot, new_a, new_b):
        return (jax.lax.dynamic_update_slice(d_a, new_a[None], (slot, 0, 0)),
                jax.lax.dynamic_update_slice(d_b, new_b[None], (slot, 0, 0)))

    if sharding is not None:
        return jax.jit(fn, out_shardings=(sharding, sharding))
    return jax.jit(fn)


@lru_cache(maxsize=None)
def _reset_slot_fn(sharding):
    """Cached jitted single-slot state zeroing (slot reuse in the pool)."""

    def fn(d_a, d_b, slot):
        zero_a = jnp.zeros(d_a.shape[1:], d_a.dtype)[None]
        zero_b = jnp.zeros(d_b.shape[1:], d_b.dtype)[None]
        return (jax.lax.dynamic_update_slice(d_a, zero_a, (slot, 0, 0)),
                jax.lax.dynamic_update_slice(d_b, zero_b, (slot, 0, 0)))

    if sharding is not None:
        return jax.jit(fn, out_shardings=(sharding, sharding))
    return jax.jit(fn)


@lru_cache(maxsize=None)
def _topk_fn(k: int, true_l: int):
    """Cached jitted top-k over a group's scores (padded entries masked to
    -inf so they can never enter the winners)."""

    @jax.jit
    def fn(d_a, d_b, n_lib, n):
        sc = _scores_group(d_a, d_b, n_lib, n)
        l = sc.shape[1]
        live = jnp.arange(l)[None, :] < true_l
        return jax.lax.top_k(jnp.where(live, sc, -jnp.inf), k)

    return fn


@jax.jit
def _scores_group(d_a, d_b, n_lib, n):
    """[G, L] scores from the accumulators (selection + masks exactly as
    ops.match._both_orientation_scores).  ``n`` is the stream age — a
    scalar for lockstep streams or a ``[G]`` vector of per-slot ages."""
    g, l, s = d_a.shape
    d_cap = d_b.shape[-1]
    nn = jnp.reshape(jnp.asarray(n), (-1, 1))      # [1, 1] or [G, 1]
    nf = jnp.maximum(nn, 1).astype(jnp.float32)
    means_a = d_a / nf[..., None]
    valid_a = jnp.arange(s)[None, None, :] <= (n_lib[None, :] - nn)[..., None]
    score_a = jnp.max(jnp.where(valid_a, means_a, 0.0), axis=-1)
    score_a = jnp.where(nn > 0, score_a, 0.0)

    means_b = d_b / jnp.maximum(n_lib, 1).astype(jnp.float32)[None, :, None]
    valid_b = jnp.arange(d_cap)[None, None, :] <= (nn - n_lib[None, :])[..., None]
    score_b = jnp.max(jnp.where(valid_b, means_b, 0.0), axis=-1)
    score_b = jnp.where(n_lib[None, :] > 0, score_b, 0.0)
    return jnp.where(n_lib[None, :] < nn, score_b, score_a)


class IncrementalLibraryMatcher:
    """Running Q10 scores of ``batch`` growing queries vs a library.

    ``update(new_pos, new_neg, k_valid)`` folds the next ``k_valid``
    subfingerprints of every stream in (arrays may be padded along the
    subfingerprint axis); ``scores()`` returns the ``[batch, L]`` match
    scores of each stream's full accumulated fingerprint — bitwise equal to
    ``match_one_vs_many_padded`` on those planes, at O(k) per update
    instead of O(n).

    ``n_cap`` is the INITIAL orientation-B diagonal capacity; when a stream
    outgrows it the state auto-grows by doubling (zero-padding new diagonal
    slots is exact — see :func:`_grow_fn` — so scores stay bitwise equal;
    memory then scales with stream age, which exact Q10 over a growing
    query inherently requires).  Set ``grow=False`` to keep the old
    hard-cap behaviour (update raises past ``n_cap``).
    ``stream_group`` > 0 processes streams in groups of that size
    (bounds the [G, L, S, k] hit transient); state is held per group.

    A :class:`~..parallel.sharded_library.ShardedFingerprintLibrary` is
    accepted too: planes and diagonal state then shard along the mesh's
    ``"library"`` axis (pure data parallelism — no per-tick collectives).
    """

    def __init__(self, library, batch: int,
                 n_cap: int = 256, config: FingerprintConfig | None = None,
                 comparison_range: int = 0, stream_group: int = 0,
                 grow: bool = True):
        from lbaudiodetective.utils import packing

        self.config = config or FingerprintConfig()
        self.library = library
        self.batch = batch
        self.n_cap = n_cap
        self.grow = grow
        self.comparison_range = comparison_range
        g = stream_group or batch
        if batch % g:
            raise ValueError("stream_group must divide batch")
        self.group = g
        mesh = getattr(library, "mesh", None)
        inner = library.inner if mesh is not None else library
        self.pairs = inner.pairs
        pos_u8 = packing.unpack_bits(np.asarray(inner.pos_words), inner.pairs)
        neg_u8 = packing.unpack_bits(np.asarray(inner.neg_words), inner.pairs)
        counts = np.asarray(inner.counts)
        self._true_l = len(inner)
        s = int(pos_u8.shape[1])
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            pad = (-self._true_l) % mesh.shape["library"]
            if pad:   # padded entries carry count 0 -> always score 0
                pos_u8 = np.pad(pos_u8, ((0, pad), (0, 0), (0, 0)))
                neg_u8 = np.pad(neg_u8, ((0, pad), (0, 0), (0, 0)))
                counts = np.pad(counts, (0, pad))
            lib_sh = NamedSharding(mesh, P("library", None, None))
            self._lib_pos = jax.device_put(pos_u8, lib_sh)
            self._lib_neg = jax.device_put(neg_u8, lib_sh)
            self._n_lib = jax.device_put(counts,
                                         NamedSharding(mesh, P("library")))
            self._sh_a = NamedSharding(mesh, P(None, "library", None))
            l = int(pos_u8.shape[0])
        else:
            self._lib_pos = jnp.asarray(pos_u8)
            self._lib_neg = jnp.asarray(neg_u8)
            self._n_lib = jnp.asarray(counts)
            self._sh_a = None
            l = self._true_l
        self._geom = (g, l, s)
        make_state = _state_init_fn(g, l, s, n_cap, self._sh_a)
        self._state = [make_state() for _ in range(batch // g)]
        self.n = 0

    def clone_empty(self) -> "IncrementalLibraryMatcher":
        """A fresh-state matcher SHARING this one's device-resident library
        planes (the expensive part: unpack + placement).  Serving keeps one
        template per library and mints per-session clones from it."""
        new = object.__new__(IncrementalLibraryMatcher)
        new.__dict__.update(self.__dict__)
        g, l, s = self._geom
        make_state = _state_init_fn(g, l, s, self.n_cap, self._sh_a)
        new._state = [make_state() for _ in range(self.batch // g)]
        new.n = 0
        return new

    def update(self, new_pos: np.ndarray, new_neg: np.ndarray,
               k_valid: int | None = None) -> None:
        """new_pos/new_neg: [batch, k, pairs] uint8 (zero-padded beyond
        ``k_valid``); every stream advances by the same ``k_valid`` (the
        lockstep-extractor contract)."""
        k = int(new_pos.shape[1])
        k_valid = k if k_valid is None else int(k_valid)
        if self.n + k_valid > self.n_cap:
            if not self.grow:
                raise ValueError(
                    f"stream age {self.n + k_valid} exceeds n_cap={self.n_cap}")
            new_cap = max(self.n_cap * 2, self.n + k_valid)
            growf = _grow_fn(new_cap - self.n_cap, self._sh_a)
            self._state = [(d_a, growf(d_b)) for d_a, d_b in self._state]
            self.n_cap = new_cap
        g = self.group
        for gi in range(self.batch // g):
            d_a, d_b = self._state[gi]
            self._state[gi] = _update_group(
                d_a, d_b, self._lib_pos, self._lib_neg, self._n_lib,
                jnp.asarray(new_pos[gi * g:(gi + 1) * g]),
                jnp.asarray(new_neg[gi * g:(gi + 1) * g]),
                jnp.int32(k_valid), jnp.int32(self.n),
                self.comparison_range, self.config.subfingerprint_length)
        self.n += k_valid

    def update_bucketed(self, new_pos: np.ndarray,
                        new_neg: np.ndarray) -> None:
        """:meth:`update` with the ``k`` axis zero-padded to the next power
        of two.  ``k`` is a static shape of the jitted update kernel, so a
        live stream posting uneven increments (the normal recording case)
        would otherwise compile one kernel per distinct increment size;
        bucketing bounds that at O(log max_k) compiles."""
        k = int(new_pos.shape[1])
        if k == 0:
            return
        kb = 1 << (k - 1).bit_length()
        if kb != k:
            padw = ((0, 0), (0, kb - k), (0, 0))
            new_pos = np.pad(np.asarray(new_pos), padw)
            new_neg = np.pad(np.asarray(new_neg), padw)
        self.update(new_pos, new_neg, k_valid=k)

    # -- slot (asynchronous-session) interface ---------------------------
    #
    # The lockstep interface advances every stream by the same count; the
    # slot interface lets each stream (slot) advance by its OWN count from
    # its OWN age in one batched dispatch — the device-side primitive for
    # pooled live-recognition serving, where N sessions' posts fold in ONE
    # update instead of N (see StreamSessionPool).  Per-slot ages are the
    # caller's: ``self.n`` is not used.

    def update_slots(self, new_pos: np.ndarray, new_neg: np.ndarray,
                     k_valid: np.ndarray, base: np.ndarray) -> None:
        """Fold ``k_valid[g]`` new subfingerprints of slot ``g`` (arriving
        at ages ``base[g]..base[g]+k_valid[g]-1``) for every slot at once.
        Idle slots pass ``k_valid[g] = 0``.  Requires single-group state
        (``stream_group`` unset)."""
        if len(self._state) != 1:
            raise ValueError("slot updates need single-group state "
                             "(stream_group=0)")
        k_valid = np.asarray(k_valid, np.int32)
        base = np.asarray(base, np.int32)
        needed = int((base + k_valid).max()) if k_valid.size else 0
        if needed > self.n_cap:
            if not self.grow:
                raise ValueError(
                    f"slot age {needed} exceeds n_cap={self.n_cap}")
            new_cap = max(self.n_cap * 2, needed)
            growf = _grow_fn(new_cap - self.n_cap, self._sh_a)
            self._state = [(d_a, growf(d_b)) for d_a, d_b in self._state]
            self.n_cap = new_cap
        d_a, d_b = self._state[0]
        self._state[0] = _update_group(
            d_a, d_b, self._lib_pos, self._lib_neg, self._n_lib,
            jnp.asarray(new_pos), jnp.asarray(new_neg),
            jnp.asarray(k_valid), jnp.asarray(base),
            self.comparison_range, self.config.subfingerprint_length,
            slotted=True)

    def scores_slots(self, ages: np.ndarray) -> np.ndarray:
        """[batch, L] scores at per-slot ages ``ages`` ([batch] int)."""
        d_a, d_b = self._state[0]
        out = np.asarray(_scores_group(d_a, d_b, self._n_lib,
                                       jnp.asarray(ages, jnp.int32)))
        return out[:, :self._true_l]

    def top_k_slots(self, k: int,
                    ages: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Device-side top-k at per-slot ages (see :meth:`top_k`)."""
        k = min(k, self._true_l)
        d_a, d_b = self._state[0]
        sc, ix = _topk_fn(k, self._true_l)(d_a, d_b, self._n_lib,
                                           jnp.asarray(ages, jnp.int32))
        return np.asarray(sc), np.asarray(ix)

    def reset_slot(self, slot: int) -> None:
        """Zero one slot's accumulators (slot freed for a new session)."""
        d_a, d_b = self._state[0]
        self._state[0] = _reset_slot_fn(self._sh_a)(d_a, d_b,
                                                    jnp.int32(slot))

    # -- session persistence ---------------------------------------------
    #
    # A live-recognition server restart would otherwise lose every
    # session's accumulated diagonal state (the audio is gone — the client
    # only ever posted subfingerprint increments).  State is tiny next to
    # the library planes and fully determines the running scores, so it
    # round-trips through one npz per matcher.

    def _state_key(self) -> str:
        """Geometry + library identity a restored state must match
        (the diagonals are meaningless against different planes).
        Memoized — clones share it via ``clone_empty``'s dict copy."""
        cached = self.__dict__.get("_state_key_cache")
        if cached is not None:
            return cached
        g, l, s = self._geom
        self._state_key_cache = _library_state_key(
            self.library, g, l, s, self.batch, self.pairs,
            self.comparison_range, self.config.subfingerprint_length)
        return self._state_key_cache

    def save_state(self, path: str) -> None:
        """Checkpoint the accumulated diagonal state (all stream groups)
        plus the stream age; the library itself is NOT saved."""
        arrays = {}
        for gi, (d_a, d_b) in enumerate(self._state):
            arrays[f"da_{gi}"] = np.asarray(d_a)
            arrays[f"db_{gi}"] = np.asarray(d_b)
        np.savez(path, n=np.int64(self.n), n_groups=np.int64(len(self._state)),
                 state_key=np.bytes_(self._state_key().encode()), **arrays)

    def restore_state(self, path: str) -> None:
        """Load a checkpoint saved by :meth:`save_state` into this matcher
        (typically a fresh ``clone_empty``).  Raises ``ValueError`` on a
        geometry/library mismatch.  The orientation-B capacity adopts the
        checkpoint's (growth survives the round-trip)."""
        with np.load(path) as z:
            stored = bytes(z["state_key"]).decode()
            if stored != self._state_key():
                raise ValueError(
                    "session state was saved against a different library "
                    "or stream geometry")
            n_groups = int(z["n_groups"])
            if n_groups != len(self._state):
                raise ValueError("stream group count mismatch")
            state = []
            for gi in range(n_groups):
                d_a, d_b = z[f"da_{gi}"], z[f"db_{gi}"]
                if self._sh_a is not None:
                    d_a = jax.device_put(d_a, self._sh_a)
                    d_b = jax.device_put(d_b, self._sh_a)
                else:
                    d_a, d_b = jnp.asarray(d_a), jnp.asarray(d_b)
                state.append((d_a, d_b))
            self._state = state
            self.n_cap = int(state[0][1].shape[-1])
            self.n = int(z["n"])

    def scores(self) -> np.ndarray:
        """[batch, L] running match scores (padded mesh entries trimmed)."""
        parts = [np.asarray(_scores_group(d_a, d_b, self._n_lib,
                                          jnp.int32(self.n)))
                 for d_a, d_b in self._state]
        return np.concatenate(parts, axis=0)[:, :self._true_l]

    def top_k(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Device-side top-k: ``([batch, k] scores, [batch, k] indices)``,
        descending, ties broken by lowest index (``lax.top_k``).  Fetches
        ``k`` values per stream instead of the full ``[batch, L]`` score
        plane — the per-post transfer the serving edge actually needs
        (256 KB -> ~100 B per post at the 64k-track session bound).
        Padded mesh entries are masked out before selection."""
        k = min(k, self._true_l)
        fn = _topk_fn(k, self._true_l)
        sc_parts, ix_parts = [], []
        for d_a, d_b in self._state:
            sc, ix = fn(d_a, d_b, self._n_lib, jnp.int32(self.n))
            sc_parts.append(np.asarray(sc))
            ix_parts.append(np.asarray(ix))
        return (np.concatenate(sc_parts, axis=0),
                np.concatenate(ix_parts, axis=0))


class StreamSessionPool:
    """N asynchronous live-recognition sessions sharing ONE slot-batched
    matcher.

    With per-session matchers every post costs its own update dispatch
    (and another for the result) — on a ~40 ms-latency link a server caps
    at ~12 posts/s TOTAL regardless of session count.  The pool queues
    posts and folds ALL of them in one ``update_slots`` dispatch per
    :meth:`flush`, with per-slot results in one ``top_k_slots`` dispatch —
    per-slot scores bitwise equal to a dedicated per-session matcher
    (each slot's terms accumulate in its own ascending arrival order).

    Usage: ``open(sid)`` binds a session to a free slot; ``post`` queues
    increments; ``flush`` runs the batched fold; ``top_k`` /
    ``scores_for`` read results; ``close`` frees and zeroes the slot.
    Thread-safety is the caller's (the serving edge serialises on its
    session lock); flush ordering preserves each session's post order.
    """

    def __init__(self, library, slots: int = 64, n_cap: int = 256,
                 config: FingerprintConfig | None = None,
                 comparison_range: int = 0):
        self._m = IncrementalLibraryMatcher(
            library, batch=slots, n_cap=n_cap, config=config,
            comparison_range=comparison_range)
        self.slots = slots
        self._free = list(range(slots - 1, -1, -1))
        self._slot: dict[str, int] = {}
        self._age = np.zeros(slots, np.int32)
        self._pending: dict[str, list[tuple[np.ndarray, np.ndarray]]] = {}

    def __len__(self) -> int:
        return len(self._slot)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def open(self, sid: str) -> int:
        if sid in self._slot:
            raise ValueError(f"session {sid!r} already open")
        if not self._free:
            raise RuntimeError("no free session slots")
        slot = self._free.pop()
        self._slot[sid] = slot
        return slot

    def age(self, sid: str) -> int:
        """Folded subfingerprints of a session (pending posts excluded)."""
        return int(self._age[self._slot[sid]])

    def pending(self, sid: str) -> int:
        """Queued-but-unflushed subfingerprints of a session."""
        return sum(p.shape[0] for p, _ in self._pending.get(sid, ()))

    def post(self, sid: str, pos: np.ndarray, neg: np.ndarray) -> None:
        """Queue ``[k, pairs]`` new subfingerprints for a session."""
        if sid not in self._slot:
            raise KeyError(f"unknown session {sid!r}")
        if pos.shape[0]:
            self._pending.setdefault(sid, []).append(
                (np.asarray(pos, np.uint8), np.asarray(neg, np.uint8)))

    def flush(self) -> int:
        """Fold every queued post in ONE batched dispatch; returns the
        number of sessions that advanced.  ``k`` pads to the next power of
        two of the largest pending increment (bounded compile count)."""
        if not self._pending:
            return 0
        merged = {sid: (np.concatenate([p for p, _ in parts]),
                        np.concatenate([q for _, q in parts]))
                  for sid, parts in self._pending.items()}
        k_max = max(p.shape[0] for p, _ in merged.values())
        k_pad = 1 << (k_max - 1).bit_length()
        pairs = self._m.pairs
        qp = np.zeros((self.slots, k_pad, pairs), np.uint8)
        qn = np.zeros_like(qp)
        k_valid = np.zeros(self.slots, np.int32)
        for sid, (p, q) in merged.items():
            g = self._slot[sid]
            qp[g, :p.shape[0]] = p
            qn[g, :q.shape[0]] = q
            k_valid[g] = p.shape[0]
        self._m.update_slots(qp, qn, k_valid, self._age)
        self._age = self._age + k_valid
        n = len(merged)
        self._pending.clear()
        return n

    def top_k(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """([slots, k] scores, [slots, k] indices) at current ages — one
        dispatch for every session."""
        return self._m.top_k_slots(k, self._age)

    def scores_for(self, sid: str) -> np.ndarray:
        """[L] scores of one session (flushed state)."""
        return self._m.scores_slots(self._age)[self._slot[sid]]

    def close(self, sid: str) -> None:
        """Free a session's slot (drops any unflushed posts) and zero its
        state for reuse."""
        slot = self._slot.pop(sid)
        self._pending.pop(sid, None)
        self._age[slot] = 0
        self._m.reset_slot(slot)
        self._free.append(slot)

    # -- persistence (format-compatible with the per-session matcher) ----

    def _session_key(self) -> str:
        cached = getattr(self, "_session_key_cache", None)
        if cached is None:
            _, l, s = self._m._geom
            cached = self._session_key_cache = _library_state_key(
                self._m.library, 1, l, s, 1, self._m.pairs,
                self._m.comparison_range,
                self._m.config.subfingerprint_length)
        return cached

    def save_session(self, sid: str, path: str) -> None:
        """Checkpoint ONE session's slot state — the same npz format a
        ``batch=1`` :class:`IncrementalLibraryMatcher` writes, so pool and
        per-session servers restore each other's checkpoints.  Unflushed
        posts must be flushed first (they are not part of device state)."""
        if self._pending.get(sid):
            raise ValueError("flush before saving (pending posts)")
        slot = self._slot[sid]
        d_a, d_b = self._m._state[0]
        np.savez(path, n=np.int64(self._age[slot]), n_groups=np.int64(1),
                 state_key=np.bytes_(self._session_key().encode()),
                 da_0=np.asarray(d_a[slot])[None],
                 db_0=np.asarray(d_b[slot])[None])

    def restore_session(self, sid: str, path: str) -> None:
        """Restore a single-session checkpoint into an OPEN session's slot
        (capacities reconcile: the pool grows to a larger checkpoint, a
        smaller one zero-pads — both exact)."""
        slot = self._slot[sid]
        with np.load(path) as z:
            stored = bytes(z["state_key"]).decode()
            if stored != self._session_key():
                raise ValueError(
                    "session state was saved against a different library "
                    "or stream geometry")
            new_a, new_b = z["da_0"][0], z["db_0"][0]
            n = int(z["n"])
        m = self._m
        ckpt_cap = new_b.shape[-1]
        if ckpt_cap > m.n_cap:
            growf = _grow_fn(ckpt_cap - m.n_cap, m._sh_a)
            m._state = [(d_a, growf(d_b)) for d_a, d_b in m._state]
            m.n_cap = ckpt_cap
        elif ckpt_cap < m.n_cap:
            new_b = np.pad(new_b, ((0, 0), (0, m.n_cap - ckpt_cap)))
        d_a, d_b = m._state[0]
        m._state[0] = _place_slot_fn(m._sh_a)(
            d_a, d_b, jnp.int32(slot),
            jnp.asarray(new_a, jnp.float32), jnp.asarray(new_b, jnp.float32))
        self._age[slot] = n
