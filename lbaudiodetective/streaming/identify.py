"""Continuous multi-stream identification: the essay's Whistles app loop
(record -> fingerprint -> identify against the server DB, PDF §3.2.4-3.2.5)
as a device-batched streaming service.

Combines the lockstep :class:`~lbaudiodetective.streaming.runtime.
StreamingExtractor` (B concurrent streams, incremental bit-exact
extraction) with a packed :class:`~lbaudiodetective.models.library.
FingerprintLibrary`: as each stream accumulates subfingerprints, its
running fingerprint is periodically matched against the library in one
batched device dispatch, and the per-stream best candidate updates.

The running fingerprint uses the full accumulated sequence, so scores
converge to the offline identification of the whole stream (the essay's
StopProcessing + server round-trip, but without ever stopping).
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax.numpy as jnp

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.models.library import FingerprintLibrary
from lbaudiodetective.ops.extract import bucket_subfingerprints
from lbaudiodetective.ops.match import match_one_vs_many_padded
from lbaudiodetective.streaming.runtime import StreamingExtractor


@dataclasses.dataclass
class StreamMatch:
    """Current best candidate of one stream."""

    track: int                 # library index (-1 before any match)
    score: float
    n_subfingerprints: int


class StreamingIdentifier:
    """Identify ``batch`` concurrent audio streams against a library.

    Feed fixed-size chunks with :meth:`feed` / :meth:`feed_pcm16`; every
    ``match_every`` newly completed subfingerprints (across the lockstep
    batch) the accumulated fingerprints are matched against the library in
    a single vmapped device dispatch.  :meth:`best` returns the running
    per-stream winners; :meth:`finalize` forces a last match and returns
    them.
    """

    def __init__(self, library: FingerprintLibrary, batch: int,
                 chunk_size: int = 1024,
                 config: FingerprintConfig | None = None,
                 match_every: int = 4, match_stream_group: int = 0,
                 rematch: str = "full", n_cap: int = 256):
        self.library = library
        self.config = config or FingerprintConfig()
        self.config.warn_if_unvalidated_for_identification()
        self.extractor = StreamingExtractor(batch=batch, chunk_size=chunk_size,
                                            config=self.config)
        #: >0 splits each match tick's vmapped dispatch into groups of this
        #: many streams (must divide ``batch``): the matcher's [G, L, S, Sq]
        #: hit transient is what bounds library size per dispatch (256
        #: streams x a 16k library at S=32 is ~17 GB in one dispatch, 2.1 GB
        #: at G=32).  0 = all streams in one dispatch.
        if match_stream_group and batch % match_stream_group:
            raise ValueError("match_stream_group must divide batch")
        self.match_stream_group = match_stream_group
        #: "full" re-matches the whole accumulated fingerprint every tick
        #: (O(n) in stream age); "incremental" maintains running diagonal
        #: sums (streaming/incremental.py) at O(new subs) per tick with
        #: bitwise-identical scores — the production mode for long-lived
        #: streams.  ``n_cap`` is the incremental state's INITIAL diagonal
        #: capacity; streams outgrowing it auto-grow the state by doubling
        #: (exact, see incremental._grow_fn).  With a mesh-sharded library
        #: the incremental state shards along the library axis (no per-tick
        #: collectives).
        if rematch not in ("full", "incremental"):
            raise ValueError(f"unknown rematch mode {rematch!r}")
        self.rematch = rematch
        self._inc = None
        self._inc_n_cap = n_cap
        if rematch == "incremental":
            # Eager: the matcher's __init__ unpacks + uploads the library
            # planes (~210 MB at 16k tracks) and allocates diagonal state —
            # pay that at construction, like full mode's plane unpack below,
            # so the FIRST identify tick is not seconds slower than every
            # later one.
            from lbaudiodetective.streaming.incremental import (
                IncrementalLibraryMatcher)

            self._inc = IncrementalLibraryMatcher(
                library, batch, n_cap=n_cap, config=self.config,
                stream_group=match_stream_group)
        self._consumed = 0
        self.match_every = match_every
        self.batch = batch
        self._since_match = 0
        self._results = [StreamMatch(-1, 0.0, 0) for _ in range(batch)]
        #: Mesh-sharded libraries (ShardedFingerprintLibrary duck-typed via
        #: its mesh attribute) match through their own batched collective
        #: dispatch — unpacking them to host would defeat pod residency.
        self._sharded = hasattr(library, "mesh")
        if not self._sharded and rematch == "full":
            # Incremental mode never reads these planes (its matcher holds
            # its own device copy) — unpacking them too would double the
            # library's device footprint for nothing.
            # Unpacked library planes for the vmapped batch matcher (the
            # packed popcount matcher is one-vs-many; B streams batch better
            # through the shared-hits matmul form).
            from lbaudiodetective.utils import packing

            self._lib_pos = jnp.asarray(packing.unpack_bits(
                np.asarray(library.pos_words), library.pairs))
            self._lib_neg = jnp.asarray(packing.unpack_bits(
                np.asarray(library.neg_words), library.pairs))

    # -- ingestion ------------------------------------------------------------

    def feed(self, chunk) -> int:
        _, _, n_done = self.extractor.feed(chunk)
        return self._maybe_match(n_done)

    def feed_pcm16(self, chunk_i16: np.ndarray) -> int:
        _, _, n_done = self.extractor.feed_pcm16(chunk_i16)
        return self._maybe_match(n_done)

    def _maybe_match(self, n_done: int) -> int:
        self._since_match += n_done
        if self._since_match >= self.match_every:
            self._since_match = 0
            self._match_now()
        return n_done

    # -- matching -------------------------------------------------------------

    def _accumulated(self):
        """(pos, neg, n) of every stream's full fingerprint so far, padded
        to a shared bucket."""
        collected = self.extractor.harvest()
        if not collected:
            return None
        pos = np.concatenate([p for p, _ in collected], axis=1)
        neg = np.concatenate([n for _, n in collected], axis=1)
        return pos, neg, pos.shape[1]

    def _match_now(self) -> None:
        import jax

        acc = self._accumulated()
        if acc is None:
            return
        pos, neg, n_sub = acc
        if n_sub == 0:
            return
        if self.rematch == "incremental":
            from lbaudiodetective.streaming.incremental import (
                IncrementalLibraryMatcher)

            if self._inc is None:
                self._inc = IncrementalLibraryMatcher(
                    self.library, self.batch, n_cap=self._inc_n_cap,
                    config=self.config,
                    stream_group=self.match_stream_group)
            if n_sub > self._consumed:
                self._inc.update_bucketed(pos[:, self._consumed:n_sub],
                                          neg[:, self._consumed:n_sub])
                self._consumed = n_sub
            # Device-side winner selection: fetch [batch, 1] instead of the
            # full [batch, L] score plane (16 MB/tick at 256 streams x 16k
            # tracks); lax.top_k(1) == host argmax (lowest index on ties).
            sc, ix = self._inc.top_k(1)
            for b in range(self.batch):
                self._results[b] = StreamMatch(
                    int(ix[b, 0]), float(sc[b, 0]), n_sub)
            return
        if self._sharded:
            # One collective dispatch over the mesh; queries clamp to the
            # library's subfingerprint capacity (stack_query_planes).
            from lbaudiodetective.models.fingerprint import Fingerprint

            fps = [Fingerprint.from_planes(pos[b, :n_sub], neg[b, :n_sub],
                                           self.config.subfingerprint_length)
                   for b in range(self.batch)]
            scores = self.library.match_many(fps)
            best = scores.argmax(axis=1)
            for b in range(self.batch):
                self._results[b] = StreamMatch(
                    int(best[b]), float(scores[b, best[b]]), n_sub)
            return
        s = max(bucket_subfingerprints(n_sub), int(self._lib_pos.shape[1]))
        qp = np.zeros((self.batch, s, self.library.pairs), np.uint8)
        qn = np.zeros_like(qp)
        qp[:, :n_sub] = pos
        qn[:, :n_sub] = neg
        lib_pos = jnp.pad(self._lib_pos,
                          ((0, 0), (0, s - self._lib_pos.shape[1]), (0, 0)))
        lib_neg = jnp.pad(self._lib_neg,
                          ((0, 0), (0, s - self._lib_neg.shape[1]), (0, 0)))
        batched = jax.vmap(match_one_vs_many_padded,
                           in_axes=(0, 0, 0, None, None, None, None, None))
        g = self.match_stream_group or self.batch
        parts = []
        for s0 in range(0, self.batch, g):
            nq = jnp.full((g,), n_sub, jnp.int32)
            parts.append(np.asarray(batched(
                jnp.asarray(qp[s0:s0 + g]), jnp.asarray(qn[s0:s0 + g]), nq,
                lib_pos, lib_neg, self.library.counts, 0,
                self.config.subfingerprint_length)))
        scores = np.concatenate(parts, axis=0)
        best = scores.argmax(axis=1)
        for b in range(self.batch):
            self._results[b] = StreamMatch(int(best[b]),
                                           float(scores[b, best[b]]), n_sub)

    # -- results --------------------------------------------------------------

    def best(self) -> list[StreamMatch]:
        return list(self._results)

    def finalize(self) -> list[StreamMatch]:
        self._match_now()
        return self.best()
