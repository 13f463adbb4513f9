"""FingerprintLibrary: a device-resident, packed fingerprint database.

The analogue of the essay's server-side fingerprint DB (PDF §3.2.5): entries
live packed (two uint32 bit planes, 16x smaller than the matmul matcher's
broadcast planes), matching runs the popcount kernel, and the whole DB
round-trips through utils.serialize.  For multi-chip deployments the entry
axis shards over the mesh "library" axis (parallel.sharded) and 1M-track
all-pairs dedup uses parallel.dedup.ring_dedup_topk.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.models.fingerprint import Fingerprint
from lbaudiodetective.ops.extract import bucket_subfingerprints
from lbaudiodetective.ops.match_packed import (
    match_one_vs_many_packed, pack_bits_device)
from lbaudiodetective.utils import packing, serialize


def stack_query_planes(queries: list[Fingerprint], s: int
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack query fingerprints into zero-padded ``[B, s, pairs]`` uint8
    planes + ``[B]`` counts (clamped to ``s``) — the one place the
    query-padding/truncation semantics live (single-device and sharded
    matchers all feed from it)."""
    b = len(queries)
    pairs = queries[0].pairs
    qp = np.zeros((b, s, pairs), np.uint8)
    qn = np.zeros_like(qp)
    nq = np.zeros(b, np.int32)
    for i, q in enumerate(queries):
        n = min(q.num_subfingerprints, s)
        nq[i] = n
        qp[i, :n] = q.pos[:n]
        qn[i, :n] = q.neg[:n]
    return qp, qn, nq


class FingerprintLibrary:
    def __init__(self, pos_words, neg_words, counts, pairs: int,
                 config: FingerprintConfig | None = None):
        self.config = config or FingerprintConfig()
        self.pos_words = jnp.asarray(pos_words)      # [L, S, W] uint32
        self.neg_words = jnp.asarray(neg_words)
        self.counts = jnp.asarray(counts)            # [L] int32
        self.pairs = pairs
        self._coarse_cache: dict = {}                # stride -> strided planes

    # -- construction --------------------------------------------------------

    @classmethod
    def from_fingerprints(cls, fps: list[Fingerprint],
                          config: FingerprintConfig | None = None
                          ) -> "FingerprintLibrary":
        if not fps:
            raise ValueError("empty library")
        pairs = fps[0].pairs
        s_max = bucket_subfingerprints(max(f.num_subfingerprints for f in fps))
        w = packing.words_per_plane(pairs)
        pos = np.zeros((len(fps), s_max, w), np.uint32)
        neg = np.zeros((len(fps), s_max, w), np.uint32)
        counts = np.zeros(len(fps), np.int32)
        for i, f in enumerate(fps):
            pw, nw = f.packed()
            counts[i] = f.num_subfingerprints
            pos[i, :pw.shape[0]] = pw
            neg[i, :nw.shape[0]] = nw
        return cls(pos, neg, counts, pairs, config)

    def __len__(self) -> int:
        return int(self.pos_words.shape[0])

    def extend(self, fps: list[Fingerprint]) -> "FingerprintLibrary":
        """A new library with ``fps`` appended (incremental enrollment —
        the essay's server grows its DB as new birds are submitted, PDF
        §3.2.5).  Existing packed entries are reused; only the new
        fingerprints are packed, and the subfingerprint axis re-pads to the
        larger bucket when a new entry is longer."""
        if not fps:
            return self
        pairs = self.pairs
        if any(f.pairs != pairs for f in fps):
            raise ValueError("fingerprint pair count mismatch")
        s_old = int(self.pos_words.shape[1])
        s_max = max(s_old,
                    bucket_subfingerprints(max(f.num_subfingerprints for f in fps)))
        w = packing.words_per_plane(pairs)
        n_new = len(fps)
        pos = np.zeros((len(self) + n_new, s_max, w), np.uint32)
        neg = np.zeros_like(pos)
        pos[:len(self), :s_old] = np.asarray(self.pos_words)
        neg[:len(self), :s_old] = np.asarray(self.neg_words)
        counts = np.zeros(len(self) + n_new, np.int32)
        counts[:len(self)] = np.asarray(self.counts)
        for i, f in enumerate(fps):
            pw, nw = f.packed()
            counts[len(self) + i] = f.num_subfingerprints
            pos[len(self) + i, :pw.shape[0]] = pw
            neg[len(self) + i, :nw.shape[0]] = nw
        return FingerprintLibrary(pos, neg, counts, pairs, self.config)

    # -- matching -------------------------------------------------------------

    def _coarse_planes(self, coarse_stride: int, chunk: int):
        """Strided + chunk-padded library planes for the coarse pass, cached
        per (stride, chunk).  Returns ``(lp_c, ln_c, cnt_c, chunk)`` with
        ``chunk`` clamped so tiny libraries are not padded up."""
        chunk = min(chunk, len(self))
        key = (coarse_stride, chunk)
        if key not in self._coarse_cache:
            pad = (-len(self)) % chunk
            self._coarse_cache[key] = (
                jnp.pad(self.pos_words[:, ::coarse_stride],
                        ((0, pad), (0, 0), (0, 0))),
                jnp.pad(self.neg_words[:, ::coarse_stride],
                        ((0, pad), (0, 0), (0, 0))),
                jnp.pad(-(-self.counts // coarse_stride), (0, pad)))
        return (*self._coarse_cache[key], chunk)

    def match(self, query: Fingerprint, comparison_range: int = 0,
              chunk: int = 65536) -> np.ndarray:
        """``[L]`` match scores of a query against every entry.

        Entries are processed in ``chunk``-sized blocks so the transient
        [chunk, S, Sq] hit tensor stays bounded — a 1M-track library (2.1 GB
        packed) searches on a single chip.
        """
        self.config.warn_if_unvalidated_for_identification()
        s = int(self.pos_words.shape[1])
        n = min(query.num_subfingerprints, s)
        qp = np.zeros((s, query.pairs), np.uint8)
        qn = np.zeros((s, query.pairs), np.uint8)
        qp[:n] = query.pos[:n]
        qn[:n] = query.neg[:n]
        qpw = pack_bits_device(jnp.asarray(qp))
        qnw = pack_bits_device(jnp.asarray(qn))
        l = len(self)
        if l <= chunk:
            scores = match_one_vs_many_packed(
                qpw, qnw, jnp.int32(n), self.pos_words, self.neg_words,
                self.counts, self.pairs, comparison_range,
                self.config.subfingerprint_length)
            return np.asarray(scores)
        out = np.empty(l, np.float32)
        # Pad the final partial block so every dispatch shares one compile.
        for start in range(0, l, chunk):
            end = min(start + chunk, l)
            if end - start == chunk:
                lp, ln, cnt = (self.pos_words[start:end],
                               self.neg_words[start:end], self.counts[start:end])
            else:
                pad = chunk - (end - start)
                lp = jnp.pad(self.pos_words[start:end], ((0, pad), (0, 0), (0, 0)))
                ln = jnp.pad(self.neg_words[start:end], ((0, pad), (0, 0), (0, 0)))
                cnt = jnp.pad(self.counts[start:end], (0, pad))
            scores = match_one_vs_many_packed(
                qpw, qnw, jnp.int32(n), lp, ln, cnt, self.pairs,
                comparison_range, self.config.subfingerprint_length)
            out[start:end] = np.asarray(scores)[: end - start]
        return out

    def match_many(self, queries: list[Fingerprint],
                   comparison_range: int = 0) -> np.ndarray:
        """``[B, L]`` match scores of B queries against every entry in ONE
        vmapped device dispatch (the packed popcount matcher batched over
        the query axis) — the serving batcher's match stage."""
        import jax

        self.config.warn_if_unvalidated_for_identification()
        if not queries:
            return np.zeros((0, len(self)), np.float32)
        s = int(self.pos_words.shape[1])
        qp, qn, nq = stack_query_planes(queries, s)
        qpw = pack_bits_device(jnp.asarray(qp))
        qnw = pack_bits_device(jnp.asarray(qn))
        batched = jax.vmap(match_one_vs_many_packed,
                           in_axes=(0, 0, 0, None, None, None, None, None,
                                    None))
        scores = batched(qpw, qnw, jnp.asarray(nq),
                         self.pos_words, self.neg_words, self.counts,
                         self.pairs, comparison_range,
                         self.config.subfingerprint_length)
        return np.asarray(scores)

    def identify(self, query: Fingerprint, comparison_range: int = 0
                 ) -> tuple[int, float]:
        """(best entry index, score)."""
        scores = self.match(query, comparison_range)
        best = int(np.argmax(scores))
        return best, float(scores[best])

    def search(self, query: Fingerprint, top_k: int = 5,
               comparison_range: int = 0, shortlist: int = 1024,
               coarse_range: int = 64, coarse_stride: int = 4,
               chunk: int = 65536, coarse_phases: int | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
        """Two-stage library search: coarse shortlist, exact re-score.

        The coarse pass runs the packed matcher over every
        ``coarse_stride``-th subfingerprint with ``coarse_range`` booleans
        compared (the reference's own comparison-range semantics,
        LBAudioDetective.h:210-235 / LBAudioDetectiveFingerprint.m:151-176;
        a short range statically skips whole uint32 words in the popcount,
        and the stride quantises the offset slide), shortlisting
        ``shortlist`` candidates that are then re-scored EXACTLY with the
        full matcher.  Returns ``(indices[top_k], scores[top_k])`` sorted
        by descending exact score.

        The returned scores are exact; ranking is exact whenever the true
        top-k survive the shortlist.  The coarse pass scans ALL
        ``coarse_stride`` phase shifts of the strided query by default
        (``coarse_phases=None``), so recall does not depend on the query's
        subfingerprint offset modulo the stride — the measured failure
        mode of the phase-0-only coarse (``coarse_phases=1``, which
        remains available as the cheap legacy behaviour); see
        ops.match_packed.phase_strided_query_planes and
        tests/test_search_recall.py for the planted-near-duplicate
        measurements.

        The whole coarse-scan -> on-device top-k -> gather -> exact
        re-score chain is ONE jitted dispatch
        (ops.match_packed.two_stage_search_packed); only the final
        [top_k] pair crosses to the host — essential over a high-latency
        link, where a host-chunked coarse loop measured slower than even
        the full scan.
        """
        self.config.warn_if_unvalidated_for_identification()
        l = len(self)
        top_k = min(top_k, l)
        if l <= shortlist:
            scores = self.match(query, comparison_range, chunk=chunk)
            idx = np.argsort(-scores, kind="stable")[:top_k]
            return idx.astype(np.int64), scores[idx]
        from lbaudiodetective.ops.match_packed import two_stage_search_packed

        # The exact stage re-scores `shortlist` candidates, so the two-stage
        # path can return at most that many.
        top_k = min(top_k, shortlist)
        s = int(self.pos_words.shape[1])
        n = min(query.num_subfingerprints, s)
        qp = np.zeros((s, query.pairs), np.uint8)
        qn = np.zeros((s, query.pairs), np.uint8)
        qp[:n] = query.pos[:n]
        qn[:n] = query.neg[:n]
        lp_c, ln_c, cnt_c, chunk = self._coarse_planes(coarse_stride, chunk)
        from lbaudiodetective.ops.match_packed import (
            phase_strided_query_planes)

        qcp, qcn, nc = phase_strided_query_planes(qp, qn, n, coarse_stride,
                                                  coarse_phases)
        idx, scores = two_stage_search_packed(
            pack_bits_device(jnp.asarray(qp)), pack_bits_device(jnp.asarray(qn)),
            jnp.int32(n),
            pack_bits_device(jnp.asarray(qcp)),
            pack_bits_device(jnp.asarray(qcn)),
            jnp.asarray(nc),
            self.pos_words, self.neg_words, self.counts,
            lp_c, ln_c, cnt_c,
            self.pairs, comparison_range, self.config.subfingerprint_length,
            coarse_range, chunk, shortlist, top_k)
        return np.asarray(idx).astype(np.int64), np.asarray(scores)

    def search_many(self, queries: list[Fingerprint], top_k: int = 5,
                    comparison_range: int = 0, shortlist: int = 1024,
                    coarse_range: int = 64, coarse_stride: int = 4,
                    chunk: int = 65536, coarse_phases: int | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched ``search``: B queries in one vmapped dispatch ->
        ``(indices [B, top_k], exact scores [B, top_k])`` — the serving
        batcher's large-library stage."""
        import jax

        from lbaudiodetective.ops.match_packed import (
            two_stage_search_packed)

        self.config.warn_if_unvalidated_for_identification()
        if not queries:
            return (np.zeros((0, top_k), np.int64),
                    np.zeros((0, top_k), np.float32))
        l = len(self)
        if l <= shortlist:
            scores = self.match_many(queries, comparison_range)
            idx = np.argsort(-scores, axis=1, kind="stable")[:, :top_k]
            return (idx.astype(np.int64),
                    np.take_along_axis(scores, idx, axis=1))
        top_k = min(top_k, l, shortlist)
        s = int(self.pos_words.shape[1])
        qp, qn, nq = stack_query_planes(queries, s)
        lp_c, ln_c, cnt_c, chunk = self._coarse_planes(coarse_stride, chunk)

        def one(qpw, qnw, n, qcp, qcn, n_c):
            return two_stage_search_packed(
                qpw, qnw, n, qcp, qcn, n_c,
                self.pos_words, self.neg_words, self.counts,
                lp_c, ln_c, cnt_c,
                self.pairs, comparison_range,
                self.config.subfingerprint_length,
                coarse_range, chunk, shortlist, top_k)

        from lbaudiodetective.ops.match_packed import (
            phase_strided_query_planes)

        qcp, qcn, nc = phase_strided_query_planes(qp, qn, nq, coarse_stride,
                                                  coarse_phases)
        idx, scores = jax.vmap(one)(
            pack_bits_device(jnp.asarray(qp)),
            pack_bits_device(jnp.asarray(qn)),
            jnp.asarray(nq),
            pack_bits_device(jnp.asarray(qcp)),
            pack_bits_device(jnp.asarray(qcn)),
            jnp.asarray(nc))
        return np.asarray(idx).astype(np.int64), np.asarray(scores)

    # -- persistence ----------------------------------------------------------

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, version=np.int32(serialize.FORMAT_VERSION),
            pos=np.asarray(self.pos_words), neg=np.asarray(self.neg_words),
            counts=np.asarray(self.counts), pairs=np.int32(self.pairs),
            subfingerprint_length=np.int32(self.config.subfingerprint_length),
            params_hash=np.bytes_(
                serialize.config_params_hash(self.config).encode()))

    @classmethod
    def load(cls, path: str, config: FingerprintConfig | None = None
             ) -> "FingerprintLibrary":
        with np.load(path) as z:
            if config is not None:
                stored = bytes(z["params_hash"]).decode()
                if stored != serialize.config_params_hash(config):
                    raise ValueError("library parameter hash mismatch")
            else:
                # Without a caller config, at minimum honour the stored
                # subfingerprint length — a library built at a non-default
                # length must not silently match over the wrong pair count.
                stored_len = int(z["subfingerprint_length"])
                if stored_len != FingerprintConfig().subfingerprint_length:
                    config = FingerprintConfig(subfingerprint_length=stored_len)
            return cls(z["pos"], z["neg"], z["counts"], int(z["pairs"]), config)
