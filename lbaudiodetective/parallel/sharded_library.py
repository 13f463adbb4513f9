"""ShardedFingerprintLibrary: a FingerprintLibrary distributed over a mesh.

The pod-serving form of the essay's server-side fingerprint DB (PDF
§3.2.5): the packed uint32 bit planes shard over the mesh ``"library"``
axis (the only format that fits 1M tracks per pod — ops/match_packed.py),
queries replicate, and every device matches its resident shard in place.
Duck-type compatible with :class:`~lbaudiodetective.models.library.
FingerprintLibrary` for the serving edge (``len``, ``match``, ``search``,
``match_many``, ``search_many``), so
:class:`~lbaudiodetective.serving.IdentificationService` serves a
sharded library unchanged.

Scores are exactly equal to the single-device library (the shard_map
paths are tested score-equal to the unpacked mesh paths AND the scalar
oracle in tests/test_sharded_packed.py; this wrapper's padding/trimming is
tested in tests/test_sharded_library.py).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lbaudiodetective.models.fingerprint import Fingerprint
from lbaudiodetective.models.library import (FingerprintLibrary,
                                             stack_query_planes)
from lbaudiodetective.ops.match_packed import pack_bits_device
from lbaudiodetective.parallel.sharded_packed import (
    match_library_sharded_packed, search_library_sharded_packed)


class ShardedFingerprintLibrary:
    """Wrap a :class:`FingerprintLibrary` with its entry axis sharded over
    ``mesh``'s ``"library"`` axis.

    The entry axis is zero-padded to a multiple of the library-axis size
    (padded entries carry count 0 and can never win: the matcher scores
    them 0); all padded/placed arrays are device-resident once, at
    construction.
    """

    def __init__(self, library: FingerprintLibrary, mesh: Mesh):
        self.inner = library
        self.mesh = mesh
        self.config = library.config
        self.pairs = library.pairs
        self._l = len(library)
        n_sh = mesh.shape["library"]
        pad = (-self._l) % n_sh
        lib_sh = NamedSharding(mesh, P("library", None, None))
        cnt_sh = NamedSharding(mesh, P("library"))
        self.pos_words = jax.device_put(
            jnp.pad(library.pos_words, ((0, pad), (0, 0), (0, 0))), lib_sh)
        self.neg_words = jax.device_put(
            jnp.pad(library.neg_words, ((0, pad), (0, 0), (0, 0))), lib_sh)
        self.counts = jax.device_put(jnp.pad(library.counts, (0, pad)), cnt_sh)
        self._coarse_cache: dict = {}

    def __len__(self) -> int:
        return self._l

    # -- persistence (pod restart path) --------------------------------------

    def save_sharded(self, dir_path: str, n_shards: int | None = None) -> None:
        """Persist as the utils.serialize sharded mmap DB (default: one
        shard file per library-axis device, so a restarting host can
        re-attach exactly its slice — tests/test_distributed.py flow)."""
        from lbaudiodetective.utils import serialize

        serialize.save_library_sharded_planes(
            dir_path, np.asarray(self.inner.pos_words),
            np.asarray(self.inner.neg_words), np.asarray(self.inner.counts),
            self.pairs, self.config.subfingerprint_length, self.config,
            n_shards or self.mesh.shape["library"])

    @classmethod
    def load_sharded(cls, dir_path: str, mesh: Mesh,
                     config=None) -> "ShardedFingerprintLibrary":
        """Re-attach an on-disk sharded DB to a mesh (any shard count —
        planes are concatenated, trimmed to the true entry count, and
        re-sharded over the mesh's library axis)."""
        import json

        from lbaudiodetective.utils.serialize import load_library_shard

        with open(f"{dir_path}/manifest.json") as f:
            manifest = json.load(f)
        parts = [load_library_shard(dir_path, s, config)[:3]
                 for s in range(manifest["n_shards"])]
        l = manifest["entries"]
        lib = FingerprintLibrary(
            np.concatenate([p[0] for p in parts])[:l],
            np.concatenate([p[1] for p in parts])[:l],
            np.concatenate([p[2] for p in parts])[:l],
            manifest["pairs"], config)
        return cls(lib, mesh)

    # -- internals -----------------------------------------------------------

    def _query_planes(self, query: Fingerprint, stride: int = 1,
                      phases: int | None = None, coarse: bool = False):
        s = int(self.pos_words.shape[1])
        n = min(query.num_subfingerprints, s)
        qp = np.zeros((s, query.pairs), np.uint8)
        qn = np.zeros((s, query.pairs), np.uint8)
        qp[:n] = query.pos[:n]
        qn[:n] = query.neg[:n]
        if coarse:
            # Phase-robust coarse query planes (leading phase axis, present
            # even at stride 1) — see
            # ops.match_packed.phase_strided_query_planes.
            from lbaudiodetective.ops.match_packed import (
                phase_strided_query_planes)

            qcp, qcn, nc = phase_strided_query_planes(qp, qn, n, stride,
                                                      phases)
            return (pack_bits_device(jnp.asarray(qcp)),
                    pack_bits_device(jnp.asarray(qcn)), jnp.asarray(nc))
        return (pack_bits_device(jnp.asarray(qp)),
                pack_bits_device(jnp.asarray(qn)), jnp.int32(n))

    def _coarse_planes(self, stride: int):
        if stride <= 1:
            # stride 1 would duplicate the whole packed library on the mesh.
            return self.pos_words, self.neg_words, self.counts
        if stride not in self._coarse_cache:
            lib_sh = NamedSharding(self.mesh, P("library", None, None))
            cnt_sh = NamedSharding(self.mesh, P("library"))
            self._coarse_cache[stride] = (
                jax.device_put(self.pos_words[:, ::stride], lib_sh),
                jax.device_put(self.neg_words[:, ::stride], lib_sh),
                jax.device_put(-(-self.counts // stride), cnt_sh))
        return self._coarse_cache[stride]

    # -- FingerprintLibrary surface ------------------------------------------

    def match(self, query: Fingerprint, comparison_range: int = 0
              ) -> np.ndarray:
        """``[L]`` scores of a query against every entry, each shard matched
        in place on its own device."""
        self.config.warn_if_unvalidated_for_identification()
        qpw, qnw, n = self._query_planes(query)
        scores = match_library_sharded_packed(
            qpw, qnw, n, self.pos_words, self.neg_words, self.counts,
            self.pairs, self.mesh, comparison_range,
            self.config.subfingerprint_length)
        return np.asarray(scores)[: self._l]

    def match_many(self, queries: list[Fingerprint],
                   comparison_range: int = 0) -> np.ndarray:
        """``[B, L]`` scores for B queries in ONE mesh dispatch (each shard
        vmaps the popcount matcher over the query batch)."""
        from lbaudiodetective.parallel.sharded_packed import (
            match_many_library_sharded_packed)

        if not queries:
            return np.zeros((0, self._l), np.float32)
        self.config.warn_if_unvalidated_for_identification()
        s = int(self.pos_words.shape[1])
        qp, qn, nq = stack_query_planes(queries, s)
        scores = match_many_library_sharded_packed(
            pack_bits_device(jnp.asarray(qp)), pack_bits_device(jnp.asarray(qn)),
            jnp.asarray(nq), self.pos_words, self.neg_words, self.counts,
            self.pairs, self.mesh, comparison_range,
            self.config.subfingerprint_length)
        return np.asarray(scores)[:, : self._l]

    def identify(self, query: Fingerprint, comparison_range: int = 0
                 ) -> tuple[int, float]:
        scores = self.match(query, comparison_range)
        best = int(np.argmax(scores))
        return best, float(scores[best])

    def search(self, query: Fingerprint, top_k: int = 5,
               comparison_range: int = 0, shortlist: int = 1024,
               coarse_range: int = 64, coarse_stride: int = 4,
               chunk: int = 65536, coarse_phases: int | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
        """Two-stage coarse->exact search, each shard shortlisting and
        re-scoring its residents; global merge host-side.  Same recall
        property as the single-device search, per shard (phase-robust
        coarse by default, see FingerprintLibrary.search)."""
        self.config.warn_if_unvalidated_for_identification()
        top_k = min(top_k, self._l)
        qpw, qnw, n = self._query_planes(query)
        qcp, qcn, nc = self._query_planes(query, coarse_stride,
                                          coarse_phases, coarse=True)
        lcp, lcn, cnt_c = self._coarse_planes(coarse_stride)
        n_sh = self.mesh.shape["library"]
        # Ask each shard for enough candidates that padded entries (count 0,
        # score 0) can be dropped without starving the global top-k.
        idx, sc = search_library_sharded_packed(
            qpw, qnw, n, qcp, qcn, nc,
            self.pos_words, self.neg_words, self.counts, lcp, lcn, cnt_c,
            self.pairs, self.mesh, comparison_range,
            self.config.subfingerprint_length, coarse_range, chunk,
            shortlist, top_k=top_k + (-self._l) % n_sh)
        real = idx < self._l
        return idx[real][:top_k], sc[real][:top_k]

    def search_many(self, queries: list[Fingerprint], top_k: int = 5,
                    comparison_range: int = 0, shortlist: int = 1024,
                    coarse_range: int = 64, coarse_stride: int = 4,
                    chunk: int = 65536, coarse_phases: int | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched search: B queries in ONE mesh dispatch (each shard vmaps
        the fused two-stage search over the query batch)."""
        from lbaudiodetective.parallel.sharded_packed import (
            search_many_library_sharded_packed)

        if not queries:
            return (np.zeros((0, top_k), np.int64),
                    np.zeros((0, top_k), np.float32))
        self.config.warn_if_unvalidated_for_identification()
        top_k = min(top_k, self._l)
        s = int(self.pos_words.shape[1])
        b = len(queries)
        qp, qn, nq = stack_query_planes(queries, s)
        qpw = pack_bits_device(jnp.asarray(qp))
        qnw = pack_bits_device(jnp.asarray(qn))
        from lbaudiodetective.ops.match_packed import (
            phase_strided_query_planes)

        qcp_u, qcn_u, nc = phase_strided_query_planes(qp, qn, nq,
                                                      coarse_stride,
                                                      coarse_phases)
        qcp = pack_bits_device(jnp.asarray(qcp_u))
        qcn = pack_bits_device(jnp.asarray(qcn_u))
        lcp, lcn, cnt_c = self._coarse_planes(coarse_stride)
        n_sh = self.mesh.shape["library"]
        k_ask = top_k + (-self._l) % n_sh       # padded entries filtered below
        idx, sc = search_many_library_sharded_packed(
            qpw, qnw, jnp.asarray(nq), qcp, qcn,
            jnp.asarray(nc),
            self.pos_words, self.neg_words, self.counts, lcp, lcn, cnt_c,
            self.pairs, self.mesh, comparison_range,
            self.config.subfingerprint_length, coarse_range, chunk,
            shortlist, top_k=k_ask)
        out_i = np.zeros((b, top_k), np.int64)
        out_s = np.zeros((b, top_k), np.float32)
        for i in range(b):
            real = idx[i] < self._l
            out_i[i] = idx[i][real][:top_k]
            out_s[i] = sc[i][real][:top_k]
        return out_i, out_s
