"""Pipeline parallelism: overlapped decode -> extract -> match batches.

SURVEY §2.3 lists PP as the stage-split axis (decode/extract/match saturate
different resources: host IO, and the device's matmul and vector units).  JAX dispatch
is asynchronous, so a host-side software pipeline gets stage overlap without
explicit device partitioning: while batch k's extraction executes on device,
batch k-1's match is already enqueued behind it and batch k+1 is decoding on
the host.  On a multi-device mesh the extract and match stages can
additionally live on disjoint device sets via their shardings (see
parallel.sharded); this module provides the orchestration loop.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

import jax
import jax.numpy as jnp

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.ops.extract import (
    bucket_subfingerprints, extract_fingerprint_padded, required_padded_length,
    rows_for_subfingerprints)
from lbaudiodetective.ops.match import match_one_vs_many_padded


class PipelinedIdentifier:
    """Identify a stream of decoded clip batches against a fingerprint library
    with decode/extract/match stage overlap.

    ``library``: padded (pos, neg, counts) arrays ``[L, S, pairs]`` / ``[L]``.
    Feed batches with :meth:`submit`; completed results pop out one batch
    late (a classic two-deep software pipeline); :meth:`drain` flushes.
    """

    def __init__(self, library_pos, library_neg, library_counts,
                 config: FingerprintConfig | None = None,
                 comparison_range: int = 0):
        self.config = config or FingerprintConfig()
        self.lib_pos = jnp.asarray(library_pos)
        self.lib_neg = jnp.asarray(library_neg)
        self.lib_counts = jnp.asarray(library_counts)
        self.s_lib = int(self.lib_pos.shape[1])
        self.comparison_range = comparison_range
        self._pending = None  # (scores device array, batch metadata)

    def _extract(self, audio_batch: np.ndarray, n_subs: np.ndarray):
        cfg = self.config
        bucket = bucket_subfingerprints(int(n_subs.max(initial=1)))
        n_rows = rows_for_subfingerprints(cfg, bucket)
        t_pad = required_padded_length(cfg, n_rows)
        batch = np.zeros((audio_batch.shape[0], t_pad), np.float32)
        t = min(audio_batch.shape[1], t_pad)
        batch[:, :t] = audio_batch[:, :t]
        return extract_fingerprint_padded(
            jnp.asarray(batch), jnp.asarray(n_subs.astype(np.int32)), cfg, n_rows)

    def _match(self, pos, neg, n_subs):
        cfg = self.config
        s = max(self.s_lib, pos.shape[1])

        def pad(a):
            return jnp.pad(a, ((0, 0), (0, s - a.shape[1]), (0, 0)))

        pos, neg = pad(pos), pad(neg)
        lib_pos = jnp.pad(self.lib_pos, ((0, 0), (0, s - self.s_lib), (0, 0)))
        lib_neg = jnp.pad(self.lib_neg, ((0, 0), (0, s - self.s_lib), (0, 0)))
        # One dispatch for the whole batch (a per-clip Python loop would pay
        # the dispatch overhead B times and serialise the matmuls).
        batched = jax.vmap(match_one_vs_many_padded,
                           in_axes=(0, 0, 0, None, None, None, None, None))
        return batched(pos, neg, n_subs, lib_pos, lib_neg, self.lib_counts,
                       self.comparison_range, cfg.subfingerprint_length)  # [B, L]

    def submit(self, audio_batch: np.ndarray, n_subs: np.ndarray):
        """Enqueue one batch; returns the PREVIOUS batch's scores (or None).

        Both stages dispatch asynchronously — the host returns before the
        device finishes, so decode(k+1) / extract(k) / match(k-1) overlap.
        """
        pos, neg = self._extract(audio_batch, n_subs)
        scores = self._match(pos, neg, jnp.asarray(n_subs.astype(np.int32)))
        out, self._pending = self._pending, scores
        return None if out is None else np.asarray(out)

    def drain(self):
        """Flush the last in-flight batch."""
        out, self._pending = self._pending, None
        return None if out is None else np.asarray(out)

    def run(self, batches: Iterable[tuple[np.ndarray, np.ndarray]]
            ) -> Iterator[np.ndarray]:
        for audio, n_subs in batches:
            out = self.submit(audio, n_subs)
            if out is not None:
                yield out
        tail = self.drain()
        if tail is not None:
            yield tail


class DeviceSplitPipeline:
    """True device-split pipeline parallelism: extraction runs data-parallel
    on one device subset while matching runs library-sharded on a DISJOINT
    subset (SURVEY §2.3 PP row: the stages saturate different resources, so
    on a pod they can own different chips).

    Stage handoff is an explicit ``jax.device_put`` of the extracted bit
    planes from the extract submesh to the match submesh (ICI on hardware).
    All dispatch is asynchronous, so while batch k matches on the match
    devices, batch k+1 is already extracting on the extract devices — the
    same two-deep software pipeline as :class:`PipelinedIdentifier`, but
    with genuinely disjoint stage placement.
    """

    def __init__(self, library_pos, library_neg, library_counts,
                 extract_devices, match_devices,
                 config: FingerprintConfig | None = None,
                 comparison_range: int = 0):
        import functools

        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        if set(extract_devices) & set(match_devices):
            raise ValueError("extract/match device sets must be disjoint")
        if len(library_pos) % len(match_devices):
            raise ValueError("library size must divide the match submesh")
        self.config = config or FingerprintConfig()
        self.comparison_range = comparison_range
        self.mesh_x = Mesh(np.array(extract_devices), ("data",))
        self.mesh_m = Mesh(np.array(match_devices), ("library",))
        lib_sh = NamedSharding(self.mesh_m, P("library", None, None))
        self._rep_m = NamedSharding(self.mesh_m, P())
        self._x_in = NamedSharding(self.mesh_x, P("data", None))
        self._x_cnt = NamedSharding(self.mesh_x, P("data"))
        self._x_out = NamedSharding(self.mesh_x, P("data", None, None))
        self.lib_pos = jax.device_put(jnp.asarray(library_pos), lib_sh)
        self.lib_neg = jax.device_put(jnp.asarray(library_neg), lib_sh)
        self.lib_counts = jax.device_put(
            jnp.asarray(library_counts), NamedSharding(self.mesh_m, P("library")))
        self.s_lib = int(self.lib_pos.shape[1])
        self._pending = None
        # jit wrappers cached per static bucket (n_rows / padded S): a fresh
        # jax.jit per submit would retrace+recompile every batch and
        # serialise the host against the compiler, destroying the async
        # stage overlap.
        self._extract_fns: dict[int, object] = {}
        self._padded_lib: dict[int, tuple] = {}
        self._functools = functools

    def _extract_fn(self, n_rows: int):
        if n_rows not in self._extract_fns:
            self._extract_fns[n_rows] = jax.jit(
                self._functools.partial(extract_fingerprint_padded,
                                        config=self.config, n_rows=n_rows),
                in_shardings=(self._x_in, self._x_cnt),
                out_shardings=(self._x_out, self._x_out))
        return self._extract_fns[n_rows]

    def _extract(self, audio_batch: np.ndarray, n_subs: np.ndarray):
        cfg = self.config
        bucket = bucket_subfingerprints(int(n_subs.max(initial=1)))
        n_rows = rows_for_subfingerprints(cfg, bucket)
        t_pad = required_padded_length(cfg, n_rows)
        batch = np.zeros((audio_batch.shape[0], t_pad), np.float32)
        t = min(audio_batch.shape[1], t_pad)
        batch[:, :t] = audio_batch[:, :t]
        return self._extract_fn(n_rows)(jnp.asarray(batch),
                                        jnp.asarray(n_subs.astype(np.int32)))

    def _match(self, pos, neg, n_subs):
        cfg = self.config
        s = max(self.s_lib, pos.shape[1])

        def padq(a):
            return jnp.pad(a, ((0, 0), (0, s - a.shape[1]), (0, 0)))

        # Stage handoff: extract-submesh output -> replicated on the match
        # submesh (device-to-device, async).
        pos = jax.device_put(padq(pos), self._rep_m)
        neg = jax.device_put(padq(neg), self._rep_m)
        n_subs = jax.device_put(jnp.asarray(n_subs.astype(np.int32)),
                                self._rep_m)
        if s not in self._padded_lib:   # padded once per S bucket, resident
            self._padded_lib[s] = (
                jnp.pad(self.lib_pos, ((0, 0), (0, s - self.s_lib), (0, 0))),
                jnp.pad(self.lib_neg, ((0, 0), (0, s - self.s_lib), (0, 0))))
        lib_pos, lib_neg = self._padded_lib[s]
        batched = jax.vmap(match_one_vs_many_padded,
                           in_axes=(0, 0, 0, None, None, None, None, None))
        return batched(pos, neg, n_subs, lib_pos, lib_neg, self.lib_counts,
                       self.comparison_range, cfg.subfingerprint_length)

    def submit(self, audio_batch: np.ndarray, n_subs: np.ndarray):
        """Enqueue one batch; returns the PREVIOUS batch's scores (or None)."""
        pos, neg = self._extract(audio_batch, n_subs)
        scores = self._match(pos, neg, n_subs)
        out, self._pending = self._pending, scores
        return None if out is None else np.asarray(out)

    def drain(self):
        out, self._pending = self._pending, None
        return None if out is None else np.asarray(out)
