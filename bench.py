"""Benchmark harness: prints ONE JSON line on stdout.

Primary metric: 10-second clips fingerprinted per second on one GPU in the
*parity* configuration (hop_domain='file', the calibrated reference-faithful
mode: ~6850 spectrogram rows / 53 subfingerprints per 10 s clip).

Secondary metrics (written to bench_details.json): spec-corrected 'proc'
hop mode throughput (8x fewer rows — what a fresh deployment would run),
fingerprint pair-compare throughput one-vs-library, and subfingerprint
compare rate.  Every result names the device it ran on; without a GPU the
harness exits non-zero and measures nothing.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp


def require_gpu() -> dict:
    """The device record of this run; exits non-zero when JAX finds no GPU
    (a CPU timing is not a measurement of this system)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: no GPU found (JAX platform {dev.platform!r})",
              file=sys.stderr)
        sys.exit(1)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def load_details(device: dict) -> dict:
    """The merge-in-place bench_details.json artifact, stamped with this
    run's device and JAX version."""
    try:
        with open("bench_details.json") as f:
            details = json.load(f)
    except (OSError, json.JSONDecodeError):
        details = {}
    details.update({"device": device, "jax": jax.__version__})
    return details


#: Parity clips per benchmark dispatch.  The conv path's compiled step needs
#: about 70 MB of device memory per parity clip on an H100 (PERF.md), so 512
#: clips (~36 GB) fit in the 60 GB a JAX process reserves of an 80 GB card.
PARITY_BATCH = 512


def _synth_clips(batch: int, t_pad: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # Band-limited noise-ish audio: white noise through a crude lowpass.
    x = rng.standard_normal((batch, t_pad)).astype(np.float32) * 0.1
    return np.cumsum(x, axis=1) * 0.05  # brownish spectrum, nonzero bands


def _timed(fn, iters: int):
    """Mean seconds per ``fn()`` call: two warm-up calls (compilation), then
    ``iters`` back-to-back dispatches, waiting for the last result with
    ``block_until_ready`` (one device stream runs them in order)."""
    for _ in range(2):
        jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def bench_extract(config, batch: int, clip_seconds: float = 10.0, iters: int = 20):
    from lbaudiodetective.ops.extract import (
        bucket_subfingerprints, extract_fingerprint_padded,
        required_padded_length)

    file_frames = int(clip_seconds * config.file_sample_rate)
    proc_frames = int(clip_seconds * config.processing_sample_rate)
    n_sub = config.num_subfingerprints(file_frames, proc_frames)
    n_rows = bucket_subfingerprints(n_sub) * config.rows_per_frame
    t_pad = required_padded_length(config, n_rows)
    audio = jnp.asarray(_synth_clips(batch, t_pad))
    n_subs = jnp.full((batch,), n_sub, jnp.int32)

    def step():
        return extract_fingerprint_padded(audio, n_subs, config, n_rows)

    dt = _timed(step, iters)
    return batch / dt, dt


def make_bench_match(config, library_size: int, s_max: int = 64):
    """Pinned standard config: query = s_max//2 valid subfingerprints vs a
    library of full-length (s_max) entries — a ~5 s query against ~10 s
    tracks, library size 16384.

    Returns a ``run(iters) -> (pair_cps, sub_cps, dt)`` closure over
    device-resident arrays: the ~210 MB library uploads ONCE.
    """
    from lbaudiodetective.ops.match import match_one_vs_many_padded

    rng = np.random.default_rng(1)
    pairs = config.num_wavelet_pairs
    cls = rng.choice(3, size=(library_size, s_max, pairs))
    lib_pos = jnp.asarray((cls == 1).astype(np.uint8))
    lib_neg = jnp.asarray((cls == 2).astype(np.uint8))
    n_lib = jnp.full((library_size,), s_max, jnp.int32)
    qcls = rng.choice(3, size=(s_max, pairs))
    q_pos = jnp.asarray((qcls == 1).astype(np.uint8))
    q_neg = jnp.asarray((qcls == 2).astype(np.uint8))
    nq = jnp.int32(s_max // 2)

    def step():
        return match_one_vs_many_padded(
            q_pos, q_neg, nq, lib_pos, lib_neg, n_lib, 0,
            config.subfingerprint_length)

    def run(iters: int = 30):
        dt = _timed(step, iters)
        pair_compares = library_size / dt               # full offset-slides
        # Subfingerprint-level comparisons: offsets * n2 per pair.
        sub_compares = library_size * (s_max // 2 + 1) * (s_max // 2) / dt
        return pair_compares, sub_compares, dt

    return run


def bench_match(config, library_size: int, s_max: int = 64, iters: int = 30):
    return make_bench_match(config, library_size, s_max)(iters)


def make_bench_match_packed(config, library_size: int, s_max: int = 64):
    """Same pinned matching workload through the packed-bit popcount matcher
    (the HBM-resident path used for big libraries); single upload, reusable
    timed runs (see make_bench_match)."""
    from lbaudiodetective.ops.match_packed import (match_one_vs_many_packed,
                                                   pack_bits_device)

    rng = np.random.default_rng(1)
    pairs = config.num_wavelet_pairs
    cls = rng.choice(3, size=(library_size, s_max, pairs))
    lib_pos_w = pack_bits_device(jnp.asarray((cls == 1).astype(np.uint8)))
    lib_neg_w = pack_bits_device(jnp.asarray((cls == 2).astype(np.uint8)))
    n_lib = jnp.full((library_size,), s_max, jnp.int32)
    qcls = rng.choice(3, size=(s_max, pairs))
    q_pos_w = pack_bits_device(jnp.asarray((qcls == 1).astype(np.uint8)))
    q_neg_w = pack_bits_device(jnp.asarray((qcls == 2).astype(np.uint8)))
    nq = jnp.int32(s_max // 2)

    def step():
        return match_one_vs_many_packed(
            q_pos_w, q_neg_w, nq, lib_pos_w, lib_neg_w, n_lib, pairs,
            0, config.subfingerprint_length)

    def run(iters: int = 30):
        dt = _timed(step, iters)
        return library_size / dt, dt

    return run


def bench_match_packed(config, library_size: int, s_max: int = 64,
                       iters: int = 30):
    return make_bench_match_packed(config, library_size, s_max)(iters)


def bench_packed_64k(config, s_max: int = 64, iters: int = 20):
    """README figure: one query vs a 65536-track packed library."""
    pair_cps, _ = bench_match_packed(config, library_size=65536,
                                     s_max=s_max, iters=iters)
    return pair_cps


def bench_million_track(config, s_max: int = 64, chunk: int = 65536,
                        iters: int = 10):
    """README figure: seconds per query against a 1M-track packed library
    resident on one chip (2 x 1.07 GB uint32 planes), scanned in chunks.

    Library bits are random words (pos/neg overlap is irrelevant to timing);
    the scores themselves are validated against the oracle in
    tests/test_library.py at smaller scale.
    """
    from lbaudiodetective.ops.match_packed import match_one_vs_many_packed
    from lbaudiodetective.utils.packing import words_per_plane

    l = 1_048_576
    pairs = config.num_wavelet_pairs
    w = words_per_plane(pairs)
    rng = np.random.default_rng(5)
    lib_pos = jnp.asarray(rng.integers(0, 2**32, size=(l, s_max, w),
                                       dtype=np.uint32))
    lib_neg = jnp.asarray(rng.integers(0, 2**32, size=(l, s_max, w),
                                       dtype=np.uint32))
    n_lib = jnp.full((chunk,), s_max, jnp.int32)
    q_pos = jnp.asarray(rng.integers(0, 2**32, size=(s_max, w),
                                     dtype=np.uint32))
    q_neg = jnp.asarray(rng.integers(0, 2**32, size=(s_max, w),
                                     dtype=np.uint32))
    nq = jnp.int32(s_max // 2)
    jax.block_until_ready((lib_pos, lib_neg))

    def query():
        best = jnp.float32(0.0)
        for start in range(0, l, chunk):
            scores = match_one_vs_many_packed(
                q_pos, q_neg, nq,
                jax.lax.dynamic_slice(lib_pos, (start, 0, 0),
                                      (chunk, s_max, w)),
                jax.lax.dynamic_slice(lib_neg, (start, 0, 0),
                                      (chunk, s_max, w)),
                n_lib, config.num_wavelet_pairs, 0,
                config.subfingerprint_length)
            best = jnp.maximum(best, jnp.max(scores))
        return best

    dt = _timed(query, iters)
    return dt, l


def bench_million_track_search(config, s_max: int = 64, iters: int = 5):
    """Two-stage coarse->exact search (FingerprintLibrary.search) against the
    same 1M-track packed library: stride-4 / range-64 coarse shortlist of
    1024, exact re-score.  Times the REAL host-driven API (per-chunk
    dispatch + host top-k + device gather re-score), wall-clock, min of
    ``iters``; ranking correctness is asserted in tests/test_library.py."""
    from lbaudiodetective.models.fingerprint import Fingerprint
    from lbaudiodetective.models.library import FingerprintLibrary
    from lbaudiodetective.utils.packing import words_per_plane

    l = 1_048_576
    pairs = config.num_wavelet_pairs
    w = words_per_plane(pairs)
    rng = np.random.default_rng(5)
    lib = FingerprintLibrary(
        rng.integers(0, 2**32, size=(l, s_max, w), dtype=np.uint32),
        rng.integers(0, 2**32, size=(l, s_max, w), dtype=np.uint32),
        np.full(l, s_max, np.int32), pairs, config)
    jax.block_until_ready((lib.pos_words, lib.neg_words))
    pos = (rng.random((s_max, pairs)) < 0.45).astype(np.uint8)
    neg = ((rng.random((s_max, pairs)) < 0.45) & (pos == 0)).astype(np.uint8)
    query = Fingerprint(pos, neg)

    def run(phases):
        idx, scores = lib.search(query, top_k=5, shortlist=1024,
                                 coarse_range=64, coarse_stride=4,
                                 coarse_phases=phases)
        return float(scores[0])

    out = {}
    # phases=None (all 4: the offset-robust default) vs the legacy
    # phase-0-only coarse — the recall/cost tradeoff both ways.
    for label, phases in (("robust", None), ("phase1", 1)):
        run(phases)                              # compile + coarse cache
        best = 0.0
        dts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            best = run(phases)                   # host fetches => real wait
            dts.append(time.perf_counter() - t0)
        assert best >= 0.0
        out[label] = min(dts)
    return out["robust"], out["phase1"], l


def make_bench_dedup_block(config, lr: int = 1024, lv: int = 16,
                           s_max: int = 64):
    """Multi-device dedup unit cost: one resident-vs-visiting packed block tile
    (the inner unit of parallel.sharded_packed.ring_dedup_topk_packed's ring
    step, chunked so the [lr, lv, S, S] hit transient stays bounded).

    Returns a ``run(iters) -> (pair_compares_per_sec, seconds_per_tile)``
    closure (single upload + single jit across repeated runs).  The
    1M-track multi-device extrapolation in bench_details derives from this rate:
    each of n devices does L^2/n full offset-slide pair compares across the
    whole ring.
    """
    from lbaudiodetective.ops.match_packed import _mask_words
    from lbaudiodetective.parallel.sharded_packed import _packed_block_scores
    from lbaudiodetective.utils.packing import words_per_plane

    pairs = config.num_wavelet_pairs
    w = words_per_plane(pairs)
    rng = np.random.default_rng(7)
    rp = jnp.asarray(rng.integers(0, 2**32, size=(lr, s_max, w), dtype=np.uint32))
    rn = jnp.asarray(rng.integers(0, 2**32, size=(lr, s_max, w), dtype=np.uint32))
    vp = jnp.asarray(rng.integers(0, 2**32, size=(lv, s_max, w), dtype=np.uint32))
    vn = jnp.asarray(rng.integers(0, 2**32, size=(lv, s_max, w), dtype=np.uint32))
    rc = jnp.full((lr,), s_max, jnp.int32)
    vc = jnp.full((lv,), s_max, jnp.int32)
    mask_w = jnp.asarray(_mask_words(pairs, 0, config.subfingerprint_length))

    step_j = jax.jit(_packed_block_scores)

    def step():
        return step_j((rp, rn, rc), (vp, vn, vc), mask_w)

    def run(iters: int = 20):
        dt = _timed(step, iters)
        return lr * lv / dt, dt

    return run


def bench_streaming(config, n_streams: int = 256, chunk: int = 1024,
                    steps: int = 20):
    """BASELINE config 4: concurrent stream throughput (real-time factor)."""
    from lbaudiodetective.streaming.runtime import StreamingExtractor

    # collect_host=False: steps pipeline (device state chains them); the
    # single harvest at the end forces completion — honest wall time without
    # a blocking host round-trip per chunk.
    ext = StreamingExtractor(batch=n_streams, chunk_size=chunk, config=config,
                             collect_host=False)
    rng = np.random.default_rng(2)
    # int16 PCM ingest (the reference's recording format): half the
    # host->device bytes of float32.
    chunks = (rng.standard_normal((steps, n_streams, chunk))
              * 3276.8).astype(np.int16)
    for w in range(min(6, steps)):  # warm past frame emission (compiles)
        ext.feed_pcm16(chunks[w])
    ext.harvest()
    ext.reset()
    t0 = time.perf_counter()
    for s in range(steps):
        ext.feed_pcm16(chunks[s])
    ext.harvest()               # fetch forces full pipeline completion
    dt = time.perf_counter() - t0
    audio_seconds = steps * chunk / config.processing_sample_rate * n_streams
    return audio_seconds / dt, n_streams


def bench_streaming_identify(config, n_streams: int = 256,
                             lib_size: int = 16384, s_lib: int = 32,
                             chunk: int = 1024, steps: int = 20,
                             match_every: int = 4, group: int = 32,
                             shard_devices: int = 0):
    """Streaming identification end-to-end (essay Appendix E live use case):
    ``n_streams`` lockstep streams feed a StreamingIdentifier against a
    ``lib_size``-entry library; every ``match_every`` completed
    subfingerprints ONE identify tick rematches every stream's accumulated
    fingerprint against the whole library (stream-grouped dispatches bound
    the hit transient).  Reports (identify ticks/s, seconds per tick,
    audio real-time factor including extraction, ticks run).
    ``shard_devices`` > 0 shards the library (and the incremental mode's
    diagonal state) that many ways over a device mesh —
    scripts/bench_streaming_identify_mesh.py runs this on the virtual CPU
    mesh; on several GPUs it measures the real sharded tick rate."""
    from lbaudiodetective.models.library import FingerprintLibrary
    from lbaudiodetective.streaming.identify import StreamingIdentifier
    from lbaudiodetective.utils.packing import words_per_plane

    pairs = config.num_wavelet_pairs
    w = words_per_plane(pairs)
    rng = np.random.default_rng(11)
    lib = FingerprintLibrary(
        rng.integers(0, 2**32, size=(lib_size, s_lib, w), dtype=np.uint32),
        rng.integers(0, 2**32, size=(lib_size, s_lib, w), dtype=np.uint32),
        np.full(lib_size, s_lib, np.int32), pairs, config)
    if shard_devices:
        from lbaudiodetective.parallel.mesh import make_mesh
        from lbaudiodetective.parallel.sharded_library import (
            ShardedFingerprintLibrary)

        lib = ShardedFingerprintLibrary(
            lib, make_mesh(library_parallelism=shard_devices))
    chunks = (rng.standard_normal((steps, n_streams, chunk))
              * 3276.8).astype(np.int16)
    audio_seconds = steps * chunk / config.processing_sample_rate * n_streams

    def run_mode(rematch: str):
        ident = StreamingIdentifier(lib, batch=n_streams, chunk_size=chunk,
                                    config=config, match_every=match_every,
                                    match_stream_group=group, rematch=rematch)
        ticks = 0                   # warm pass: compile every tick shape
        for s in range(steps):
            done = ident.feed_pcm16(chunks[s])
            ticks += int(done > 0 and ident._since_match == 0)
        ident.finalize()
        if ticks == 0:              # counts MATCH ticks, not completions —
            # a steps/match_every combo that never accumulates a tick must
            # fail here, not report a 0-tick timing below.
            raise RuntimeError("no identify tick fired during warmup")
        ident2 = StreamingIdentifier(lib, batch=n_streams, chunk_size=chunk,
                                     config=config, match_every=match_every,
                                     match_stream_group=group,
                                     rematch=rematch)
        n_ticks = 0
        tick_seconds = []
        t0 = time.perf_counter()
        for s in range(steps):
            t_tick = time.perf_counter()
            done = ident2.feed_pcm16(chunks[s])
            if done and ident2._since_match == 0:   # a match tick just ran
                tick_seconds.append(time.perf_counter() - t_tick)
                n_ticks += 1
        ident2.finalize()
        dt = time.perf_counter() - t0
        # None (JSON null), never NaN: bench_details.json must stay RFC JSON.
        return (n_ticks / dt, float(np.median(tick_seconds)) if tick_seconds
                else None, audio_seconds / dt, n_ticks)

    return run_mode("full"), run_mode("incremental")


def bench_session_pool(config, n_sessions: int = 64, lib_size: int = 16384,
                       s_lib: int = 32, rounds: int = 5, k_post: int = 4,
                       baseline_sessions: int = 8):
    """Pooled vs per-session live-recognition posts (device dispatches are
    the cost: per-session mode pays update + top-k per POST; the pool pays
    one flush + one top-k per WINDOW regardless of session count).

    Measures aggregate posts/s: ``n_sessions`` sessions each posting
    ``k_post`` subfingerprints per round through a StreamSessionPool (one
    flush+top-k per round), vs ``baseline_sessions`` dedicated per-session
    matchers posting the same increments individually (extrapolating the
    per-post cost of the smaller set)."""
    from lbaudiodetective.models.library import FingerprintLibrary
    from lbaudiodetective.streaming.incremental import (
        IncrementalLibraryMatcher, StreamSessionPool)
    from lbaudiodetective.utils.packing import words_per_plane

    pairs = config.num_wavelet_pairs
    w = words_per_plane(pairs)
    rng = np.random.default_rng(13)
    lib = FingerprintLibrary(
        rng.integers(0, 2**32, size=(lib_size, s_lib, w), dtype=np.uint32),
        rng.integers(0, 2**32, size=(lib_size, s_lib, w), dtype=np.uint32),
        np.full(lib_size, s_lib, np.int32), pairs, config)

    def planes(k):
        p = (rng.random((k, pairs)) < 0.5).astype(np.uint8)
        q = ((rng.random((k, pairs)) < 0.5) & (p == 0)).astype(np.uint8)
        return p, q

    n_cap = rounds * k_post + k_post
    pool = StreamSessionPool(lib, slots=n_sessions, n_cap=n_cap,
                             config=config)
    sids = [f"s{i}" for i in range(n_sessions)]
    for sid in sids:
        pool.open(sid)
    incs = {sid: planes(rounds * k_post) for sid in sids}
    # Warm (compile flush + top-k shapes).
    for sid in sids:
        pool.post(sid, incs[sid][0][:k_post], incs[sid][1][:k_post])
    pool.flush()
    pool.top_k(5)

    t0 = time.perf_counter()
    for r in range(1, rounds):
        for sid in sids:
            p, q = incs[sid]
            pool.post(sid, p[r * k_post:(r + 1) * k_post],
                      q[r * k_post:(r + 1) * k_post])
        pool.flush()
        pool.top_k(5)
    dt_pool = time.perf_counter() - t0
    pool_posts_per_sec = n_sessions * (rounds - 1) / dt_pool

    # Per-session baseline: dedicated matchers, one update + one top-k per
    # post (what the default serving mode dispatches).
    template = IncrementalLibraryMatcher(lib, batch=1, n_cap=n_cap,
                                         config=config)
    mats = {i: template.clone_empty() for i in range(baseline_sessions)}
    for i, m in mats.items():
        p, q = incs[sids[i]]
        m.update(p[None, :k_post], q[None, :k_post])   # warm
        m.top_k(5)
    t0 = time.perf_counter()
    for r in range(1, rounds):
        for i, m in mats.items():
            p, q = incs[sids[i]]
            m.update(p[None, r * k_post:(r + 1) * k_post],
                     q[None, r * k_post:(r + 1) * k_post])
            m.top_k(5)
    dt_one = time.perf_counter() - t0
    per_session_posts_per_sec = baseline_sessions * (rounds - 1) / dt_one
    return (pool_posts_per_sec, per_session_posts_per_sec,
            n_sessions, baseline_sessions)


def bench_serving(config, max_batch: int = 8, threads: int = 8,
                  window_s: float = 0.05):
    """End-to-end HTTP serving throughput on seeded bird-call audio.

    Library = 10 seeded 10 s clips enrolled through the batched pipeline;
    requests = 40 WAV payloads (each clip whole and with Gaussian noise at
    20, 10 and 0 dB SNR) POSTed concurrently to the micro-batched serving
    edge (decode + padded batch extraction + batched match, all inside the
    timed window).  ``n_sub_cap`` pins every batch to one static shape so
    the whole run shares one extraction compilation.  The timed wave is the
    SECOND one (wave 1 pays jit compiles) with the request order reversed,
    so batch compositions differ.
    """
    import tempfile
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from lbaudiodetective.io.wav import write_wav
    from lbaudiodetective.models.detective import AudioDetective
    from lbaudiodetective.models.library import FingerprintLibrary
    from lbaudiodetective.serving import IdentificationService, make_server
    from lbaudiodetective.utils.synth import bird_calls

    clips = bird_calls(21, 10)
    names = [f"bird{i}" for i in range(len(clips))]
    rng = np.random.default_rng(22)
    with tempfile.TemporaryDirectory() as work:
        paths = []
        for name, x in zip(names, clips):
            paths.append(f"{work}/{name}.wav")
            write_wav(paths[-1], x, 44100.0)
        fps = AudioDetective(config).process_batch(paths)
        payloads = []
        for name, x in zip(names, clips):
            for snr_db in (None, 20.0, 10.0, 0.0):
                y = x if snr_db is None else x + (
                    rng.standard_normal(len(x)) * x.std()
                    * 10 ** (-snr_db / 20)).astype(np.float32)
                write_wav(f"{work}/q.wav", y, 44100.0)
                with open(f"{work}/q.wav", "rb") as f:
                    payloads.append((name, f.read()))
    lib = FingerprintLibrary.from_fingerprints(fps, config)
    service = IdentificationService(lib, names, config,
                                    batch_window_s=window_s,
                                    max_batch=max_batch, n_sub_cap=56)
    server = make_server(service)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()

    def post(item):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/identify", data=item[1])
        with urllib.request.urlopen(req, timeout=900) as r:
            return json.loads(r.read())

    with ThreadPoolExecutor(threads) as ex:
        list(ex.map(post, payloads))               # wave 1: compiles
        wave2 = list(reversed(payloads))
        t0 = time.perf_counter()
        results = list(ex.map(post, wave2))
        dt = time.perf_counter() - t0
    server.shutdown()
    server.server_close()
    right = sum(1 for (want, _), r in zip(wave2, results)
                if r["track"] == want)
    return (len(payloads) / dt, len(payloads), right,
            service.extract_dispatches)


def main():
    quick = "--quick" in sys.argv
    from lbaudiodetective.config import FingerprintConfig
    from lbaudiodetective.utils import profiling
    from lbaudiodetective.utils.compile_cache import CHECKOUT, enable_compile_cache

    device = require_gpu()
    enable_compile_cache()
    timers = profiling.StageTimers()
    # Merge into the existing artifact so fields produced by optional modes
    # (--packed-64k / --million-track) survive runs that skip those modes.
    details = load_details(device)

    parity_cfg = FingerprintConfig()                    # hop 'file' (parity)
    proc_cfg = FingerprintConfig(hop_domain="proc")     # spec-corrected

    if "--trace" in sys.argv:
        # Device trace of warm parity-extraction steps (perfetto-readable);
        # the persistent compilation cache keeps the traced call from
        # recompiling.
        trace_dir = str(CHECKOUT / ".cache" / "trace")
        bench_extract(parity_cfg, batch=8, iters=1)          # warm/compile
        with profiling.trace_to(trace_dir):
            bench_extract(parity_cfg, batch=8, iters=1)
        details["trace_dir"] = trace_dir

    batch = 8 if quick else PARITY_BATCH
    with timers.stage("extract_parity"):
        clips_per_sec, dt = bench_extract(parity_cfg, batch=batch)
    details["extract_parity_clips_per_sec"] = clips_per_sec
    details["extract_parity_batch"] = batch
    details["extract_parity_step_seconds"] = dt

    batch_p = 32 if quick else 1024
    try:  # keep the primary (parity) metric robust to secondary failures
        with timers.stage("extract_proc"):
            clips_proc, dt_p = bench_extract(proc_cfg, batch=batch_p)
        details["extract_proc_clips_per_sec"] = clips_proc
        details["extract_proc_batch"] = batch_p
        details["extract_proc_step_seconds"] = dt_p
    except Exception as e:
        details["extract_proc_error"] = str(e)[:200]

    # Matchers: pinned config, THREE consecutive runs recorded (the target
    # must hold across runs, not on a lucky one).
    lib = 2048 if quick else 16384
    runs, runs_sub, runs_packed = [], [], []
    try:
        run_match = make_bench_match(parity_cfg, library_size=lib)
    except Exception as e:
        run_match = None
        details["match_matmul_error"] = str(e)[:200]
    try:
        run_packed = make_bench_match_packed(parity_cfg, library_size=lib)
    except Exception as e:
        run_packed = None
        details["match_packed_error"] = str(e)[:200]
    for _ in range(1 if quick else 3):
        if run_match is None and run_packed is None:
            break
        if run_match is not None:
            try:
                with timers.stage("match_matmul"):
                    pair_cps, sub_cps, dt_m = run_match()
                runs.append(pair_cps)
                runs_sub.append(sub_cps)
            except Exception as e:
                details["match_matmul_error"] = str(e)[:200]
                run_match = None
        if run_packed is not None:
            try:
                with timers.stage("match_packed"):
                    packed_cps, _ = run_packed()
                runs_packed.append(packed_cps)
            except Exception as e:
                details["match_packed_error"] = str(e)[:200]
    if runs:
        details["match_pair_compares_per_sec"] = min(runs)
        details["match_pair_compares_runs"] = runs
        details["match_subfingerprint_compares_per_sec"] = min(runs_sub)
        details["match_library_size"] = lib
    if runs_packed:
        details["match_packed_pair_compares_per_sec"] = min(runs_packed)
        details["match_packed_pair_compares_runs"] = runs_packed

    if "--packed-64k" in sys.argv:
        try:
            with timers.stage("packed_64k"):
                details["match_packed_64k_pair_compares_per_sec"] = \
                    bench_packed_64k(parity_cfg)
        except Exception as e:
            details["match_packed_64k_error"] = str(e)[:200]
    if "--million-track" in sys.argv:
        try:
            with timers.stage("million_track"):
                q_dt, l = bench_million_track(parity_cfg)
            details["million_track_query_seconds"] = q_dt
            details["million_track_library_size"] = l
            with timers.stage("million_track_search"):
                s_dt, s_dt_p1, _ = bench_million_track_search(parity_cfg)
            details["million_track_search_seconds"] = s_dt
            details["million_track_search_phase1_seconds"] = s_dt_p1
            details["million_track_search_params"] = {
                "shortlist": 1024, "coarse_range": 64, "coarse_stride": 4,
                "coarse_phases": "all (offset-robust)"}
        except Exception as e:
            details["million_track_error"] = str(e)[:200]
    if "--serving" in sys.argv:
        try:
            with timers.stage("serving"):
                rps, n_req, right, disp = bench_serving(parity_cfg)
            details["serving_requests_per_sec"] = rps
            details["serving_requests"] = n_req
            details["serving_right_track"] = right
            details["serving_extract_dispatches"] = disp
        except Exception as e:
            details["serving_error"] = str(e)[:200]
    if "--dedup" in sys.argv:
        try:
            runs_dd = []
            run_dd = make_bench_dedup_block(parity_cfg)
            for _ in range(3):
                with timers.stage("dedup_block"):
                    dd_cps, _ = run_dd()
                runs_dd.append(dd_cps)
            rate = min(runs_dd)
            details["dedup_packed_block_pair_compares_per_sec"] = rate
            details["dedup_packed_block_runs"] = runs_dd
            # 1M-track all-pairs dedup over n devices: every device
            # performs L^2/n full offset-slide pair compares across the ring
            # (link traffic per step is (L/n) * 3.2 KB packed).
            l = 1_048_576
            details["dedup_1m_extrapolation_seconds"] = {
                str(n): l * l / n / rate for n in (1, 4)}
        except Exception as e:
            details["dedup_error"] = str(e)[:200]

    try:
        n_streams = 64 if quick else 256
        with timers.stage("streaming"):
            rt_factor, _ = bench_streaming(parity_cfg, n_streams=n_streams)
        details["streaming_realtime_factor"] = rt_factor
        details["streaming_concurrent_streams"] = n_streams
    except Exception as e:  # keep the primary metric robust
        details["streaming_error"] = str(e)[:200]

    if "--streaming-identify" in sys.argv:
        try:
            si_streams = 64 if quick else 256
            si_lib = 2048 if quick else 16384
            with timers.stage("streaming_identify"):
                full_m, inc_m = bench_streaming_identify(
                    parity_cfg, n_streams=si_streams, lib_size=si_lib)
            details["streaming_identify"] = {
                "full": {"ticks_per_sec": full_m[0],
                         "median_tick_seconds": full_m[1],
                         "realtime_factor_with_identify": full_m[2],
                         "ticks": full_m[3]},
                "incremental": {"ticks_per_sec": inc_m[0],
                                "median_tick_seconds": inc_m[1],
                                "realtime_factor_with_identify": inc_m[2],
                                "ticks": inc_m[3]},
                "streams": si_streams, "library_size": si_lib,
            }
        except Exception as e:
            details["streaming_identify_error"] = str(e)[:200]

    if "--session-pool" in sys.argv:
        try:
            sp_sessions = 16 if quick else 64
            sp_lib = 2048 if quick else 16384
            with timers.stage("session_pool"):
                pool_pps, one_pps, n_sess, n_base = bench_session_pool(
                    parity_cfg, n_sessions=sp_sessions, lib_size=sp_lib)
            details["session_pool"] = {
                "pooled_posts_per_sec": pool_pps,
                "per_session_posts_per_sec": one_pps,
                "speedup": pool_pps / one_pps if one_pps else None,
                "pool_sessions": n_sess,
                "baseline_sessions": n_base,
                "library_size": sp_lib,
            }
        except Exception as e:
            details["session_pool_error"] = str(e)[:200]

    details["host_stage_seconds"] = timers.report()
    with open("bench_details.json", "w") as f:
        json.dump(details, f, indent=2)

    result = {
        "metric": "10s clips fingerprinted/sec (parity mode)",
        "value": clips_per_sec,
        "unit": "clips/s",
        "device": device,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
