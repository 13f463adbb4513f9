"""Smoke run of the system's main path on one GPU.

Drives fingerprint extraction, million-track library search, HTTP serving
and streaming through the entry points a user calls, at the sizes users
run, on seeded synthetic bird-call audio, and checks every result against
the repository's own references: the NumPy oracle, offline extraction and
the single-device paths.  Earlier lines name the card and its power limit
and give each phase's measured numbers; the last line is one JSON object,
``{"ok": true, "device": {...}}``.  Without a GPU, or when any phase
fails, it exits non-zero and prints no such line.

    python chip_smoke.py [--seed N]      # one GPU: every single-card phase
    python chip_smoke.py --multi         # four GPUs: the sharded paths only
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: Agreement floor of JAX fingerprint bits with the NumPy oracle at the
#: default precision (tests/test_extract_parity.py).
ORACLE_FLOOR = 0.999
#: The drift-faithful fractional-hop mode runs the gather path; its floor
#: is that of the config-variant tests (tests/test_config_variants.py).
FRACTIONAL_FLOOR = 0.995
#: Matmul and packed matcher scores agree to f32 rounding
#: (tests/test_match_packed.py).
SCORE_ATOL = 1e-6


@dataclasses.dataclass(frozen=True)
class Sizes:
    clips: int = 256             # 10 s parity clips in one extraction batch
    seconds: float = 10.0
    proc_clips: int = 64         # clips in the proc-mode batch
    oracle_clips: int = 4        # clips per mode compared with the oracle
    time_batch: int = 32         # clips per timed rows-path step
    time_iters: int = 5
    tracks: int = 1_048_576      # search library entries
    s_lib: int = 64              # subfingerprint slots per library entry
    match_tracks: int = 16_384   # matcher-comparison / serving library
    queries: int = 8             # noisy crops searched in the big library
    requests: int = 8            # clips POSTed to /identify
    streams: int = 256
    stream_ticks: int = 12       # 1024-sample chunks per stream
    dedup_tracks: int = 8192
    dedup_s: int = 4


FULL = Sizes()


class SmokeFailure(AssertionError):
    """A phase produced a wrong result."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------- #
# Audio
# --------------------------------------------------------------------------- #

def write_clips(seed: int, n: int, seconds: float, directory: str
                ) -> list[str]:
    """Seeded bird-call clips at 44.1 kHz written with the repo's WAV, AIFF
    and AU writers in turn; returns the file paths."""
    from lbaudiodetective.io.aiff import write_aiff
    from lbaudiodetective.io.au import write_au
    from lbaudiodetective.io.wav import write_wav
    from lbaudiodetective.utils.synth import bird_calls

    writers = ((write_wav, "wav"), (write_aiff, "aiff"), (write_au, "au"))
    clips = bird_calls(seed, n, seconds)
    paths = []
    for i, x in enumerate(clips):
        write, ext = writers[i % len(writers)]
        path = os.path.join(directory, f"clip{i:04d}.{ext}")
        write(path, x, 44100.0)
        paths.append(path)
    return paths


def agreement(pos, neg, opos, oneg) -> float:
    """Mean bit agreement of two (pos, neg) fingerprints (the measure of
    tests/test_extract_parity.py)."""
    check(pos.shape == opos.shape, f"shape {pos.shape} vs oracle {opos.shape}")
    return float(((pos == opos).mean() + (neg == oneg).mean()) / 2)


def padded_batch(decoded, config, n_sub: int):
    """Zero-padded ``[B, T]`` audio, ``[B]`` counts and the static row count
    for ``n_sub`` subfingerprints per clip."""
    import jax.numpy as jnp

    from lbaudiodetective.ops.extract import (
        bucket_subfingerprints, required_padded_length)

    n_rows = bucket_subfingerprints(n_sub) * config.rows_per_frame
    t_pad = required_padded_length(config, n_rows)
    audio = np.zeros((len(decoded), t_pad), np.float32)
    for i, d in enumerate(decoded):
        t = min(d.samples.shape[0], t_pad)
        audio[i, :t] = d.samples[:t]
    return (jnp.asarray(audio), jnp.full((len(decoded),), n_sub, jnp.int32),
            n_rows)


# --------------------------------------------------------------------------- #
# Phases
# --------------------------------------------------------------------------- #

def phase_extraction(paths: list[str], sizes: Sizes) -> dict:
    """Parity batch through AudioDetective.process_batch, a proc-mode batch
    and one fractional-hop clip, each compared with the oracle; oracle
    agreement of every precision tier in both hop modes."""
    from lbaudiodetective.config import FingerprintConfig
    from lbaudiodetective.io.decode import decode_audio_file
    from lbaudiodetective.models.detective import AudioDetective
    from lbaudiodetective.ops.extract import extract_fingerprint_batch
    from lbaudiodetective.oracle.pipeline import oracle_fingerprint

    parity = FingerprintConfig()
    proc = FingerprintConfig(hop_domain="proc")
    frac = FingerprintConfig(integer_hop=False)
    t0 = time.perf_counter()
    fps = AudioDetective(parity).process_batch(paths)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = [decode_audio_file(p) for p in paths]
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pos, neg, n_subs = extract_fingerprint_batch(decoded, parity)
    warm_s = time.perf_counter() - t0
    check(all(np.array_equal(f.pos, pos[i, :n]) and np.array_equal(f.neg, neg[i, :n])
              for i, (f, n) in enumerate(zip(fps, n_subs))),
          "a second parity extraction differs from the first")
    want = parity.num_subfingerprints(decoded[0].file_frames,
                                      decoded[0].proc_frames)
    check(want > 0 and all(f.num_subfingerprints == want for f in fps),
          f"parity fingerprints are not {want} subfingerprints long")
    proc_fps = AudioDetective(proc).process_batch(paths[:sizes.proc_clips])
    frac_fp = AudioDetective(frac).process_audio_file(paths[0])

    out = {"fingerprints": fps, "decoded": decoded,
           "parity_batch": len(paths), "process_batch_first_call_s": first_s,
           "host_decode_s": decode_s, "parity_extract_warm_s": warm_s,
           "parity_extract_clips_per_s": len(paths) / warm_s}
    oracle = {}
    for mode, cfg, got in (("parity", parity, fps), ("proc", proc, proc_fps)):
        oracle[mode] = [oracle_fingerprint(d, cfg)
                        for d in decoded[:sizes.oracle_clips]]
        agree = [agreement(f.pos, f.neg, *o) for f, o in zip(got, oracle[mode])]
        out[f"{mode}_oracle_agreement"] = min(agree)
        check(min(agree) >= ORACLE_FLOOR,
              f"{mode} oracle agreement {min(agree):.5f} < {ORACLE_FLOOR}")
    o_frac = oracle_fingerprint(decoded[0], frac)
    out["fractional_oracle_agreement"] = agreement(frac_fp.pos, frac_fp.neg,
                                                   *o_frac)
    check(out["fractional_oracle_agreement"] >= FRACTIONAL_FLOOR,
          f"fractional-hop oracle agreement "
          f"{out['fractional_oracle_agreement']:.5f} < {FRACTIONAL_FLOOR}")

    tiers = {}
    for tier in ("default", "medium", "high", "highest"):
        for mode, cfg in (("parity", parity), ("proc", proc)):
            cfg_t = cfg.with_updates(matmul_precision=tier)
            pos, neg, n_subs = extract_fingerprint_batch(
                decoded[:sizes.oracle_clips], cfg_t)
            tiers[f"{tier}/{mode}"] = min(
                agreement(pos[i, :n], neg[i, :n], *oracle[mode][i])
                for i, n in enumerate(n_subs))
    out["tier_agreement"] = tiers
    out["_oracle"] = oracle
    check(tiers["high/parity"] >= ORACLE_FLOOR
          and tiers["high/proc"] >= ORACLE_FLOOR,
          f"default tier 'high' below {ORACLE_FLOOR}: {tiers}")
    return out


def _rfft_extract(audio, n_valid_sub, config, n_rows):
    """The gather path with the full packed rfft (cuFFT on a GPU) in place
    of the matmul DFT; a timing candidate, not a product path."""
    import jax.numpy as jnp

    from lbaudiodetective.ops import spectral
    from lbaudiodetective.ops.extract import subfingerprints_from_rows

    starts = spectral.window_starts(config, n_rows)
    windows = spectral.frame_windows(audio, starts, config.window_size)
    rows = spectral.band_energies(windows, config, use_matmul_dft=False)
    pos, neg = subfingerprints_from_rows(rows, config)
    n_sub = n_rows // config.rows_per_frame
    valid = (jnp.arange(n_sub) < n_valid_sub[..., None]).astype(jnp.uint8)
    return pos * valid[..., None], neg * valid[..., None]


def phase_rows_paths(decoded, oracle, sizes: Sizes) -> dict:
    """Compile every rows path in both integer-hop modes, time one
    extraction step of each, and compare their bits with the product path
    and the oracle; device memory per parity clip from the compiled step."""
    import jax

    from lbaudiodetective.config import FingerprintConfig
    from lbaudiodetective.ops.extract import extract_fingerprint_padded

    out = {}
    rfft = jax.jit(_rfft_extract, static_argnames=("config", "n_rows"))
    for mode, cfg in (("parity", FingerprintConfig()),
                      ("proc", FingerprintConfig(hop_domain="proc"))):
        d0 = decoded[0]
        n_sub = cfg.num_subfingerprints(d0.file_frames, d0.proc_frames)
        audio, counts, n_rows = padded_batch(decoded[:sizes.time_batch], cfg,
                                             n_sub)
        steps = {
            "conv": lambda: extract_fingerprint_padded(
                audio, counts, cfg, n_rows, rows_impl="conv"),
            "xla_matmul_dft": lambda: extract_fingerprint_padded(
                audio, counts, cfg, n_rows, rows_impl="xla"),
            "xla_rfft": lambda: rfft(audio, counts, config=cfg, n_rows=n_rows),
        }
        ref = None
        for name, step in steps.items():
            pos, neg = jax.block_until_ready(step())
            pos, neg = np.asarray(pos), np.asarray(neg)
            if ref is None:
                ref = (pos, neg)
            out[f"{mode}/{name}/agreement_vs_conv"] = agreement(pos, neg, *ref)
            out[f"{mode}/{name}/oracle_agreement"] = min(
                agreement(pos[i, :n_sub], neg[i, :n_sub], *o)
                for i, o in enumerate(oracle[mode]))
            t0 = time.perf_counter()
            for _ in range(sizes.time_iters):
                res = step()
            jax.block_until_ready(res)
            dt = (time.perf_counter() - t0) / sizes.time_iters
            out[f"{mode}/{name}/step_ms"] = dt * 1e3
            out[f"{mode}/{name}/clips_per_s"] = len(pos) / dt
        mem = extract_fingerprint_padded.lower(
            audio, counts, config=cfg, n_rows=n_rows).compile().memory_analysis()
        if mem is not None:
            total = (mem.temp_size_in_bytes + mem.argument_size_in_bytes
                     + mem.output_size_in_bytes)
            out[f"{mode}/conv/bytes_per_clip"] = total / len(pos)
    return out


def build_library(seed: int, n_tracks: int, s_lib: int, planted, where,
                  config):
    """A packed ``n_tracks``-entry library made on the device from ``seed``:
    every random entry is a full-length fingerprint (each sign pair set
    once), and ``planted[i]`` sits at entry ``where[i]``."""
    import jax
    import jax.numpy as jnp

    from lbaudiodetective.models.library import FingerprintLibrary
    from lbaudiodetective.utils import packing

    pairs = config.num_wavelet_pairs
    w = packing.words_per_plane(pairs)
    mask = jnp.asarray(packing.pack_bits(np.ones(pairs, np.uint8)))
    pp = np.zeros((len(planted), s_lib, w), np.uint32)
    pn = np.zeros_like(pp)
    counts = np.full(n_tracks, s_lib, np.int32)
    for i, fp in enumerate(planted):
        check(fp.num_subfingerprints <= s_lib, "planted clip exceeds s_lib")
        pw, nw = fp.packed()
        pp[i, :len(pw)] = pw
        pn[i, :len(nw)] = nw
        counts[where[i]] = fp.num_subfingerprints

    @jax.jit
    def build(key, pp, pn, idx):
        r = jax.random.bits(key, (n_tracks, s_lib, w), jnp.uint32)
        return ((r & mask).at[idx].set(pp), (~r & mask).at[idx].set(pn))

    pos, neg = build(jax.random.key(seed), pp, pn, jnp.asarray(where))
    return FingerprintLibrary(pos, neg, counts, pairs, config)


def crop_queries(decoded, clip_ids, seed: int, config, seconds: float = 5.0):
    """Noisy crops of the given clips, each starting at a subfingerprint
    boundary (k frames in), with Gaussian noise 25 dB below the signal.

    At 25 dB a crop still scores ~0.67-0.76 against its own track (seeded
    clips, CPU), while the best of a million random entries scores ~0.54."""
    from lbaudiodetective.io.decode import DecodedAudio
    from lbaudiodetective.ops.extract import extract_fingerprint_batch
    from lbaudiodetective.models.fingerprint import Fingerprint

    rng = np.random.default_rng(seed)
    hop = int(config.hop_in_processing_samples)
    frame = config.rows_per_frame * hop
    crops = []
    for i in clip_ids:
        x = decoded[i].samples
        n_len = min(int(seconds * config.processing_sample_rate),
                    len(x) // 2)
        k = int(rng.integers(1, max(2, (len(x) - n_len) // frame)))
        y = x[k * frame:k * frame + n_len].astype(np.float32)
        y = y + (rng.standard_normal(len(y)) * y.std()
                 * 10 ** (-25 / 20)).astype(np.float32)
        crops.append(DecodedAudio(
            y, config.processing_sample_rate,
            int(round(len(y) * config.file_sample_rate
                      / config.processing_sample_rate)),
            config.file_sample_rate))
    pos, neg, n = extract_fingerprint_batch(crops, config)
    return [Fingerprint.from_planes(pos[b, :m], neg[b, :m],
                                    config.subfingerprint_length)
            for b, m in enumerate(n)]


def phase_library(fps, decoded, sizes: Sizes, seed: int) -> dict:
    """Search noisy crops of planted clips in the big library (top-1 must be
    the planted entry); matmul vs packed matcher scores on the small one,
    and a few pairs against the oracle matcher."""
    import jax.numpy as jnp

    from lbaudiodetective.config import FingerprintConfig
    from lbaudiodetective.ops.match import match_one_vs_many_padded
    from lbaudiodetective.oracle.pipeline import oracle_match_fingerprints
    from lbaudiodetective.utils import packing

    cfg = FingerprintConfig()
    rng = np.random.default_rng(seed)
    out = {}
    where_big = rng.choice(sizes.tracks, size=len(fps), replace=False)
    t0 = time.perf_counter()
    big = build_library(seed, sizes.tracks, sizes.s_lib, fps, where_big, cfg)
    out["library_tracks"] = len(big)
    out["library_bytes"] = int(big.pos_words.nbytes + big.neg_words.nbytes)
    out["library_build_s"] = time.perf_counter() - t0
    q_ids = rng.choice(len(fps), size=min(sizes.queries, len(fps)),
                       replace=False)
    queries = crop_queries(decoded, q_ids, seed, cfg)
    big.search(queries[0], top_k=5)                        # compile
    times, scores = [], []
    for q, i in zip(queries, q_ids):
        t0 = time.perf_counter()
        idx, sc = big.search(q, top_k=5)
        times.append(time.perf_counter() - t0)
        check(int(idx[0]) == int(where_big[i]),
              f"search top-1 {int(idx[0])} != planted {int(where_big[i])}")
        scores.append(float(sc[0]))
    out["search_median_s"] = float(np.median(times))
    out["search_top1_min_score"] = min(scores)
    del big

    where = rng.choice(sizes.match_tracks, size=len(fps), replace=False)
    small = build_library(seed + 1, sizes.match_tracks, sizes.s_lib, fps,
                          where, cfg)
    lib_pos = packing.unpack_bits(np.asarray(small.pos_words), cfg.num_wavelet_pairs)
    lib_neg = packing.unpack_bits(np.asarray(small.neg_words), cfg.num_wavelet_pairs)
    counts = np.asarray(small.counts)
    max_diff, exact = 0.0, True
    for q in queries[:4] + list(fps[:2]):
        packed = small.match(q)
        qp = np.zeros((sizes.s_lib, q.pairs), np.uint8)
        qn = np.zeros_like(qp)
        qp[:q.num_subfingerprints] = q.pos
        qn[:q.num_subfingerprints] = q.neg
        matmul = np.asarray(match_one_vs_many_padded(
            jnp.asarray(qp), jnp.asarray(qn), jnp.int32(q.num_subfingerprints),
            jnp.asarray(lib_pos), jnp.asarray(lib_neg), jnp.asarray(counts),
            0, cfg.subfingerprint_length))
        max_diff = max(max_diff, float(np.abs(matmul - packed).max()))
        exact = exact and bool(np.array_equal(matmul, packed))
        for j in (int(where[0]), int(np.argmax(packed)), 0):
            n = int(counts[j])
            ref = oracle_match_fingerprints((q.pos, q.neg),
                                            (lib_pos[j, :n], lib_neg[j, :n]))
            check(abs(ref - float(packed[j])) <= SCORE_ATOL,
                  f"packed score {packed[j]} != oracle {ref} (entry {j})")
    check(max_diff <= SCORE_ATOL,
          f"matmul vs packed matcher scores differ by {max_diff}")
    out["matchers_max_abs_diff"] = max_diff
    out["matchers_bitwise_equal"] = exact
    out["small_library"] = small
    out["small_where"] = where
    return out


def phase_serving(library, where, paths, sizes: Sizes) -> dict:
    """POST encoded clips concurrently to /identify on a micro-batching
    server; each must answer with its planted track."""
    from lbaudiodetective.config import FingerprintConfig
    from lbaudiodetective.serving import IdentificationService, make_server

    names = [f"track{i:07d}" for i in range(len(library))]
    cfg = FingerprintConfig()
    service = IdentificationService(library, names, cfg, batch_window_s=0.05,
                                    max_batch=8, n_sub_cap=sizes.s_lib)
    server = make_server(service)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def post(path):
        with open(path, "rb") as f:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/identify", data=f.read())
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read())

    n = min(sizes.requests, len(paths))
    try:
        with ThreadPoolExecutor(n) as ex:
            list(ex.map(post, paths[:n]))                  # compile
            t0 = time.perf_counter()
            answers = list(ex.map(post, paths[:n]))
            wave_s = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    for i, a in enumerate(answers):
        check(a["track"] == names[int(where[i])],
              f"/identify answered {a['track']} for clip {i}, "
              f"want {names[int(where[i])]}")
    return {"requests": n, "wave_s": wave_s,
            "extract_dispatches": service.extract_dispatches}


def phase_streaming(decoded, library, where, sizes: Sizes) -> dict:
    """StreamingExtractor on the aligned and the conv path must equal
    offline extraction bitwise; StreamingIdentifier ticks against the
    library must name each stream's planted track."""
    from lbaudiodetective.config import FingerprintConfig
    from lbaudiodetective.io.decode import DecodedAudio
    from lbaudiodetective.ops.extract import extract_fingerprint_batch
    from lbaudiodetective.streaming.identify import StreamingIdentifier
    from lbaudiodetective.streaming.runtime import StreamingExtractor

    cfg = FingerprintConfig()
    n = min(sizes.streams, len(decoded))
    total = sizes.stream_ticks * 1024
    audio = np.stack([d.samples[:total] for d in decoded[:n]])
    check(audio.shape == (n, total), "clips too short for the stream ticks")
    out = {"streams": n}
    for name, chunk in (("aligned", 1024), ("conv", 512)):
        ext = StreamingExtractor(batch=n, chunk_size=chunk, config=cfg)
        check(ext.aligned == (name == "aligned")
              and ext.use_conv == (name == "conv"),
              f"chunk {chunk} did not select the {name} streaming path")
        t0 = time.perf_counter()
        for s in range(total // chunk):
            ext.feed_pcm16(np.round(audio[:, s * chunk:(s + 1) * chunk]
                                    * 32768.0).clip(-32768, 32767)
                           .astype(np.int16))
        fps = ext.fingerprints()
        out[f"{name}_s"] = time.perf_counter() - t0
        rows = ext.rows_done
        n_sub = rows // cfg.rows_per_frame
        check(n_sub > 0, f"{name}: no subfingerprint completed")
        pcm = (np.round(audio * 32768.0).clip(-32768, 32767)
               .astype(np.int16).astype(np.float32) / 32768.0)
        offline = [DecodedAudio(x, cfg.processing_sample_rate,
                                rows * cfg.analysis_stride + cfg.window_size,
                                cfg.file_sample_rate) for x in pcm]
        pos, neg, _ = extract_fingerprint_batch(offline, cfg)
        for b in range(n):
            check(fps[b].num_subfingerprints == n_sub
                  and np.array_equal(fps[b].pos, pos[b, :n_sub])
                  and np.array_equal(fps[b].neg, neg[b, :n_sub]),
                  f"{name} stream {b} differs from offline extraction")
        out[f"{name}_subfingerprints"] = n_sub

    group = 32 if n % 32 == 0 else n
    ident = StreamingIdentifier(library, batch=n, chunk_size=1024, config=cfg,
                                match_every=4, match_stream_group=group)
    t0 = time.perf_counter()
    for s in range(sizes.stream_ticks):
        ident.feed(audio[:, s * 1024:(s + 1) * 1024])
    best = ident.finalize()
    out["identify_s"] = time.perf_counter() - t0
    wrong = [b for b in range(n) if best[b].track != int(where[b])]
    check(not wrong, f"streams {wrong[:8]} identified the wrong track")
    out["identified"] = n
    return out


def phase_multi(sizes: Sizes, seed: int, n_devices: int = 4) -> dict:
    """The sharded paths on a 2x2 ``(data, library)`` mesh, each against
    its single-device counterpart."""
    import jax
    import jax.numpy as jnp

    from lbaudiodetective.config import FingerprintConfig
    from lbaudiodetective.io.decode import DecodedAudio
    from lbaudiodetective.io.resample import resample_rational
    from lbaudiodetective.models.fingerprint import Fingerprint
    from lbaudiodetective.models.library import FingerprintLibrary
    from lbaudiodetective.ops.extract import extract_fingerprint_padded
    from lbaudiodetective.ops.match_packed import _mask_words
    from lbaudiodetective.parallel import extract_data_parallel, make_mesh
    from lbaudiodetective.parallel.sharded_library import (
        ShardedFingerprintLibrary)
    from lbaudiodetective.parallel.sharded_packed import (
        _packed_block_scores, ring_dedup_topk_packed)
    from lbaudiodetective.utils.synth import bird_calls

    cfg = FingerprintConfig()
    mesh = make_mesh(n_devices)
    check(dict(mesh.shape) == {"data": 2, "library": 2},
          f"mesh {dict(mesh.shape)} is not 2x2")
    out = {"mesh": dict(mesh.shape)}

    clips = bird_calls(seed, sizes.clips, sizes.seconds)
    decoded = [DecodedAudio(resample_rational(x, 44100.0,
                                              cfg.processing_sample_rate),
                            cfg.processing_sample_rate, len(x), 44100.0)
               for x in clips]
    n_sub = cfg.num_subfingerprints(decoded[0].file_frames,
                                    decoded[0].proc_frames)
    audio, counts, n_rows = padded_batch(decoded, cfg, n_sub)
    pos_dp, neg_dp = extract_data_parallel(audio, counts, cfg, n_rows, mesh)
    pos_1, neg_1 = extract_fingerprint_padded(audio, counts, cfg, n_rows)
    check(np.array_equal(np.asarray(pos_dp), np.asarray(pos_1))
          and np.array_equal(np.asarray(neg_dp), np.asarray(neg_1)),
          "data-parallel extraction differs from single-device extraction")
    check(len({s.device for s in pos_dp.addressable_shards}) == n_devices,
          "data-parallel output is not spread over every device")
    fps = [Fingerprint.from_planes(np.asarray(pos_1[i, :n_sub]),
                                   np.asarray(neg_1[i, :n_sub]),
                                   cfg.subfingerprint_length)
           for i in range(len(decoded))]

    rng = np.random.default_rng(seed)
    where = rng.choice(sizes.tracks, size=len(fps), replace=False)
    lib = build_library(seed, sizes.tracks, sizes.s_lib, fps, where, cfg)
    slib = ShardedFingerprintLibrary(lib, mesh)
    shards = slib.pos_words.addressable_shards
    check(len({s.device for s in shards}) == n_devices
          and all(s.data.shape[0] == slib.pos_words.shape[0] // 2
                  for s in shards),
          "sharded library does not hold one half per card")
    queries = crop_queries(decoded, range(min(sizes.queries, len(fps))),
                           seed, cfg)
    for i, q in enumerate(queries):
        idx_1, sc_1 = lib.search(q, top_k=5)
        idx_s, sc_s = slib.search(q, top_k=5)
        check(int(idx_s[0]) == int(idx_1[0]) == int(where[i])
              and abs(float(sc_s[0]) - float(sc_1[0])) <= SCORE_ATOL,
              f"sharded search top-1 ({idx_s[0]}, {sc_s[0]}) != single "
              f"({idx_1[0]}, {sc_1[0]}), planted {where[i]}")
    out["search_queries"] = len(queries)
    diff = np.abs(slib.match(queries[0]) - lib.match(queries[0])).max()
    check(diff <= SCORE_ATOL, f"sharded match scores differ by {diff}")
    del lib, slib

    # Ring dedup over the library axis vs a single-device all-pairs top-k.
    l, s, k = sizes.dedup_tracks, sizes.dedup_s, 4
    dups = [Fingerprint(f.pos[:s], f.neg[:s]) for f in fps[:8]]
    d_where = rng.choice(l, size=2 * len(dups), replace=False)
    dd = build_library(seed + 2, l, s, dups + dups, d_where, cfg)
    lib_sh = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("library", None, None))
    cnt_sh = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("library"))
    r_scores, r_idx = ring_dedup_topk_packed(
        jax.device_put(dd.pos_words, lib_sh), jax.device_put(dd.neg_words, lib_sh),
        jax.device_put(dd.counts, cnt_sh), dd.pairs, mesh, k=k)
    r_scores, r_idx = np.asarray(r_scores), np.asarray(r_idx)
    mask_w = jnp.asarray(_mask_words(dd.pairs, 0, cfg.subfingerprint_length))
    block = jax.jit(_packed_block_scores)
    rows = 512 if l % 512 == 0 else l
    full = np.concatenate([np.asarray(block(
        (dd.pos_words[a:a + rows], dd.neg_words[a:a + rows],
         dd.counts[a:a + rows]),
        (dd.pos_words, dd.neg_words, dd.counts), mask_w))
        for a in range(0, l, rows)])
    np.fill_diagonal(full, -np.inf)
    ref = -np.sort(-full, axis=1)[:, :k]
    check(np.allclose(r_scores, ref, rtol=0.0, atol=SCORE_ATOL),
          "ring dedup top-k scores differ from the single-device all-pairs")
    check(np.allclose(np.take_along_axis(full, r_idx, axis=1), r_scores,
                      rtol=0.0, atol=SCORE_ATOL),
          "ring dedup indices do not point at their scores")
    for a, b in zip(d_where[:len(dups)], d_where[len(dups):]):
        check(int(r_idx[a, 0]) == int(b) and int(r_idx[b, 0]) == int(a),
              f"ring dedup missed the planted duplicate pair ({a}, {b})")
    out["dedup_tracks"] = l
    return out


# --------------------------------------------------------------------------- #
# Entry point
# --------------------------------------------------------------------------- #

def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def report(name: str, result: dict) -> None:
    shown = {k: v for k, v in result.items() if not k.startswith("_")
             and isinstance(v, (int, float, str, bool, dict))}
    say(f"phase {name}: ok {json.dumps(shown, default=float)}")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--multi", action="store_true",
                        help="run only the four-card sharded paths")
    args = parser.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform "
              f"{devices[0].platform!r})", file=sys.stderr)
        return 2
    want = 4 if args.multi else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2

    from lbaudiodetective.io.native import binding
    from lbaudiodetective.utils.compile_cache import enable_compile_cache

    say(f"compile cache: {enable_compile_cache()}")
    for line in card_line().splitlines():
        say(line)
    say(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")
    sizes = FULL
    t_start = time.perf_counter()
    if args.multi:
        report("multi", phase_multi(sizes, args.seed))
    else:
        with tempfile.TemporaryDirectory() as work:
            t0 = time.perf_counter()
            paths = write_clips(args.seed, sizes.clips, sizes.seconds, work)
            check(binding.available(), "native decoder did not build")
            say(f"phase audio: ok {{\"clips\": {len(paths)}, "
                f"\"seconds\": {time.perf_counter() - t0:.2f}, "
                f"\"native_decoder\": true}}")
            ext = phase_extraction(paths, sizes)
            report("extraction", ext)
            report("rows_paths", phase_rows_paths(ext["decoded"],
                                                  ext["_oracle"], sizes))
            stats = devices[0].memory_stats() or {}
            say(f"device peak bytes in use so far: "
                f"{stats.get('peak_bytes_in_use', 'not available')}")
            lib = phase_library(ext["fingerprints"], ext["decoded"], sizes,
                                args.seed)
            report("library", lib)
            report("serving", phase_serving(lib["small_library"],
                                            lib["small_where"], paths, sizes))
            report("streaming", phase_streaming(
                ext["decoded"], lib["small_library"], lib["small_where"],
                sizes))
    say(f"total seconds: {time.perf_counter() - t_start:.1f}")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
