"""Multihost init wrapper + restart/re-join flow, in mocked single-process
form (no pod in CI; the collectives it feeds are tested on the CPU mesh)."""

import pathlib

import numpy as np
import pytest

import jax

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.models.fingerprint import Fingerprint
from lbaudiodetective.parallel import distributed
from lbaudiodetective.utils.serialize import load_library, save_library


def test_initialize_single_process_is_noop(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    distributed.initialize()
    assert calls == []


def test_initialize_joins_cluster(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    distributed.initialize("coord:1234", num_processes=4, process_id=2)
    assert calls == [{"coordinator_address": "coord:1234",
                      "num_processes": 4, "process_id": 2}]


def test_shard_bounds_cover_and_partition():
    total = 103
    seen = []
    for pid in range(8):
        lo, hi = distributed.shard_bounds(total, pid, 8)
        assert 0 <= lo <= hi <= total
        seen.extend(range(lo, hi))
    assert seen == list(range(total))          # disjoint + complete
    assert distributed.shard_bounds(3, 7, 8) == (3, 3)   # empty tail shard


def test_rejoin_reloads_shard_and_scores_match(tmp_path, monkeypatch):
    """Failure-recovery flow (SURVEY §5): a host re-joins (mocked), reloads
    its library shard from the checkpoint, and produces identical scores."""
    from lbaudiodetective.ops.match_packed import match_one_vs_many_packed

    rng = np.random.default_rng(77)
    cfg = FingerprintConfig()
    fps = []
    for _ in range(12):
        cls = rng.choice(3, size=(16, cfg.num_wavelet_pairs))
        fps.append(Fingerprint.from_planes(
            (cls == 1).astype(np.uint8), (cls == 2).astype(np.uint8)))

    lo, hi = distributed.shard_bounds(len(fps), process_id=1, num_processes=3)
    shard_file = str(tmp_path / "shard1.npz")
    save_library(shard_file, fps[lo:hi], cfg)

    q = fps[lo + 1].packed()
    pos_w, neg_w, counts, pairs = load_library(shard_file, cfg)
    before = np.asarray(match_one_vs_many_packed(
        q[0], q[1], np.int32(fps[lo + 1].num_subfingerprints),
        pos_w, neg_w, counts, pairs))

    # "Crash" and re-join: fresh initialize (mocked), reload from checkpoint.
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: None)
    distributed.initialize("coord:1234", num_processes=3, process_id=1)
    pos_w2, neg_w2, counts2, pairs2 = load_library(shard_file, cfg)
    after = np.asarray(match_one_vs_many_packed(
        q[0], q[1], np.int32(fps[lo + 1].num_subfingerprints),
        pos_w2, neg_w2, counts2, pairs2))

    np.testing.assert_array_equal(before, after)
    assert after[1] == pytest.approx(1.0)       # self-match inside the shard


def test_two_process_library_sharded_match(tmp_path):
    """REAL multihost mechanics on one machine: two separate processes join
    a coordinator (gloo CPU collectives), each mmap-reloads its own shards
    of the sharded checkpoint, and the cross-process library-sharded matcher
    must reproduce single-process scores exactly."""
    import socket
    import subprocess
    import sys

    from lbaudiodetective.ops.match import match_one_vs_many_padded
    from lbaudiodetective.utils.serialize import save_library_sharded

    rng = np.random.default_rng(123)
    cfg = FingerprintConfig()
    fps = []
    for _ in range(14):
        cls = rng.choice(3, size=(12, cfg.num_wavelet_pairs))
        fps.append(Fingerprint.from_planes(
            (cls == 1).astype(np.uint8), (cls == 2).astype(np.uint8)))
    libdir = str(tmp_path / "libdb")
    save_library_sharded(libdir, fps, cfg, n_shards=4)   # 1 shard/device

    qp, qn = fps[5].pos, fps[5].neg
    query_npz = str(tmp_path / "query.npz")
    np.savez(query_npz, pos=qp, neg=qn, n=fps[5].num_subfingerprints)

    with socket.socket() as s:                            # free port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    import os

    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in (env.get("PYTHONPATH", ""), repo) if p])
    procs, outs, logs = [], [], []
    try:
        for pid in range(2):
            out = str(tmp_path / f"out{pid}.npz")
            outs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable,
                 str(pathlib.Path(__file__).parent / "_dist_worker.py"),
                 str(port), str(pid), "2", libdir, query_npz, out],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        for p in procs:
            try:
                logs.append(p.communicate(timeout=240)[0])
            except subprocess.TimeoutExpired:
                logs.append("<worker timed out after 240 s>")
    finally:
        for p in procs:                  # no orphans if rendezvous hangs
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-2000:]}"

    got = np.full(16, np.nan)                             # 4 shards x 4 pad
    for out in outs:
        z = np.load(out)
        got[z["idx"]] = z["scores"]
    assert not np.isnan(got).any()

    # Single-process reference over the same padded library.
    s_max = max(f.num_subfingerprints for f in fps)
    pos = np.zeros((16, s_max, cfg.num_wavelet_pairs), np.uint8)
    neg = np.zeros_like(pos)
    counts = np.zeros(16, np.int32)
    for i, f in enumerate(fps):
        p_, n_ = f.pos, f.neg
        counts[i] = f.num_subfingerprints
        pos[i, :p_.shape[0]] = p_
        neg[i, :n_.shape[0]] = n_
    ref = np.asarray(match_one_vs_many_padded(
        qp, qn, np.int32(fps[5].num_subfingerprints),
        pos, neg, counts, 0, cfg.subfingerprint_length))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert got[5] == pytest.approx(1.0)                   # self-match
