"""Pooled live-recognition sessions at the serving edge: N sessions share
one slot-batched matcher and concurrent posts fold in ONE device dispatch
(streaming/incremental.py::StreamSessionPool).  Responses must be exactly
what the default per-session matchers produce."""

import threading

import numpy as np
import pytest

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.models.fingerprint import Fingerprint
from lbaudiodetective.models.library import FingerprintLibrary
from lbaudiodetective.serving import IdentificationService


def _lib(rng, n=4, s=6, pairs=100):
    fps = []
    for _ in range(n):
        pos = (rng.random((s, pairs)) < 0.5).astype(np.uint8)
        neg = ((rng.random((s, pairs)) < 0.5) & (pos == 0)).astype(np.uint8)
        fps.append(Fingerprint(pos, neg))
    return FingerprintLibrary.from_fingerprints(fps, FingerprintConfig()), fps


def _sub_strings(fp, a, b):
    return Fingerprint(np.asarray(fp.pos)[a:b],
                       np.asarray(fp.neg)[a:b]).to_string().encode()


def test_pooled_matches_default_stepwise():
    """The same post schedule through pooled and default services yields
    identical responses at every step (same device math, batched)."""
    rng = np.random.default_rng(43)
    lib, fps = _lib(rng)
    names = [f"t{i}" for i in range(len(fps))]
    pooled = IdentificationService(lib, names, top_k=3, stream_pool=True,
                                   stream_flush_window_s=0.0)
    plain = IdentificationService(lib, names, top_k=3)
    pa = pooled.stream_open()["session"]
    pb = pooled.stream_open()["session"]
    da = plain.stream_open()["session"]
    db = plain.stream_open()["session"]
    for (x, y) in [(0, 2), (2, 3), (3, 6)]:
        r1 = pooled.stream_update(pa, _sub_strings(fps[1], x, y))
        r2 = plain.stream_update(da, _sub_strings(fps[1], x, y))
        assert r1 == r2
        r3 = pooled.stream_update(pb, _sub_strings(fps[2], x, y))
        r4 = plain.stream_update(db, _sub_strings(fps[2], x, y))
        assert r3 == r4
    assert r1["track"] == "t1" and r3["track"] == "t2"
    # Heartbeat (empty post) answers from unchanged state in pool mode too.
    hb = pooled.stream_update(pa, b"")
    assert hb == r1 and hb["n"] == 6
    # Peek and close agree too.
    assert pooled.stream_peek(pa) == plain.stream_peek(da)
    assert pooled.stream_close(pa) == plain.stream_close(da)
    # Closed pooled session is gone and its slot is reusable.
    with pytest.raises(Exception):
        pooled.stream_update(pa, b"")
    pc = pooled.stream_open()["session"]
    r = pooled.stream_update(pc, _sub_strings(fps[0], 0, 4))
    assert r["track"] == "t0" and r["n"] == 4


def test_pooled_concurrent_posts_single_flush():
    """Concurrent posts within the flush window fold into one batched
    dispatch (the leader's flush covers the followers) and every client
    still gets its own correct running result."""
    rng = np.random.default_rng(47)
    lib, fps = _lib(rng, n=6)
    names = [f"t{i}" for i in range(6)]
    svc = IdentificationService(lib, names, top_k=2, stream_pool=True,
                                stream_flush_window_s=0.25)
    sids = [svc.stream_open()["session"] for _ in range(4)]
    flushes = []
    orig_flush = svc._pool.flush

    def counting_flush():
        n = orig_flush()
        flushes.append(n)
        return n

    svc._pool.flush = counting_flush
    results = {}

    def post(i):
        results[i] = svc.stream_update(sids[i], _sub_strings(fps[i], 0, 5))

    threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(4):
        assert results[i]["track"] == f"t{i}", results[i]
        assert results[i]["n"] == 5
    # All four posts landed in fewer flushes than posts — at least one
    # flush folded multiple sessions (the window is generous at 250 ms).
    assert sum(flushes) == 4 and len([f for f in flushes if f]) < 4, flushes


def test_pooled_persistence_cross_mode(tmp_path):
    """Pool-mode checkpoints restore into a per-session server and vice
    versa (same npz format and state key)."""
    rng = np.random.default_rng(53)
    lib, fps = _lib(rng)
    names = [f"t{i}" for i in range(len(fps))]
    pooled = IdentificationService(lib, names, top_k=3, stream_pool=True,
                                   stream_flush_window_s=0.0)
    sid = pooled.stream_open()["session"]
    r1 = pooled.stream_update(sid, _sub_strings(fps[3], 0, 3))
    assert pooled.save_sessions(str(tmp_path / "s")) == 1

    plain = IdentificationService(lib, names, top_k=3)
    assert plain.load_sessions(str(tmp_path / "s")) == 1
    pooled2 = IdentificationService(lib, names, top_k=3, stream_pool=True,
                                    stream_flush_window_s=0.0)
    assert pooled2.load_sessions(str(tmp_path / "s")) == 1

    inc = _sub_strings(fps[3], 3, 6)
    ref = pooled.stream_update(sid, inc)
    assert plain.stream_update(sid, inc) == ref
    assert pooled2.stream_update(sid, inc) == ref
    assert ref["track"] == "t3" and ref["n"] == 6 and r1["n"] == 3

    # A bad checkpoint is skipped in pool mode too (no half-open session).
    (tmp_path / "s2").mkdir()
    (tmp_path / "s2" / "bad.npz").write_bytes(b"junk")
    pooled3 = IdentificationService(lib, names, stream_pool=True)
    assert pooled3.load_sessions(str(tmp_path / "s2")) == 0
    assert len(pooled3._sessions) == 0 and len(pooled3._pool) == 0
