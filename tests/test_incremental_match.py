"""Incremental streaming matcher (streaming/incremental.py): running
diagonal-sum scores must be BITWISE equal to the full batch re-match at
every tick — hit counts are exact f32 integers and the accumulation order
over query subfingerprints matches _both_orientation_scores' roll loop."""

import numpy as np
import pytest

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.models.fingerprint import Fingerprint
from lbaudiodetective.models.library import FingerprintLibrary
from lbaudiodetective.ops.match import match_one_vs_many_padded
from lbaudiodetective.streaming.incremental import (
    IncrementalLibraryMatcher)


def _random_planes(rng, n, pairs):
    pos = (rng.random((n, pairs)) < 0.45).astype(np.uint8)
    neg = ((rng.random((n, pairs)) < 0.45) & (pos == 0)).astype(np.uint8)
    return pos, neg


def _full_scores(lib, qpos, qneg, n, s_pad, comparison_range=0):
    """Reference: the batch matcher on the accumulated planes."""
    import jax
    import jax.numpy as jnp

    from lbaudiodetective.utils import packing

    lp = packing.unpack_bits(np.asarray(lib.pos_words), lib.pairs)
    ln = packing.unpack_bits(np.asarray(lib.neg_words), lib.pairs)
    b = qpos.shape[0]
    qp = np.zeros((b, s_pad, lib.pairs), np.uint8)
    qn = np.zeros_like(qp)
    qp[:, :n] = qpos[:, :n]
    qn[:, :n] = qneg[:, :n]
    batched = jax.vmap(match_one_vs_many_padded,
                       in_axes=(0, 0, 0, None, None, None, None, None))
    return np.asarray(batched(
        jnp.asarray(qp), jnp.asarray(qn), jnp.full((b,), n, np.int32),
        jnp.asarray(lp), jnp.asarray(ln), lib.counts, comparison_range,
        200))


@pytest.mark.parametrize("comparison_range", [0, 64])
def test_incremental_equals_full_every_tick(comparison_range):
    """Streams growing past the library entry lengths (both orientations +
    the crossover), variable subfingerprints per tick, grouped streams."""
    rng = np.random.default_rng(5)
    pairs, s_lib, l, b = 100, 12, 24, 4
    # Entry lengths straddle the stream's final age (orientation coverage),
    # including an empty-ish and a full-bucket entry.
    sizes = [1, 3, 6, 9, 12] * 5
    fps = []
    for n in sizes[:l]:
        p, q = _random_planes(rng, s_lib, pairs)
        p[n:] = 0
        q[n:] = 0
        fps.append(Fingerprint(p[:n], q[:n]))
    lib = FingerprintLibrary.from_fingerprints(fps, FingerprintConfig())

    n_total = 20                               # > max entry length (12)
    qpos, qneg = np.zeros((b, n_total, pairs), np.uint8), \
        np.zeros((b, n_total, pairs), np.uint8)
    for i in range(b):
        qpos[i], qneg[i] = _random_planes(rng, n_total, pairs)
    # Plant a near-duplicate: stream 0 echoes entry 3 shifted by 2.
    e3p, e3n = np.asarray(fps[3].pos), np.asarray(fps[3].neg)
    qpos[0, 2:2 + e3p.shape[0]] = e3p
    qneg[0, 2:2 + e3n.shape[0]] = e3n

    inc = IncrementalLibraryMatcher(lib, batch=b, n_cap=n_total,
                                    comparison_range=comparison_range,
                                    stream_group=2)
    n = 0
    ticks = [3, 1, 4, 2, 5, 5]                 # mixed k, sums to 20
    for k in ticks:
        # Padded update: hand two extra zero columns + k_valid.
        pad_k = k + 2
        np_pos = np.zeros((b, pad_k, pairs), np.uint8)
        np_neg = np.zeros_like(np_pos)
        np_pos[:, :k] = qpos[:, n:n + k]
        np_neg[:, :k] = qneg[:, n:n + k]
        inc.update(np_pos, np_neg, k_valid=k)
        n += k
        got = inc.scores()
        want = _full_scores(lib, qpos, qneg, n, n_total, comparison_range)
        np.testing.assert_array_equal(got, want), (n, comparison_range)
    # The planted echo wins for stream 0 once enough of it has streamed in.
    assert int(got[0].argmax()) == 3
    assert got[0, 3] > 0.9


def test_incremental_n_cap_guard():
    """grow=False keeps the hard cap; the default auto-grows instead."""
    rng = np.random.default_rng(0)
    pairs = 100
    p, q = _random_planes(rng, 4, pairs)
    lib = FingerprintLibrary.from_fingerprints(
        [Fingerprint(p, q)], FingerprintConfig())
    inc = IncrementalLibraryMatcher(lib, batch=1, n_cap=4, grow=False)
    pos = np.zeros((1, 3, pairs), np.uint8)
    inc.update(pos, pos)
    with pytest.raises(ValueError, match="n_cap"):
        inc.update(pos, pos)


def test_incremental_auto_grow_bitwise_equal():
    """A stream outgrowing n_cap auto-doubles the orientation-B window;
    scores stay bitwise equal to the full rematch at every tick (new
    diagonal slots are zeros by construction — incremental._grow_fn)."""
    rng = np.random.default_rng(7)
    pairs = 100
    n_total, n_lib = 24, 6
    fps = []
    for _ in range(5):
        p, q = _random_planes(rng, n_lib, pairs)
        fps.append(Fingerprint(p, q))
    lib = FingerprintLibrary.from_fingerprints(fps, FingerprintConfig())
    qpos = np.zeros((1, n_total, pairs), np.uint8)
    qneg = np.zeros_like(qpos)
    qpos[0], qneg[0] = _random_planes(rng, n_total, pairs)
    # Echo entry 2 so an actual match rides through the growth boundary.
    e2p, e2n = np.asarray(fps[2].pos), np.asarray(fps[2].neg)
    qpos[0, 5:5 + n_lib], qneg[0, 5:5 + n_lib] = e2p, e2n

    inc = IncrementalLibraryMatcher(lib, batch=1, n_cap=4)  # grows 4->8->16->32
    n = 0
    for k in (3, 4, 5, 7, 5):                   # crosses 4, 8 and 16
        inc.update(qpos[:, n:n + k], qneg[:, n:n + k])
        n += k
        got = inc.scores()
        want = _full_scores(lib, qpos, qneg, n, n_total, 0)
        np.testing.assert_array_equal(got, want)
    assert inc.n_cap >= n_total
    assert int(got[0].argmax()) == 2


def test_incremental_update_bucketed_equal():
    """update_bucketed (k padded to the next power of two + k_valid) scores
    identically to raw-k updates."""
    rng = np.random.default_rng(11)
    pairs = 100
    p, q = _random_planes(rng, 8, pairs)
    lib = FingerprintLibrary.from_fingerprints(
        [Fingerprint(p, q)], FingerprintConfig())
    qpos = np.zeros((1, 13, pairs), np.uint8)
    qneg = np.zeros_like(qpos)
    qpos[0], qneg[0] = _random_planes(rng, 13, pairs)
    a = IncrementalLibraryMatcher(lib, batch=1, n_cap=16)
    b = IncrementalLibraryMatcher(lib, batch=1, n_cap=16)
    n = 0
    for k in (3, 1, 7, 2):
        a.update(qpos[:, n:n + k], qneg[:, n:n + k])
        b.update_bucketed(qpos[:, n:n + k], qneg[:, n:n + k])
        n += k
        np.testing.assert_array_equal(a.scores(), b.scores())
    assert a.n == b.n == n


def test_session_pool_bitwise_equal_async():
    """StreamSessionPool: asynchronous per-slot posts folded in ONE batched
    dispatch score bitwise equal to dedicated per-session matchers fed the
    same increments, through uneven schedules, slot reuse and growth."""
    from lbaudiodetective.streaming.incremental import StreamSessionPool

    rng = np.random.default_rng(31)
    pairs = 100
    fps = [Fingerprint(*_random_planes(rng, 6, pairs)) for _ in range(4)]
    lib = FingerprintLibrary.from_fingerprints(fps, FingerprintConfig())
    pool = StreamSessionPool(lib, slots=3, n_cap=4)     # forces growth

    refs: dict[str, IncrementalLibraryMatcher] = {}
    streams: dict[str, tuple[np.ndarray, np.ndarray]] = {}

    def open_(sid):
        pool.open(sid)
        refs[sid] = IncrementalLibraryMatcher(lib, batch=1, n_cap=4)
        streams[sid] = _random_planes(rng, 16, pairs)

    def post(sid, k):
        a0 = refs[sid].n + pool.pending(sid)
        p, q = streams[sid]
        pool.post(sid, p[a0:a0 + k], q[a0:a0 + k])

    def flush_and_check():
        # Feed each session's pending increments to its reference matcher
        # in the same order, then flush the pool once and compare.
        for sid, parts in list(pool._pending.items()):
            p = np.concatenate([x for x, _ in parts])
            q = np.concatenate([x for _, x in parts])
            refs[sid].update(p[None], q[None])
        pool.flush()
        sc_k, ix_k = pool.top_k(2)
        for sid, ref in refs.items():
            if sid not in pool._slot:
                continue
            got = pool.scores_for(sid)
            want = ref.scores()[0]
            np.testing.assert_array_equal(got, want, err_msg=sid)
            g = pool._slot[sid]
            order = np.argsort(-want, kind="stable")[:2]
            np.testing.assert_array_equal(ix_k[g], order, err_msg=sid)
            assert pool.age(sid) == ref.n

    open_("a"); open_("b")
    post("a", 3)
    flush_and_check()
    post("b", 2); post("a", 1)
    flush_and_check()
    open_("c")
    post("c", 4); post("b", 1); post("b", 2)   # two posts, one flush
    flush_and_check()
    post("a", 5)                                # a grows past n_cap=4
    flush_and_check()
    assert pool._m.n_cap >= 9

    # Slot reuse: closing a session zeroes its slot; a new session in the
    # same slot starts fresh.
    slot_b = pool._slot["b"]
    pool.close("b")
    del refs["b"]
    open_("d")
    assert pool._slot["d"] == slot_b
    assert pool.age("d") == 0
    post("d", 2)
    flush_and_check()

    # Idle flush is a no-op; unknown sessions are refused.
    assert pool.flush() == 0
    with pytest.raises(KeyError):
        pool.post("nope", *_random_planes(rng, 1, pairs))
    with pytest.raises(RuntimeError):
        pool.open("e")                          # 3 slots, all taken


def test_session_pool_sharded_library():
    """StreamSessionPool over a mesh-sharded library: slot-batched updates
    vmap over library-axis-sharded state, scores bitwise equal to a plain
    single-device reference matcher."""
    import jax

    from lbaudiodetective.parallel.mesh import make_mesh
    from lbaudiodetective.parallel.sharded_library import (
        ShardedFingerprintLibrary)
    from lbaudiodetective.streaming.incremental import StreamSessionPool

    assert len(jax.devices()) == 8
    rng = np.random.default_rng(61)
    pairs = 100
    fps = [Fingerprint(*_random_planes(rng, 5, pairs)) for _ in range(6)]
    lib = FingerprintLibrary.from_fingerprints(fps, FingerprintConfig())
    slib = ShardedFingerprintLibrary(lib, make_mesh(8, library_parallelism=4))
    pool = StreamSessionPool(slib, slots=3, n_cap=8)
    ref = IncrementalLibraryMatcher(lib, batch=1, n_cap=8)

    p, q = _random_planes(rng, 10, pairs)
    pool.open("x")
    pool.open("y")
    pool.post("x", p[:3], q[:3])
    pool.post("y", np.asarray(fps[2].pos)[:4], np.asarray(fps[2].neg)[:4])
    pool.flush()
    ref.update(p[None, :3], q[None, :3])
    np.testing.assert_array_equal(pool.scores_for("x"), ref.scores()[0])
    sc, ix = pool.top_k(2)
    assert int(ix[pool._slot["y"]][0]) == 2
    assert abs(float(sc[pool._slot["y"]][0]) - 1.0) < 1e-6


def test_incremental_state_roundtrip(tmp_path):
    """save_state/restore_state: a fresh clone restored from a checkpoint
    continues the stream with scores identical to the uninterrupted
    matcher, including across a growth boundary; a checkpoint from a
    different library is refused."""
    rng = np.random.default_rng(23)
    pairs = 100
    fps = [Fingerprint(*_random_planes(rng, 5, pairs)) for _ in range(3)]
    lib = FingerprintLibrary.from_fingerprints(fps, FingerprintConfig())
    qpos = np.zeros((2, 12, pairs), np.uint8)
    qneg = np.zeros_like(qpos)
    for i in range(2):
        qpos[i], qneg[i] = _random_planes(rng, 12, pairs)

    m = IncrementalLibraryMatcher(lib, batch=2, n_cap=4)
    m.update(qpos[:, :3], qneg[:, :3])
    m.update(qpos[:, 3:7], qneg[:, 3:7])       # grows past n_cap=4
    path = str(tmp_path / "sess.npz")
    m.save_state(path)

    fresh = m.clone_empty()
    fresh.restore_state(path)
    assert fresh.n == m.n and fresh.n_cap == m.n_cap
    np.testing.assert_array_equal(fresh.scores(), m.scores())
    # Both continue identically after the restore.
    m.update(qpos[:, 7:12], qneg[:, 7:12])
    fresh.update(qpos[:, 7:12], qneg[:, 7:12])
    np.testing.assert_array_equal(fresh.scores(), m.scores())

    other_lib = FingerprintLibrary.from_fingerprints(
        [Fingerprint(*_random_planes(rng, 5, pairs))], FingerprintConfig())
    other = IncrementalLibraryMatcher(other_lib, batch=2, n_cap=4)
    with pytest.raises(ValueError, match="different library"):
        other.restore_state(path)

    # The state key covers the NEG planes (a library with identical pos
    # planes but different negs must be refused) and comparison_range.
    neg_fps = [Fingerprint(np.asarray(f.pos),
                           np.zeros_like(np.asarray(f.neg))) for f in fps]
    neg_lib = FingerprintLibrary.from_fingerprints(neg_fps,
                                                   FingerprintConfig())
    with pytest.raises(ValueError, match="different library"):
        IncrementalLibraryMatcher(neg_lib, batch=2,
                                  n_cap=4).restore_state(path)
    with pytest.raises(ValueError, match="different library"):
        IncrementalLibraryMatcher(lib, batch=2, n_cap=4,
                                  comparison_range=8).restore_state(path)


def test_incremental_state_roundtrip_sharded(tmp_path):
    """The same round-trip with library-axis-sharded state (the host
    checkpoint re-places onto the mesh with the library sharding)."""
    import jax

    from lbaudiodetective.parallel.mesh import make_mesh
    from lbaudiodetective.parallel.sharded_library import (
        ShardedFingerprintLibrary)

    assert len(jax.devices()) == 8
    rng = np.random.default_rng(29)
    pairs = 100
    fps = [Fingerprint(*_random_planes(rng, 5, pairs)) for _ in range(6)]
    lib = FingerprintLibrary.from_fingerprints(fps, FingerprintConfig())
    slib = ShardedFingerprintLibrary(lib, make_mesh(8, library_parallelism=4))
    qpos = np.zeros((2, 6, pairs), np.uint8)
    qneg = np.zeros_like(qpos)
    for i in range(2):
        qpos[i], qneg[i] = _random_planes(rng, 6, pairs)

    m = IncrementalLibraryMatcher(slib, batch=2, n_cap=8)
    m.update(qpos[:, :4], qneg[:, :4])
    path = str(tmp_path / "sess.npz")
    m.save_state(path)
    fresh = m.clone_empty()
    fresh.restore_state(path)
    m.update(qpos[:, 4:], qneg[:, 4:])
    fresh.update(qpos[:, 4:], qneg[:, 4:])
    np.testing.assert_array_equal(fresh.scores(), m.scores())


def test_serving_session_persistence(decoded_corpus, default_config,
                                     tmp_path):
    """A restarted IdentificationService reloads checkpointed sessions and
    answers the next post exactly as the uninterrupted server would."""
    from tests.conftest import BIRDS
    from lbaudiodetective.ops.extract import extract_fingerprint
    from lbaudiodetective.serving import IdentificationService

    fps = []
    for b in BIRDS[:2]:
        pos, neg, n = extract_fingerprint(decoded_corpus[b], default_config)
        fps.append(Fingerprint.from_planes(np.asarray(pos[:n]),
                                           np.asarray(neg[:n])))
    lib = FingerprintLibrary.from_fingerprints(fps, default_config)
    svc = IdentificationService(lib, BIRDS[:2], default_config)
    sid = svc.stream_open()["session"]
    inc = Fingerprint(np.asarray(fps[1].pos)[:3], np.asarray(fps[1].neg)[:3])
    r1 = svc.stream_update(sid, inc.to_string().encode())
    assert svc.save_sessions(str(tmp_path / "sess")) == 1

    svc2 = IdentificationService(lib, BIRDS[:2], default_config)
    assert svc2.load_sessions(str(tmp_path / "sess")) == 1
    inc2 = Fingerprint(np.asarray(fps[1].pos)[3:5],
                       np.asarray(fps[1].neg)[3:5])
    r_cont = svc2.stream_update(sid, inc2.to_string().encode())
    r_ref = svc.stream_update(sid, inc2.to_string().encode())
    assert r_cont == r_ref and r_cont["n"] == 5
    assert r_cont["track"] == BIRDS[1] and r1["n"] == 3

    # Closed sessions do not resurrect: after close, the next checkpoint
    # removes the stale file and a third boot restores nothing.
    import os

    svc2.stream_close(sid)
    assert svc2.save_sessions(str(tmp_path / "sess")) == 0
    assert not [f for f in os.listdir(tmp_path / "sess")
                if f.endswith(".npz")]

    # A corrupt checkpoint is skipped with a warning, never a boot crash.
    (tmp_path / "sess" / "garbage.npz").write_bytes(b"not an npz")
    svc3 = IdentificationService(lib, BIRDS[:2], default_config)
    assert svc3.load_sessions(str(tmp_path / "sess")) == 0


def test_streaming_identifier_incremental_mode(decoded_corpus,
                                               default_config):
    """StreamingIdentifier(rematch='incremental') produces the same
    per-stream winners and scores as the full-rematch mode on real corpus
    streams."""
    from tests.conftest import BIRDS
    from lbaudiodetective.ops.extract import extract_fingerprint
    from lbaudiodetective.streaming import StreamingIdentifier

    fps = []
    for bird in BIRDS[:4]:
        pos, neg, k = extract_fingerprint(decoded_corpus[bird],
                                          default_config)
        fps.append(Fingerprint.from_planes(np.asarray(pos[:k]),
                                           np.asarray(neg[:k])))
    lib = FingerprintLibrary.from_fingerprints(fps, default_config)

    batch, chunk = 2, 1024
    clips = [decoded_corpus[BIRDS[0] + "_eql"],
             decoded_corpus[BIRDS[3] + "_eql"]]
    total = min(c.samples.shape[0] for c in clips)
    n_steps = total // chunk
    audio = np.stack([c.samples[: n_steps * chunk] for c in clips])

    full = StreamingIdentifier(lib, batch=batch, chunk_size=chunk,
                               config=default_config, match_every=2)
    incr = StreamingIdentifier(lib, batch=batch, chunk_size=chunk,
                               config=default_config, match_every=2,
                               rematch="incremental")
    for s in range(n_steps):
        full.feed(audio[:, s * chunk:(s + 1) * chunk])
        incr.feed(audio[:, s * chunk:(s + 1) * chunk])
    rf, ri = full.finalize(), incr.finalize()
    for a, c in zip(rf, ri):
        assert a.track == c.track
        assert a.score == pytest.approx(c.score, abs=1e-7)
        assert a.n_subfingerprints == c.n_subfingerprints
    assert ri[0].track == 0 and ri[1].track == 3

    with pytest.raises(ValueError, match="rematch"):
        StreamingIdentifier(lib, batch=2, rematch="nope")


def test_incremental_sharded_library_equals_plain():
    """Library-axis-sharded incremental state (8-device mesh, padded entry
    count) must reproduce the single-device incremental scores bitwise at
    every tick — the update is pure data parallelism along L."""
    import jax

    from lbaudiodetective.parallel.mesh import make_mesh
    from lbaudiodetective.parallel.sharded_library import (
        ShardedFingerprintLibrary)

    assert len(jax.devices()) == 8
    rng = np.random.default_rng(9)
    pairs, s_lib, b = 100, 10, 4
    # 13 entries: NOT a multiple of the 4-way library axis (pad coverage).
    sizes = [1, 2, 4, 7, 10, 3, 5, 8, 10, 6, 2, 9, 4]
    fps = []
    for n in sizes:
        p, q = _random_planes(rng, n, pairs)
        fps.append(Fingerprint(p, q))
    lib = FingerprintLibrary.from_fingerprints(fps, FingerprintConfig())
    mesh = make_mesh(8, library_parallelism=4)
    slib = ShardedFingerprintLibrary(lib, mesh)

    n_total = 14
    qpos = np.zeros((b, n_total, pairs), np.uint8)
    qneg = np.zeros_like(qpos)
    for i in range(b):
        qpos[i], qneg[i] = _random_planes(rng, n_total, pairs)
    qpos[1, 1:1 + sizes[7]] = np.asarray(fps[7].pos)   # planted echo
    qneg[1, 1:1 + sizes[7]] = np.asarray(fps[7].neg)

    plain = IncrementalLibraryMatcher(lib, batch=b, n_cap=n_total)
    shard = IncrementalLibraryMatcher(slib, batch=b, n_cap=n_total,
                                      stream_group=2)
    n = 0
    for k in (3, 1, 4, 6):
        plain.update(qpos[:, n:n + k], qneg[:, n:n + k])
        shard.update(qpos[:, n:n + k], qneg[:, n:n + k])
        n += k
        got, want = shard.scores(), plain.scores()
        assert got.shape == (b, len(fps))          # pad trimmed
        np.testing.assert_array_equal(got, want)
    assert int(got[1].argmax()) == 7

    # Device-side top-k == stable descending host sort of scores(), on both
    # the plain and the mesh-sharded matcher (padded entries masked out,
    # ties to the lowest index — lax.top_k semantics).
    for m in (plain, shard):
        sc_k, ix_k = m.top_k(3)
        assert sc_k.shape == ix_k.shape == (b, 3)
        for bi in range(b):
            order = np.argsort(-want[bi], kind="stable")[:3]
            np.testing.assert_array_equal(ix_k[bi], order)
            np.testing.assert_array_equal(sc_k[bi], want[bi][order])
    # k clamps to the true library size (never indexes a padded entry).
    assert plain.top_k(99)[0].shape == (b, len(fps))

    # clone_empty shares the sharded planes but starts fresh: replaying
    # the stream into the clone reproduces the same scores, and the
    # original's state is untouched.
    clone = shard.clone_empty()
    assert clone._lib_pos is shard._lib_pos and clone.n == 0
    n2 = 0
    for k in (5, 9):
        clone.update(qpos[:, n2:n2 + k], qneg[:, n2:n2 + k])
        n2 += k
    np.testing.assert_array_equal(clone.scores(), got)
    assert shard.n == n


def test_streaming_identifier_incremental_sharded(decoded_corpus,
                                                  default_config):
    """StreamingIdentifier(rematch='incremental') over a mesh-sharded
    library matches the full-rematch sharded identifier on corpus
    streams."""
    import jax

    from tests.conftest import BIRDS
    from lbaudiodetective.ops.extract import extract_fingerprint
    from lbaudiodetective.parallel.mesh import make_mesh
    from lbaudiodetective.parallel.sharded_library import (
        ShardedFingerprintLibrary)
    from lbaudiodetective.streaming import StreamingIdentifier

    assert len(jax.devices()) == 8
    fps = []
    for bird in BIRDS[:4]:
        pos, neg, k = extract_fingerprint(decoded_corpus[bird],
                                          default_config)
        fps.append(Fingerprint.from_planes(np.asarray(pos[:k]),
                                           np.asarray(neg[:k])))
    lib = FingerprintLibrary.from_fingerprints(fps, default_config)
    mesh = make_mesh(8, library_parallelism=4)
    slib = ShardedFingerprintLibrary(lib, mesh)

    batch, chunk = 2, 1024
    clips = [decoded_corpus[BIRDS[0] + "_eql"],
             decoded_corpus[BIRDS[3] + "_eql"]]
    total = min(c.samples.shape[0] for c in clips)
    n_steps = total // chunk
    audio = np.stack([c.samples[: n_steps * chunk] for c in clips])

    full = StreamingIdentifier(slib, batch=batch, chunk_size=chunk,
                               config=default_config, match_every=2)
    incr = StreamingIdentifier(slib, batch=batch, chunk_size=chunk,
                               config=default_config, match_every=2,
                               rematch="incremental")
    for s in range(n_steps):
        full.feed(audio[:, s * chunk:(s + 1) * chunk])
        incr.feed(audio[:, s * chunk:(s + 1) * chunk])
    rf, ri = full.finalize(), incr.finalize()
    for a, c in zip(rf, ri):
        assert a.track == c.track
        assert a.score == pytest.approx(c.score, abs=1e-6)
        assert a.n_subfingerprints == c.n_subfingerprints
    assert ri[0].track == 0 and ri[1].track == 3
