"""ShardedFingerprintLibrary: the mesh-sharded library must be score- and
ranking-identical to the single-device FingerprintLibrary, including when
driven through the serving edge."""

import numpy as np
import jax
import pytest

from lbaudiodetective.models.fingerprint import Fingerprint
from lbaudiodetective.models.library import FingerprintLibrary
from lbaudiodetective.parallel.mesh import make_mesh
from lbaudiodetective.parallel.sharded_library import (
    ShardedFingerprintLibrary)
from tests.test_match import random_fp


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8
    return make_mesh(8, library_parallelism=4)


def _fps(rng, sizes, pairs=100):
    out = []
    for n in sizes:
        p, q = random_fp(rng, int(n), pairs)
        out.append(Fingerprint.from_planes(p, q, 2 * pairs))
    return out


def test_sharded_match_equals_single_device(mesh):
    rng = np.random.default_rng(81)
    # 11 entries: NOT a multiple of the 4-way library axis -> exercises
    # zero-count padding.
    fps = _fps(rng, [12, 3, 7, 9, 1, 12, 5, 8, 10, 2, 6])
    lib = FingerprintLibrary.from_fingerprints(fps)
    slib = ShardedFingerprintLibrary(lib, mesh)
    assert len(slib) == len(lib) == 11
    for qi in (0, 4, 10):
        ref = lib.match(fps[qi])
        got = slib.match(fps[qi])
        np.testing.assert_array_equal(got, ref)
        assert got.shape == (11,)


def test_sharded_search_equals_single_device(mesh):
    rng = np.random.default_rng(82)
    fps = _fps(rng, [8 + (i % 5) for i in range(30)])
    lib = FingerprintLibrary.from_fingerprints(fps)
    slib = ShardedFingerprintLibrary(lib, mesh)
    for qi in (3, 17):
        ref_idx, ref_sc = lib.search(fps[qi], top_k=4)
        got_idx, got_sc = slib.search(fps[qi], top_k=4)
        np.testing.assert_array_equal(got_idx, ref_idx)
        np.testing.assert_allclose(got_sc, ref_sc, rtol=0, atol=0)
    gi, gs = slib.search_many([fps[3], fps[17]], top_k=4)
    np.testing.assert_array_equal(gi[0], lib.search(fps[3], top_k=4)[0])
    np.testing.assert_array_equal(gi[1], lib.search(fps[17], top_k=4)[0])
    assert gs.shape == (2, 4)


def test_search_zero_score_query_never_returns_padding(mesh):
    """Worst case for the +pad candidate over-ask: an all-zero (silence)
    query scores 0 against every entry, so padded entries (also 0) tie with
    real ones in each shard's top-k.  The over-ask must still leave >=
    top_k REAL candidates after filtering — indices < L, full shapes, no
    broadcast error in search_many."""
    rng = np.random.default_rng(85)
    fps = _fps(rng, [6, 9, 5, 7, 8, 4, 10])             # 7 entries over 4 shards
    lib = FingerprintLibrary.from_fingerprints(fps)
    slib = ShardedFingerprintLibrary(lib, mesh)
    pairs = fps[0].pairs
    zero_q = Fingerprint.from_planes(np.zeros((5, pairs), np.uint8),
                                     np.zeros((5, pairs), np.uint8),
                                     2 * pairs)
    idx, sc = slib.search(zero_q, top_k=5)
    assert idx.shape == (5,) and (idx < 7).all() and (sc == 0.0).all()
    bi, bs = slib.search_many([zero_q, fps[1], zero_q], top_k=5)
    assert bi.shape == (3, 5) and (bi < 7).all()
    assert (bs[0] == 0.0).all() and (bs[2] == 0.0).all()


def test_search_many_batched_equals_looped(mesh):
    """The single-dispatch batched sharded search must rank exactly like
    per-query sharded searches AND the single-device library, across a
    library size that forces entry-axis padding."""
    rng = np.random.default_rng(84)
    fps = _fps(rng, [5 + (i % 7) for i in range(27)])   # 27 % 4 != 0
    lib = FingerprintLibrary.from_fingerprints(fps)
    slib = ShardedFingerprintLibrary(lib, mesh)
    queries = [fps[i] for i in (0, 9, 13, 22, 26)]
    bi, bs = slib.search_many(queries, top_k=3)
    assert bi.shape == (5, 3)
    for r, q in enumerate(queries):
        li, ls = slib.search(q, top_k=3)
        np.testing.assert_array_equal(bi[r], li)
        np.testing.assert_array_equal(bs[r], ls)
        ri, rs = lib.search(q, top_k=3)
        np.testing.assert_array_equal(bi[r], ri)
        np.testing.assert_allclose(bs[r], rs, rtol=0, atol=0)


def test_search_chunk_not_dividing_shard(mesh):
    """A chunk size that does not divide the per-shard slice must work (the
    pod-scale shape: 1M/8 = 125,000 is not a multiple of 65,536) — the
    coarse planes pad per shard inside the runner.  Returned scores are
    exact re-scores, so they must equal the brute-force matcher's."""
    rng = np.random.default_rng(85)
    fps = _fps(rng, [6 + (i % 5) for i in range(24)])   # l_local=6, chunk 4
    lib = FingerprintLibrary.from_fingerprints(fps)
    slib = ShardedFingerprintLibrary(lib, mesh)
    for qi in (0, 11, 23):
        idx, sc = slib.search(fps[qi], top_k=3, shortlist=2, chunk=4,
                              coarse_stride=2)
        brute = lib.match(fps[qi])
        assert int(idx[0]) == qi and sc[0] == pytest.approx(1.0)
        for j, s in zip(idx, sc):
            assert s == brute[int(j)]                  # exact re-score
    bi, bs = slib.search_many([fps[0], fps[11]], top_k=3, shortlist=2,
                              chunk=4, coarse_stride=2)
    assert int(bi[0, 0]) == 0 and int(bi[1, 0]) == 11


def test_match_many_and_identify(mesh):
    rng = np.random.default_rng(83)
    fps = _fps(rng, [6, 9, 12, 4, 8])
    lib = FingerprintLibrary.from_fingerprints(fps)
    slib = ShardedFingerprintLibrary(lib, mesh)
    ref = lib.match_many(fps[:3])
    got = slib.match_many(fps[:3])
    np.testing.assert_array_equal(got, ref)
    bi, bs = slib.identify(fps[2])
    assert bi == 2 and bs == pytest.approx(1.0)


def test_save_load_sharded_roundtrip(mesh, tmp_path):
    """Pod restart path: persist the sharded DB (one file per library-axis
    device), re-attach to the mesh, and get identical scores — including
    when the on-disk shard count differs from the mesh axis."""
    rng = np.random.default_rng(86)
    fps = _fps(rng, [7, 4, 9, 5, 11, 6, 8])            # 7 entries: pads
    lib = FingerprintLibrary.from_fingerprints(fps)
    slib = ShardedFingerprintLibrary(lib, mesh)
    d = str(tmp_path / "db")
    slib.save_sharded(d)
    re = ShardedFingerprintLibrary.load_sharded(d, mesh, lib.config)
    assert len(re) == 7
    np.testing.assert_array_equal(re.match(fps[3]), slib.match(fps[3]))
    # Different shard count on disk than mesh axis: still reconstructs.
    d2 = str(tmp_path / "db2")
    slib.save_sharded(d2, n_shards=3)
    re2 = ShardedFingerprintLibrary.load_sharded(d2, mesh, lib.config)
    np.testing.assert_array_equal(re2.match(fps[3]), slib.match(fps[3]))
    # Parameter-hash guard still applies.
    from lbaudiodetective.config import FingerprintConfig
    with pytest.raises(ValueError):
        ShardedFingerprintLibrary.load_sharded(
            d, mesh, FingerprintConfig(subfingerprint_length=100))


def test_serving_edge_with_sharded_library(mesh, tmp_path):
    """IdentificationService duck-types over the sharded library: identical
    responses to the single-device service on a real corpus payload."""
    from tests.conftest import CORPUS
    from lbaudiodetective.models.detective import AudioDetective
    from lbaudiodetective.serving import IdentificationService

    det = AudioDetective()
    names = ["BlackBird", "Wren"]
    fps = [det.process_audio_file(str(CORPUS / "Archive" / f"{n}.caf"))
           for n in names]
    lib = FingerprintLibrary.from_fingerprints(fps)
    slib = ShardedFingerprintLibrary(lib, mesh)
    payload = (CORPUS / "Cropped/Equal" / "BlackBird_eql.caf").read_bytes()

    ref = IdentificationService(lib, names).identify(payload)
    got = IdentificationService(slib, names).identify(payload)
    assert got == ref
    assert got["track"] == "BlackBird"

    # Search path (force it with a tiny threshold) responds identically too.
    ref_s = IdentificationService(lib, names, search_threshold=1,
                                  top_k=2).identify(payload)
    got_s = IdentificationService(slib, names, search_threshold=1,
                                  top_k=2).identify(payload)
    assert got_s == ref_s
    assert [e["track"] for e in got_s["top"]][0] == "BlackBird"


def test_streaming_sessions_over_sharded_library(mesh):
    """Serving-edge live-recognition sessions against a mesh-sharded
    library: running results must equal the same session replayed against
    the single-device service."""
    from lbaudiodetective.serving import IdentificationService

    rng = np.random.default_rng(83)
    fps = _fps(rng, [6, 9, 4, 11, 7, 10, 3])       # 7: pads the 4-way axis
    names = [f"t{i}" for i in range(len(fps))]
    lib = FingerprintLibrary.from_fingerprints(fps)
    plain = IdentificationService(lib, names, stream_cap=16)
    shard = IdentificationService(ShardedFingerprintLibrary(lib, mesh),
                                  names, stream_cap=16)

    text = fps[3].to_string()
    subs = text.split("+")
    sp = plain.stream_open()["session"]
    ss = shard.stream_open()["session"]
    i = 0
    for k in (2, 5, 4):
        chunk = "+".join(subs[i:i + k]).encode()
        i += k
        rp = plain.stream_update(sp, chunk)
        rs = shard.stream_update(ss, chunk)
        assert rs["n"] == rp["n"] == i
        assert rs["track"] == rp["track"]
        assert rs["score"] == pytest.approx(rp["score"], abs=1e-7)
    fp_, fs_ = plain.stream_close(sp), shard.stream_close(ss)
    assert fs_["track"] == fp_["track"] == "t3"
    assert fs_["score"] == pytest.approx(1.0, abs=1e-5)


def test_stream_sessions_concurrent_threads():
    """Thread-fuzz the session table: concurrent sessions (ThreadingHTTPServer
    semantics) each streaming their own entry must all converge on their own
    track with the sequential-replay score — the shared template/clone path
    and the session dict are thread-safe."""
    import threading

    from lbaudiodetective.serving import IdentificationService

    rng = np.random.default_rng(84)
    fps = _fps(rng, [8, 8, 8, 8, 8, 8, 8, 8])
    names = [f"t{i}" for i in range(len(fps))]
    svc = IdentificationService(FingerprintLibrary.from_fingerprints(fps),
                                names, stream_cap=16, max_sessions=8)

    results: dict[int, dict] = {}
    errors: list[Exception] = []

    def worker(i: int) -> None:
        try:
            subs = fps[i].to_string().split("+")
            sid = svc.stream_open()["session"]
            for j in range(0, len(subs), 3):
                svc.stream_update(sid, "+".join(subs[j:j + 3]).encode())
            results[i] = svc.stream_close(sid)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(results) == 8
    for i, r in results.items():
        assert r["track"] == names[i] and r["n"] == 8
        assert r["score"] == pytest.approx(1.0, abs=1e-5)
