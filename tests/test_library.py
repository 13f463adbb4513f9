"""FingerprintLibrary: packed DB construction, matching, identification,
persistence (corpus-backed)."""

import numpy as np
import pytest

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.models.detective import AudioDetective
from lbaudiodetective.models.library import FingerprintLibrary
from tests.conftest import BIRDS, corpus_path


@pytest.fixture(scope="module")
def corpus_library():
    det = AudioDetective()
    fps = [det.process_audio_file(corpus_path(b)) for b in BIRDS[:5]]
    return det, fps, FingerprintLibrary.from_fingerprints(fps, det.config)


def test_identify_corpus(corpus_library):
    det, fps, lib = corpus_library
    assert len(lib) == 5
    query = det.process_audio_file(corpus_path("Chaffinch_eql"))  # index 2
    best, score = lib.identify(query)
    assert best == 2
    scores = lib.match(query)
    np.testing.assert_allclose(scores[best], score)
    # Consistent with the pairwise matcher.
    direct = det.compare_fingerprints(fps[2], query)
    np.testing.assert_allclose(score, direct, atol=1e-6)


def test_library_roundtrip(tmp_path, corpus_library):
    det, fps, lib = corpus_library
    p = str(tmp_path / "lib.npz")
    lib.save(p)
    loaded = FingerprintLibrary.load(p, det.config)
    query = det.process_audio_file(corpus_path("BlueTit_eql"))
    np.testing.assert_allclose(loaded.match(query), lib.match(query), atol=1e-7)
    with pytest.raises(ValueError):
        FingerprintLibrary.load(p, FingerprintConfig(analysis_stride=32))


def test_library_load_honours_stored_length(tmp_path):
    """A config-less load of a library built at a non-default
    subfingerprint length must adopt the stored length instead of silently
    matching over the default pair count."""
    from lbaudiodetective.models.fingerprint import FingerprintBuilder

    cfg = FingerprintConfig(subfingerprint_length=128)
    rng = np.random.default_rng(3)
    fps = []
    for _ in range(4):
        b = FingerprintBuilder(cfg.subfingerprint_length)
        for _ in range(6):
            b.add_subfingerprint(rng.integers(0, 2, 128).astype(bool))
        fps.append(b.freeze())
    lib = FingerprintLibrary.from_fingerprints(fps, cfg)
    p = str(tmp_path / "short.npz")
    lib.save(p)
    loaded = FingerprintLibrary.load(p)
    assert loaded.config.subfingerprint_length == 128
    np.testing.assert_allclose(loaded.match(fps[1]), lib.match(fps[1]),
                               atol=1e-7)


def test_library_extend_matches_fresh(corpus_library):
    """extend() must equal a library built from scratch with the same
    fingerprints (packed entries, counts, pairs, scores)."""
    import numpy as np

    from lbaudiodetective.models.library import FingerprintLibrary

    det, fps, lib = corpus_library
    base = FingerprintLibrary.from_fingerprints(fps[:2], lib.config)
    grown = base.extend(fps[2:])
    fresh = FingerprintLibrary.from_fingerprints(fps, lib.config)
    assert len(grown) == len(fresh)
    q = fps[-1]
    np.testing.assert_allclose(np.asarray(grown.match(q)),
                               np.asarray(fresh.match(q)), atol=1e-6)
    assert grown.extend([]) is grown


def test_match_many_equals_per_query(corpus_library):
    """Batched multi-query matching == stacked single-query matches."""
    import numpy as np

    det, fps, lib = corpus_library
    queries = fps[:3]
    got = lib.match_many(queries)
    assert got.shape == (3, len(lib))
    ref = np.stack([lib.match(q) for q in queries])
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert lib.match_many([]).shape == (0, len(lib))


def test_search_two_stage_recovers_brute_force(corpus_library):
    """search() with a shortlist smaller than the library (coarse pass
    engaged) must return the brute-force best entry with its EXACT score."""
    det, fps, lib = corpus_library
    for qname, want in [("Chaffinch_eql", 2), ("BlueTit_eql", 1)]:
        query = det.process_audio_file(corpus_path(qname))
        brute = lib.match(query)
        idx, scores = lib.search(query, top_k=2, shortlist=3,
                                 coarse_stride=2, coarse_range=64)
        assert idx[0] == want == int(np.argmax(brute))
        np.testing.assert_allclose(scores[0], brute[want], atol=1e-7)
        assert scores[0] >= scores[1]


def test_search_small_library_is_exact_sort(corpus_library):
    """l <= shortlist short-circuits to the exact matcher: results must be
    the full brute-force ranking."""
    det, fps, lib = corpus_library
    query = det.process_audio_file(corpus_path("Chaffinch_eql"))
    brute = lib.match(query)
    idx, scores = lib.search(query, top_k=len(lib), shortlist=len(lib))
    np.testing.assert_array_equal(idx, np.argsort(-brute, kind="stable"))
    np.testing.assert_allclose(scores, brute[idx])


def test_search_synthetic_recall():
    """Recall on a synthetic 64-entry library of perturbed variants: the
    true (least-perturbed) entry must survive a stride-4/range-64 coarse
    pass at shortlist=8, across chunked coarse dispatches."""
    from lbaudiodetective.models.fingerprint import Fingerprint

    rng = np.random.default_rng(7)
    s, pairs = 48, 100
    base_pos = (rng.random((s, pairs)) < 0.45).astype(np.uint8)
    base_neg = ((rng.random((s, pairs)) < 0.45) & (base_pos == 0)).astype(np.uint8)
    fps = []
    for i in range(64):
        flips = (rng.random((s, pairs)) < (0.02 if i == 11 else 0.30))
        pos = np.where(flips, 1 - base_pos, base_pos).astype(np.uint8)
        neg = np.where(flips & (pos == 0), 1 - base_neg, base_neg * (1 - pos)).astype(np.uint8)
        fps.append(Fingerprint(pos, neg))
    lib = FingerprintLibrary.from_fingerprints(fps, FingerprintConfig())
    query = Fingerprint(base_pos, base_neg)
    brute = lib.match(query)
    assert int(np.argmax(brute)) == 11
    idx, scores = lib.search(query, top_k=1, shortlist=8, chunk=16)
    assert idx[0] == 11
    np.testing.assert_allclose(scores[0], brute[11], atol=1e-7)
