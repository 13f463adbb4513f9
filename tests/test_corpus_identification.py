"""Corpus identification matrices with REAL assertions.

The reference's five XCTest identification tests log results but assert
nothing (XCTAssertFalse(false,...), LBAudioDetectiveTests.m:88); here the
diagonal-wins criterion and the published score structure (essay §4.2,
Figures 24-28) are enforced.  Expected values are goldens of this framework
at the SHIPPED DEFAULT config (integer_hop spec), cross-checked against the
essay; diag values are % match scores:

  suite   ours (shipped default)                essay (2013 reference)
  _eql    10/10, diag 56.6-99.7 (Chaffinch low) 10/10, diag 92.7-98.9
  _dif    0/10,  diag 50.4-54.1                 1/10,  diag 49.5-53.9
  _blu1   6/10,  diag 52.5-79.3 (Crow max)      diag 52.7-75.5 (Crow max)
  _blu2   8/10,  diag 51.2-75.0 (Crow max)      diag 50.5-72.7 (Crow max)
  _rec    4/10,  diag 52.1-55.4                 2/10,  diag 49.6-53.4

Fixture integrity: the fingerprint cache key includes a digest of the live
pipeline's fingerprints on seeded clips (conftest.fixture_key), so a change
to the extracted bits invalidates the committed fixtures and these matrices
recompute live.
"""

import numpy as np
import pytest

from tests.conftest import BIRDS, CACHE
from lbaudiodetective.ops.extract import extract_fingerprint
from lbaudiodetective.ops.match import match_fingerprints


@pytest.fixture(scope="module")
def jax_fingerprints(decoded_corpus, default_config, fixture_key):
    """name -> (pos, neg) JAX-extracted fingerprints, disk-cached."""
    key = fixture_key
    out = {}
    for name in decoded_corpus.keys():
        cache_file = CACHE / f"jaxfp_{key}_{name}.npz"
        if cache_file.exists():
            z = np.load(cache_file)
            out[name] = (z["pos"], z["neg"])
        else:
            pos, neg, n = extract_fingerprint(decoded_corpus[name], default_config)
            out[name] = (pos[:n], neg[:n])
            np.savez(cache_file, pos=out[name][0], neg=out[name][1])
    return out


def matrix(jax_fingerprints, suffix: str) -> np.ndarray:
    m = np.zeros((10, 10))
    for i, orig in enumerate(BIRDS):
        for j, seq in enumerate(BIRDS):
            m[i, j] = match_fingerprints(jax_fingerprints[orig],
                                         jax_fingerprints[seq + suffix]) * 100.0
    return m


def identified(m: np.ndarray) -> int:
    return int(sum(m[i, i] == m[i].max() for i in range(10)))


def diag_dict(m: np.ndarray) -> dict:
    return {b: m[i, i] for i, b in enumerate(BIRDS)}


def test_equal_birds(jax_fingerprints):
    """Essay Test 1 (Fig. 24): exact crops -> every bird identified, diagonal
    in the 90s.  Chaffinch's crop carries a small perturbation vs the archive
    prefix (ncc 0.9932 at offset 0) and scores ~57 here; see CALIBRATION.md."""
    m = matrix(jax_fingerprints, "_eql")
    assert identified(m) == 10
    diag = np.diag(m)
    assert (np.sort(diag)[1:] >= 95.0).all()        # all but Chaffinch >= 95.1
    assert diag.min() >= 56.0                       # Chaffinch golden 56.6
    off = m[~np.eye(10, dtype=bool)]
    assert off.max() < 55.0                         # golden off-diag max 54.3


def test_different_birds(jax_fingerprints):
    """Essay Test 2 (Fig. 25): different recordings of the same species land
    in the ~50% chance regime.  The essay identified 1/10 (chance level); at
    the shipped integer_hop default this framework identifies 0/10 — the
    robust signal is that no pair scores far from 50%."""
    m = matrix(jax_fingerprints, "_dif")
    assert identified(m) == 0                       # golden at shipped default
    diag = np.diag(m)
    assert (diag >= 50.0).all() and (diag <= 54.5).all()   # golden 50.4-54.1
    assert m.max() < 56.0 and m.min() > 49.0


def test_blurred1_birds(jax_fingerprints):
    """Essay Test 3.1 (Fig. 26): 1.58% noise — per-bird robustness ordering
    matches the essay (Crow/BlackBird strongest, then Pigeon/Kestrel)."""
    m = matrix(jax_fingerprints, "_blu1")
    assert identified(m) == 6                       # golden at shipped default
    d = diag_dict(m)
    assert d["Crow"] >= 79.0 and d["BlackBird"] >= 74.0   # golden 79.3 / 74.6
    assert d["Pigeon"] >= 65.0 and d["Kestrel"] >= 63.0   # golden 65.3 / 63.6
    assert np.diag(m).min() >= 52.0                       # golden min 52.5


def test_blurred2_birds(jax_fingerprints):
    """Essay Test 3.2 (Fig. 27): 3.16% noise — degraded but Crow still high."""
    m = matrix(jax_fingerprints, "_blu2")
    assert identified(m) == 8                       # golden at shipped default
    d = diag_dict(m)
    assert d["Crow"] >= 74.5                        # golden 75.0
    assert d["BlackBird"] >= 69.0                   # golden 69.9
    assert np.diag(m).min() >= 51.0                 # golden min 51.2


def test_recorded_birds(jax_fingerprints):
    """Essay Test 4 (Fig. 28): mic re-capture — scores hover near 50%."""
    m = matrix(jax_fingerprints, "_rec")
    assert identified(m) == 4                       # golden at shipped default
    diag = np.diag(m)
    assert (diag >= 52.0).all() and (diag <= 55.5).all()  # golden 52.1-55.4


def test_chaffinch_prefix_crop_scores_like_essay(jax_fingerprints, default_config):
    """Root-cause regression (CALIBRATION.md): the shipped Chaffinch_eql is a
    re-exported generation (9/10 other _eql crops are byte-exact archive
    prefixes; Chaffinch's has residual RMS 11.6% of signal, in-band).  On a
    bit-exact prefix crop — what the essay's Test 1 actually measured — this
    pipeline scores inside the essay's 93-99 range, proving no
    Chaffinch-specific robustness gap."""
    from lbaudiodetective.io import caf
    from lbaudiodetective.io.decode import DecodedAudio
    from lbaudiodetective.io.resample import resample_rational
    from tests.conftest import corpus_path

    a44, _ = caf.read_caf(corpus_path("Chaffinch"))
    e44, _ = caf.read_caf(corpus_path("Chaffinch_eql"))
    n = len(e44)
    proc = resample_rational(np.asarray(a44[:n], np.float32), 44100.0, 5512.0)
    crop = DecodedAudio(np.asarray(proc, np.float32), 5512.0, n, 44100.0)
    pos, neg, ns = extract_fingerprint(crop, default_config)
    score = match_fingerprints(jax_fingerprints["Chaffinch"],
                               (pos[:ns], neg[:ns])) * 100.0
    assert score >= 93.0, f"bit-exact prefix crop scored {score:.1f}"
