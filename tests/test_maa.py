"""MAA (Melody Analyzing Algorithm) — the essay's rejected predecessor.

The reference repo ships no MAA code; the spec is the essay's §3.2.1.1
(Listing 1), §3.2.3.1 (Listing 3) and §4.1.1 (Figure 23).  These tests pin
our deterministic spec-reconstruction and reproduce the essay's published
CONCLUSION (the MAA is fragile to window misalignment and was rejected for
the AFA) with controlled experiments.
"""

import numpy as np

import jax.numpy as jnp

from lbaudiodetective.io.decode import decode_audio_file_raw
from lbaudiodetective.models.maa import (CATEGORY_HZ, N_CATEGORIES,
                                         WINDOW, maa_fingerprint_file,
                                         maa_match_count,
                                         maa_subfingerprints)
from tests.conftest import BIRDS, CORPUS


def test_category_peaks_on_synthetic_tones():
    """Two tones land as the peak pitch of their 4,400 Hz categories."""
    sr = 44100.0
    t = np.arange(int(sr)) / sr
    sig = (np.sin(2 * np.pi * 1000 * t)
           + 0.5 * np.sin(2 * np.pi * 6000 * t)).astype(np.float32)
    f = np.asarray(maa_subfingerprints(jnp.asarray(sig), sr))
    assert f.shape == (int(sr) // WINDOW, N_CATEGORIES)
    bin_hz = sr / WINDOW
    assert abs(f[0, 0] - 1000) <= bin_hz          # category 0: 0-4400 Hz
    assert abs(f[0, 1] - 6000) <= bin_hz          # category 1: 4400-8800 Hz
    assert np.all(f >= 0) and np.all(f < N_CATEGORIES * CATEGORY_HZ)


def test_match_count_semantics():
    sr = 44100.0
    rng = np.random.default_rng(3)
    sig = rng.standard_normal(int(sr * 2)).astype(np.float32)
    f = np.asarray(maa_subfingerprints(jnp.asarray(sig), sr))
    assert maa_match_count(f, f) == f.shape[0]            # d=0 < 400 always
    assert maa_match_count(f, f[10:30]) == 20             # offset slide
    assert maa_match_count(f[10:30], f) == 20             # swap-to-longer
    assert maa_match_count(f, f + 500.0) == 0             # d=2500 >= 400
    # Just-below/above the essay's d < 400 threshold, on one category.
    g = f.copy()
    g[:, 0] += 399.0
    assert maa_match_count(f, g) == f.shape[0]
    g[:, 0] += 2.0
    assert maa_match_count(f, g) == 0


def test_window_misalignment_fragility():
    """The essay's rejection rationale, quantified: a 100-sample crop shift
    destroys the match (the AFA's 64-frame hop tolerates it — that contrast
    is WHY the reference ships the AFA)."""
    s, r = decode_audio_file_raw(str(CORPUS / "Archive" / "BlackBird.caf"))
    n = int(4 * r) // WINDOW * WINDOW
    f_orig = np.asarray(maa_subfingerprints(jnp.asarray(s), float(r)))
    f_aligned = np.asarray(maa_subfingerprints(jnp.asarray(s[:n]), float(r)))
    f_shifted = np.asarray(
        maa_subfingerprints(jnp.asarray(s[100:100 + n]), float(r)))
    n_win = f_aligned.shape[0]
    assert maa_match_count(f_orig, f_aligned) == n_win
    assert maa_match_count(f_orig, f_shifted) < 0.1 * n_win


def test_corpus_equal_matrix_pinned():
    """Deterministic 10x10 Test-1 matrix: every bird whose _eql crop is a
    bit-exact prefix crop matches near-perfectly (the crops are
    window-aligned at offset 0 — CALIBRATION.md); Chaffinch, the known
    re-exported outlier, collapses to ~0 — independent corroboration of the
    round-2 Chaffinch root cause.  (The essay's own Figure 23 reports 3/10
    on its lost 2013 implementation; our reconstruction is pinned on the
    shipped corpus instead.)"""
    orig = {b: maa_fingerprint_file(str(CORPUS / "Archive" / f"{b}.caf"))
            for b in BIRDS}
    eql = {b: maa_fingerprint_file(
        str(CORPUS / "Cropped/Equal" / f"{b}_eql.caf")) for b in BIRDS}
    identified = []
    for b in BIRDS:
        diag = maa_match_count(orig[b], eql[b])
        off = max(maa_match_count(orig[o], eql[b]) for o in BIRDS if o != b)
        if diag > off:
            identified.append(b)
        if b == "Chaffinch":
            assert diag <= 2, "re-exported crop should not window-align"
        else:
            assert diag >= 0.9 * eql[b].shape[0]
        assert off <= 2
    assert len(identified) == 9
    assert "Chaffinch" not in identified


def test_low_rate_refused():
    """Empty frequency categories (rates below ~35 kHz) are refused instead
    of silently inflating match counts with argmax-of-empty sentinel bins."""
    import pytest

    sig = jnp.zeros(8000, jnp.float32)
    with pytest.raises(ValueError, match="category"):
        maa_subfingerprints(sig, 8000.0)
