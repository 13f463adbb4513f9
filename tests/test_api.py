"""Public API + compat-layer parity tests (LBAudioDetective.h surface)."""

import numpy as np
import pytest

from lbaudiodetective import compat
from lbaudiodetective.models.detective import AudioDetective
from lbaudiodetective.models.fingerprint import Fingerprint
from tests.conftest import corpus_path


@pytest.fixture(scope="module")
def detective():
    return AudioDetective()


def test_defaults_match_reference(detective):
    assert detective.processing_sample_rate == 5512.0
    assert detective.window_size == 2048
    assert detective.analysis_stride == 64
    assert detective.number_of_pitch_steps == 32
    assert detective.subfingerprint_length == 200


def test_setters_replace_config(detective):
    d = AudioDetective()
    d.analysis_stride = 32
    assert d.analysis_stride == 32
    d.window_size = 1024
    assert d.window_size == 1024
    with pytest.raises(ValueError):
        d.window_size = 2000  # spec-corrected Q4


def test_process_and_compare(detective):
    fp = detective.process_audio_file(corpus_path("BlackBird"))
    assert fp.num_subfingerprints == 48
    assert fp.pairs == 100
    score = detective.compare_audio_files(corpus_path("BlackBird"),
                                          corpus_path("BlackBird_eql"))
    assert 0.9 < score <= 1.0


def test_fingerprint_copy_equality(detective):
    """Reference testFingerprintComparison (Tests.m:141-155)."""
    fp = detective.process_audio_file(corpus_path("Sparrow"))
    cp = fp.copy()
    assert fp == cp
    assert compat.LBAudioDetectiveFingerprintEqualToFingerprint(fp, cp)
    mutated = Fingerprint(cp.pos.copy(), cp.neg.copy())
    mutated.pos[0, 0] ^= 1
    assert fp != mutated


def test_subfingerprint_boolean_layout(detective):
    """Quirk Q1 interleaving: bool[2j]=pos rank j, bool[2j+1]=neg rank j."""
    fp = detective.process_audio_file(corpus_path("Crow"))
    bools = fp.subfingerprint_booleans(0)
    assert bools.shape == (200,)
    np.testing.assert_array_equal(bools[0::2], fp.pos[0])
    np.testing.assert_array_equal(bools[1::2], fp.neg[0])


def test_match_against_library(detective):
    lib_names = ["BlackBird", "Wren", "Crow"]
    lib = [detective.process_audio_file(corpus_path(n)) for n in lib_names]
    query = detective.process_audio_file(corpus_path("Wren_eql"))
    scores = detective.match_against_library(query, lib)
    assert scores.shape == (3,)
    assert np.argmax(scores) == 1  # Wren wins
    one = detective.compare_fingerprints(lib[1], query)
    np.testing.assert_allclose(scores[1], one, atol=1e-6)


def test_compat_names_roundtrip():
    d = compat.LBAudioDetectiveNew()
    assert compat.LBAudioDetectiveGetWindowSize(d) == 2048
    compat.LBAudioDetectiveSetAnalysisStride(d, 128)
    assert compat.LBAudioDetectiveGetAnalysisStride(d) == 128
    compat.LBAudioDetectiveSetAnalysisStride(d, 64)
    fp = compat.LBAudioDetectiveProcessAudioURL(d, corpus_path("Pigeon"))
    assert compat.LBAudioDetectiveFingerprintGetNumberOfSubfingerprints(fp) > 0
    assert compat.LBAudioDetectiveFingerprintGetSubfingerprintLength(fp) == 200
    fp2 = compat.LBAudioDetectiveFingerprintCopy(fp)
    score = compat.LBAudioDetectiveFingerprintCompareToFingerprint(fp, fp2, 200)
    np.testing.assert_allclose(score, 1.0, atol=1e-6)
    # Raw compare with inRange=0 iterates zero booleans in the reference
    # (Fingerprint.m:155,171-175) -> 0.0; only CompareAudioURLs defaults it.
    assert compat.LBAudioDetectiveFingerprintCompareToFingerprint(fp, fp2, 0) == 0.0
    # Golden string serializer (LBAudioDetectiveTests.m:22-37) round-trips.
    s = compat.stringFromFingerprint(fp)
    assert set(s) <= {"0", "1", "+"}
    assert s.split("+")[0] != "0" * 200          # non-degenerate bits
    from lbaudiodetective.models.fingerprint import Fingerprint
    assert Fingerprint.from_string(s) == fp
    match = compat.LBAudioDetectiveCompareAudioURLs(
        d, corpus_path("Pigeon"), corpus_path("Pigeon_eql"), 0)
    assert 0.9 < match <= 1.0
    compat.LBAudioDetectiveDispose(d)
    with pytest.raises(ValueError):
        compat.LBAudioDetectiveProcessAudioURL(d, None)
    with pytest.raises(ValueError):
        compat.LBAudioDetectiveDispose(None)


def test_context_manager():
    with AudioDetective() as d:
        assert d.window_size == 2048


# -- builder path (LBAudioDetectiveFingerprint.h:27,35,98,108,147) -----------

def test_builder_copy_equality_roundtrip(detective):
    """Reference copy-equality test (Tests.m:141-155) rebuilt through the
    incremental builder path: re-adding each extracted subfingerprint's
    boolean buffer via AddSubfingerprint reproduces the processed
    fingerprint exactly."""
    fp = detective.process_audio_file(corpus_path("Wren"))
    b = compat.LBAudioDetectiveFingerprintNew(0)
    ok, eff = compat.LBAudioDetectiveFingerprintSetSubfingerprintLength(
        b, fp.subfingerprint_length)
    assert ok and eff == 200
    for i in range(fp.num_subfingerprints):
        compat.LBAudioDetectiveFingerprintAddSubfingerprint(
            b, fp.subfingerprint_booleans(i))
    assert compat.LBAudioDetectiveFingerprintGetNumberOfSubfingerprints(b) \
        == fp.num_subfingerprints
    assert compat.LBAudioDetectiveFingerprintEqualToFingerprint(b, fp)
    cp = compat.LBAudioDetectiveFingerprintCopy(b)
    assert compat.LBAudioDetectiveFingerprintEqualToFingerprint(cp, b)
    assert compat.stringFromFingerprint(b) == compat.stringFromFingerprint(fp)
    # The slide compare accepts builders on either side.
    score = compat.LBAudioDetectiveFingerprintCompareToFingerprint(b, fp, 200)
    assert score == pytest.approx(1.0)


def test_builder_length_lock_and_q1_truncation():
    b = compat.LBAudioDetectiveFingerprintNew(0)
    ok, eff = compat.LBAudioDetectiveFingerprintSetSubfingerprintLength(b, 200)
    assert ok and eff == 200
    # Quirk Q1: a 400-boolean extraction buffer stores only the first 200.
    buf = np.zeros(400, np.uint8)
    buf[0] = buf[399] = 1
    compat.LBAudioDetectiveFingerprintAddSubfingerprint(b, buf)
    stored = b.subfingerprint_booleans(0)
    assert stored.shape == (200,)
    assert stored[0] == 1 and stored.sum() == 1
    # Length locks once non-empty; the refused call reports the locked value.
    ok, eff = compat.LBAudioDetectiveFingerprintSetSubfingerprintLength(b, 100)
    assert not ok and eff == 200
    compat.LBAudioDetectiveFingerprintDispose(b)
    assert compat.LBAudioDetectiveFingerprintGetNumberOfSubfingerprints(b) == 0
    compat.LBAudioDetectiveFingerprintDispose(None)   # NULL-tolerant


def test_compare_subfingerprints_q10(detective):
    """Raw-buffer Q10 semantics (Fingerprint.m:151-176): possible hits
    counted from buffer 1's non-zero pairs; asymmetric in its inputs."""
    fp = compat.LBAudioDetectiveFingerprintNew(200)
    s1 = np.zeros(200, np.uint8)
    s2 = np.zeros(200, np.uint8)
    s1[0] = 1            # pair 0: (1,0) in s1, (0,0) in s2 -> possible, miss
    s1[2] = 1; s2[2] = 1 # pair 1: equal non-zero -> hit
    s2[4] = 1            # pair 2: s1 zero -> not possible (asymmetry)
    score = compat.LBAudioDetectiveFingerprintCompareSubfingerprints(
        fp, s1, s2, 200)
    assert score == pytest.approx(0.5)
    swapped = compat.LBAudioDetectiveFingerprintCompareSubfingerprints(
        fp, s2, s1, 200)
    assert swapped == pytest.approx(0.5)   # s2 has pairs 1,2 possible; 1 hit
    # Zero range -> no possible hits -> 0.0 (Fingerprint.m:171-175).
    assert compat.LBAudioDetectiveFingerprintCompareSubfingerprints(
        fp, s1, s2, 0) == 0.0
    # Agreement with the vectorised matcher on real data: a self-compare of
    # one subfingerprint through the raw-buffer path scores 1.0.
    real = detective.process_audio_file(corpus_path("Kestrel"))
    b0 = real.subfingerprint_booleans(0)
    assert compat.LBAudioDetectiveFingerprintCompareSubfingerprints(
        real, b0, b0, 200) == pytest.approx(1.0)
