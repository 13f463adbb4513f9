"""Automated C-API surface coverage: every public function declared in the
reference's three headers must exist 1:1 in lbaudiodetective.compat
(plus the essay-only streaming functions).  This is the machine-checked
version of the SURVEY §2.3 'Python API parity layer' deliverable."""

import pathlib
import re

import numpy as np
import pytest

from lbaudiodetective import compat
from tests.conftest import corpus_path

HEADERS = [
    "/root/reference/LBAudioDetective/LBAudioDetective.h",
    "/root/reference/LBAudioDetective/LBAudioDetectiveFingerprint.h",
    "/root/reference/LBAudioDetective/LBAudioDetectiveFrame.h",
]

# Declared in function-signature position (not just doc @see references).
_SIG = re.compile(
    r"^\s*[A-Za-z_][A-Za-z0-9_* ]*?\b(LBAudioDetective[A-Za-z0-9]*)\s*\(",
    re.MULTILINE)


def declared_functions() -> set[str]:
    names = set()
    for h in HEADERS:
        names |= set(_SIG.findall(pathlib.Path(h).read_text()))
    return names


def test_every_declared_function_has_a_compat_name():
    declared = declared_functions()
    assert len(declared) >= 30          # sanity: the parse found the surface
    missing = sorted(n for n in declared if not hasattr(compat, n))
    assert not missing, f"compat layer missing: {missing}"


def test_essay_streaming_names_present():
    for n in ("LBAudioDetectiveProcess", "LBAudioDetectiveStartProcessing",
              "LBAudioDetectiveStopProcessing", "LBAudioDetectivePauseProcessing",
              "LBAudioDetectiveResumeProcessing"):
        assert hasattr(compat, n)


def test_recording_and_format_functions():
    d = compat.LBAudioDetectiveNew()
    assert compat.LBAudioDetectiveGetRecordingSampleRate(d) == 44100.0
    compat.LBAudioDetectiveSetRecordingSampleRate(d, 48000.0)
    assert compat.LBAudioDetectiveGetRecordingSampleRate(d) == 48000.0
    pf = compat.LBAudioDetectiveDefaultProcessingFormat()
    assert pf["sample_rate"] == 5512.0 and pf["float"] and pf["channels_per_frame"] == 1
    rf = compat.LBAudioDetectiveDefaultRecordingFormat()
    assert rf["signed_integer"] and rf["bits_per_channel"] == 16


def test_get_fingerprint_retention():
    """h:63/h:224: the detective retains the last fingerprint; after
    CompareAudioURLs it belongs to the SECOND file."""
    d = compat.LBAudioDetectiveNew()
    assert compat.LBAudioDetectiveGetFingerprint(d) is None
    fp = compat.LBAudioDetectiveProcessAudioURL(d, corpus_path("Crow"))
    assert compat.LBAudioDetectiveGetFingerprint(d) == fp
    compat.LBAudioDetectiveCompareAudioURLs(d, corpus_path("Crow"),
                                            corpus_path("Crow_eql"))
    fp2 = compat.LBAudioDetectiveProcessAudioURL(d, corpus_path("Crow_eql"))
    assert compat.LBAudioDetectiveGetFingerprint(d) == fp2


def test_frame_row_and_size_functions():
    f = compat.LBAudioDetectiveFrameNew(4)
    for i in range(3):
        compat.LBAudioDetectiveFrameSetRow(f, np.arange(5, dtype=np.float32) + i,
                                           i, 5)
    np.testing.assert_array_equal(compat.LBAudioDetectiveFrameGetRow(f, 1),
                                  np.arange(5, dtype=np.float32) + 1)
    assert compat.LBAudioDetectiveFrameFingerprintLength(f) == 3 * 5 * 2
    assert compat.LBAudioDetectiveFrameFingerprintSize(f) == 3 * 5 * 2
    compat.LBAudioDetectiveFrameDispose(f)
    assert compat.LBAudioDetectiveFrameGetNumberOfRows(f) == 0
    compat.LBAudioDetectiveFrameDispose(None)
