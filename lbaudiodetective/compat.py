"""C-API parity layer: 1:1 names for the reference's public surface.

Maps every public function of `LBAudioDetective.h` (constructor, preference
getters/setters, processing, comparison) and of
`LBAudioDetectiveFingerprint.h` (container ops) onto the pythonic framework
objects.  Out-parameters become return values; OSStatus codes become the
typed exceptions of :mod:`lbaudiodetective.errors`
(``InvalidArgumentError`` for kLBAudioDetectiveArgumentInvalid semantics,
LBAudioDetective.m:20,211-214; decode failures raise ``DecodeError`` /
``UnsupportedFormatError``).

    detective = LBAudioDetectiveNew()
    match = LBAudioDetectiveCompareAudioURLs(detective, url1, url2, 0)
    LBAudioDetectiveDispose(detective)
"""

from __future__ import annotations

import numpy as np

from lbaudiodetective.config import (
    DEFAULT_ANALYSIS_STRIDE,
    DEFAULT_PITCH_STEP_COUNT,
    DEFAULT_PROCESSING_SAMPLE_RATE,
    DEFAULT_ROWS_PER_FRAME,
    DEFAULT_SUBFINGERPRINT_LENGTH,
    DEFAULT_WINDOW_SIZE,
)
from lbaudiodetective.errors import InvalidArgumentError
from lbaudiodetective.models.detective import AudioDetective
from lbaudiodetective.models.fingerprint import (
    Fingerprint, FingerprintBuilder, compare_subfingerprint_booleans)
from lbaudiodetective.ops.match import match_fingerprints

# Constants (LBAudioDetective.m:20-26)
kLBAudioDetectiveArgumentInvalid = 1  # OSStatus analogue; raised as errors.InvalidArgumentError
kLBAudioDetectiveDefaultWindowSize = DEFAULT_WINDOW_SIZE
kLBAudioDetectiveDefaultAnalysisStride = DEFAULT_ANALYSIS_STRIDE
kLBAudioDetectiveDefaultNumberOfPitchSteps = DEFAULT_PITCH_STEP_COUNT
kLBAudioDetectiveDefaultNumberOfRowsPerFrame = DEFAULT_ROWS_PER_FRAME
kLBAudioDetectiveDefaultSubfingerprintLength = DEFAULT_SUBFINGERPRINT_LENGTH


# -- detective lifecycle (LBAudioDetective.h:41-56) -------------------------

def LBAudioDetectiveNew() -> AudioDetective:
    return AudioDetective()


def LBAudioDetectiveDispose(detective: AudioDetective) -> None:
    if detective is None:
        raise InvalidArgumentError("invalid argument: detective is None")
    detective.dispose()


def LBAudioDetectiveDefaultProcessingSampleRate() -> float:
    return DEFAULT_PROCESSING_SAMPLE_RATE


def LBAudioDetectiveDefaultProcessingFormat() -> dict:
    """AudioStreamBasicDescription analogue (LBAudioDetective.m:116-131):
    packed mono float32 at the processing rate."""
    return {"sample_rate": DEFAULT_PROCESSING_SAMPLE_RATE,
            "format": "lpcm", "float": True, "signed_integer": False,
            "bits_per_channel": 32, "channels_per_frame": 1,
            "frames_per_packet": 1, "bytes_per_frame": 4,
            "bytes_per_packet": 4, "packed": True}


def LBAudioDetectiveDefaultRecordingFormat() -> dict:
    """Recording-format default (declared LBAudioDetective.h:122; defined in
    the essay's streaming build: packed mono signed-int16 PCM at the capture
    hardware rate — our streaming ingest's int16 path)."""
    return {"sample_rate": 44100.0,
            "format": "lpcm", "float": False, "signed_integer": True,
            "bits_per_channel": 16, "channels_per_frame": 1,
            "frames_per_packet": 1, "bytes_per_frame": 2,
            "bytes_per_packet": 2, "packed": True}


# -- getters (LBAudioDetective.h:63-122) ------------------------------------

def LBAudioDetectiveGetProcessingSampleRate(d: AudioDetective) -> float:
    return d.processing_sample_rate


def LBAudioDetectiveGetNumberOfPitchSteps(d: AudioDetective) -> int:
    return d.number_of_pitch_steps


def LBAudioDetectiveGetSubfingerprintLength(d: AudioDetective) -> int:
    return d.subfingerprint_length


def LBAudioDetectiveGetWindowSize(d: AudioDetective) -> int:
    return d.window_size


def LBAudioDetectiveGetAnalysisStride(d: AudioDetective) -> int:
    return d.analysis_stride


def LBAudioDetectiveGetRecordingSampleRate(d: AudioDetective) -> float:
    """Declared LBAudioDetective.h:67 (defined in the essay's streaming
    build: the capture format's sample rate)."""
    return d.recording_sample_rate


def LBAudioDetectiveGetFingerprint(d: AudioDetective):
    """The detective's most recent fingerprint (LBAudioDetective.h:63; after
    CompareAudioURLs it belongs to the second file, h:224).  None before any
    processing."""
    return d.last_fingerprint


# -- setters (LBAudioDetective.h:144-201) -----------------------------------

def LBAudioDetectiveSetProcessingSampleRate(d: AudioDetective, rate: float) -> None:
    d.processing_sample_rate = rate


def LBAudioDetectiveSetNumberOfPitchSteps(d: AudioDetective, steps: int) -> None:
    d.number_of_pitch_steps = steps


def LBAudioDetectiveSetSubfingerprintLength(d: AudioDetective, length: int) -> None:
    d.subfingerprint_length = length


def LBAudioDetectiveSetWindowSize(d: AudioDetective, size: int) -> None:
    # Spec-corrected Q4: raises on non-power-of-two instead of the
    # reference's inverted check that errors on every valid size.
    d.window_size = size


def LBAudioDetectiveSetAnalysisStride(d: AudioDetective, stride: int) -> None:
    d.analysis_stride = stride


def LBAudioDetectiveSetRecordingSampleRate(d: AudioDetective, rate: float) -> None:
    """Declared LBAudioDetective.h:143; recording must stay signed-int PCM
    (h:135) — only the rate is tunable here."""
    d.recording_sample_rate = float(rate)


# -- processing (LBAudioDetective.h:210-235) --------------------------------

def LBAudioDetectiveProcessAudioURL(d: AudioDetective, url: str) -> Fingerprint:
    if url is None:
        raise InvalidArgumentError("invalid argument: url is None")
    return d.process_audio_file(url)


def LBAudioDetectiveCompareAudioURLs(d: AudioDetective, url1: str, url2: str,
                                     comparison_range: int = 0) -> float:
    return d.compare_audio_files(url1, url2, comparison_range)


# -- fingerprint container (LBAudioDetectiveFingerprint.h) ------------------
# Builder path (LBAudioDetectiveFingerprint.h:27,35,98,108): the reference
# test harness constructs fingerprints incrementally through New /
# SetSubfingerprintLength / AddSubfingerprint; here that surface returns a
# mutable FingerprintBuilder exposing the same read API as the immutable
# Fingerprint, so every container function below accepts either.

def LBAudioDetectiveFingerprintNew(subfingerprint_length: int = 0) -> FingerprintBuilder:
    """LBAudioDetectiveFingerprint.m:18-26 (the reference zero-initialises and
    stores the passed length verbatim, including 0 — ProcessAudioURL passes 0
    and sets the real length before the first append)."""
    return FingerprintBuilder(subfingerprint_length)


def LBAudioDetectiveFingerprintDispose(fp) -> None:
    """NULL-tolerant like the reference (Fingerprint.m:28-31)."""
    if fp is None:
        return
    if isinstance(fp, FingerprintBuilder):
        fp.clear()


def LBAudioDetectiveFingerprintSetSubfingerprintLength(
        fp: FingerprintBuilder, subfingerprint_length: int) -> tuple[bool, int]:
    """Returns ``(accepted, effective_length)``: refused (False, locked
    length) once any subfingerprint was added — the C version rewrites the
    in/out pointer to the locked value (Fingerprint.m:81-89)."""
    if not isinstance(fp, FingerprintBuilder):
        raise InvalidArgumentError(
            "SetSubfingerprintLength requires a builder fingerprint "
            "(LBAudioDetectiveFingerprintNew); extracted Fingerprints are "
            "immutable value types")
    return fp.set_subfingerprint_length(subfingerprint_length)


def LBAudioDetectiveFingerprintAddSubfingerprint(
        fp: FingerprintBuilder, subfingerprint: np.ndarray) -> None:
    """Appends a copy of the first ``subfingerprint_length`` booleans
    (Fingerprint.m:91-100; quirk Q1 truncation of the 2x extraction buffer)."""
    if not isinstance(fp, FingerprintBuilder):
        raise InvalidArgumentError(
            "AddSubfingerprint requires a builder fingerprint "
            "(LBAudioDetectiveFingerprintNew)")
    fp.add_subfingerprint(subfingerprint)


def LBAudioDetectiveFingerprintCompareSubfingerprints(
        fp, subfingerprint1: np.ndarray, subfingerprint2: np.ndarray,
        comparison_range: int) -> float:
    """Quirk-Q10 similarity of two raw interleaved boolean buffers; ``fp``
    contributes only its subfingerprint length cap
    (LBAudioDetectiveFingerprint.m:151-176, h:147)."""
    return compare_subfingerprint_booleans(
        subfingerprint1, subfingerprint2, comparison_range,
        fp.subfingerprint_length)


def LBAudioDetectiveFingerprintCopy(fp: Fingerprint) -> Fingerprint:
    return fp.copy()


def LBAudioDetectiveFingerprintGetSubfingerprintLength(fp: Fingerprint) -> int:
    return fp.subfingerprint_length


def LBAudioDetectiveFingerprintGetNumberOfSubfingerprints(fp: Fingerprint) -> int:
    return fp.num_subfingerprints


def LBAudioDetectiveFingerprintGetSubfingerprintAtIndex(fp: Fingerprint, index: int) -> np.ndarray:
    return fp.subfingerprint_booleans(index)


def LBAudioDetectiveFingerprintEqualToFingerprint(fp1: Fingerprint, fp2: Fingerprint) -> bool:
    return fp1 == fp2


def stringFromFingerprint(fp: Fingerprint) -> str:
    """Golden string serializer of the reference test harness
    (LBAudioDetectiveTests.m:22-37): '0'/'1' digits per stored boolean,
    subfingerprints joined by '+'."""
    return fp.to_string()


def LBAudioDetectiveFingerprintCompareToFingerprint(fp1: Fingerprint, fp2: Fingerprint,
                                                    comparison_range: int = 0) -> float:
    """1:1 port of LBAudioDetectiveFingerprintCompareToFingerprint
    (LBAudioDetectiveFingerprint.m:119-149).

    Note: the reference applies the range-0 -> subfingerprint-length default
    only in CompareAudioURLs (LBAudioDetective.m:443-445); the raw compare
    with inRange=0 iterates zero booleans, so possibleHits stays 0 and every
    subfingerprint similarity — hence the match — is 0.0
    (Fingerprint.m:155,171-175).  Replicated here for parity.
    """
    if comparison_range == 0:
        return 0.0
    return match_fingerprints((fp1.pos, fp1.neg), (fp2.pos, fp2.neg),
                              comparison_range, fp1.subfingerprint_length)


# -- frame (LBAudioDetectiveFrame.h, private in the reference) ---------------

def LBAudioDetectiveFrameNew(max_row_count: int):
    from lbaudiodetective.models.frame import Frame

    return Frame(max_row_count)


def LBAudioDetectiveFrameCopy(frame):
    return frame.copy()


def LBAudioDetectiveFrameGetNumberOfRows(frame) -> int:
    return frame.number_of_rows


def LBAudioDetectiveFrameGetValue(frame, row: int, col: int) -> float:
    return frame.get_value(row, col)


def LBAudioDetectiveFrameFull(frame) -> bool:
    return frame.full()


def LBAudioDetectiveFrameSetRow(frame, row, index: int, count: int) -> bool:
    return frame.set_row(np.asarray(row, np.float32)[:count], index)


def LBAudioDetectiveFrameDecompose(frame) -> None:
    frame.decompose()


def LBAudioDetectiveFrameExtractFingerprint(frame, number_of_wavelets: int):
    return frame.extract_fingerprint(number_of_wavelets)


def LBAudioDetectiveFrameEqualToFrame(frame1, frame2) -> bool:
    return frame1 == frame2


def LBAudioDetectiveFrameDispose(frame) -> None:
    """NULL-tolerant like the reference (Frame.m:33-43)."""
    if frame is not None:
        frame.clear()


def LBAudioDetectiveFrameGetRow(frame, row: int) -> np.ndarray:
    return frame.get_row(row)


def LBAudioDetectiveFrameFingerprintLength(frame) -> int:
    """numberOfRows * rowLength * 2 booleans (Frame.m:159-161)."""
    return frame.fingerprint_length


def LBAudioDetectiveFrameFingerprintSize(frame) -> int:
    """Byte size of the extraction buffer (Frame.m:155-157)."""
    return frame.fingerprint_size


# -- streaming (essay Appendix E API surface) --------------------------------
# The reference's streaming functions live only in the project's essay
# (LBAudioDetectiveStartProcessing/StopProcessing/PauseProcessing/
# ResumeProcessing, LBAudioDetectiveProcess).  They map onto
# streaming.StreamingDetective; the detective argument here is that class.

def LBAudioDetectiveProcess(detective, max_number_of_subfingerprints: int,
                            callback) -> None:
    """Essay: start streaming recognition; callback fires when
    ``max_number_of_subfingerprints`` frames have been fingerprinted."""
    detective.start_processing(max_number_of_subfingerprints, callback)


def LBAudioDetectiveStartProcessing(detective, max_number_of_subfingerprints: int,
                                    callback=None) -> None:
    detective.start_processing(max_number_of_subfingerprints, callback)


def LBAudioDetectiveStopProcessing(detective):
    return detective.stop_processing()


def LBAudioDetectivePauseProcessing(detective) -> None:
    detective.pause_processing()


def LBAudioDetectiveResumeProcessing(detective) -> None:
    detective.resume_processing()
