"""Unified decode entry point: file -> (processing-rate mono float32, metadata).

Prefers the native C++ decoder (``lbaudiodetective/io/native``) when its
shared library has been built; otherwise falls back to the pure-NumPy
implementations in :mod:`lbaudiodetective.io.caf`.  Decode (CAF parse +
IMA4/LPCM unpack) is bit-exact across the two paths; the resample stage
agrees to within 1-2 ulp (the C++ FIR accumulates in double, the NumPy
einsum in float32 — validated at atol=2e-6 in tests/test_native_decoder.py).
Fingerprint *bits* can therefore differ across environments in rare
borderline coefficients; store libraries and queries with the same backend
when bit identity matters (match scores are insensitive at corpus scale).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from lbaudiodetective.io import caf as _caf
from lbaudiodetective.io.resample import resample_rational


@dataclasses.dataclass
class DecodedAudio:
    """Decoded + resampled clip.

    ``file_frames`` is the frame count at the file's native rate -- the
    quantity the reference reads as kExtAudioFileProperty_FileLengthFrames
    (LBAudioDetective.m:236) and from which the spectrogram row count derives
    (quirk Q8).
    """

    samples: np.ndarray       # float32 at processing rate
    processing_rate: float
    file_frames: int
    file_rate: float

    @property
    def proc_frames(self) -> int:
        return int(self.samples.shape[0])


def _read_file(path: str) -> tuple[np.ndarray, float]:
    try:
        from lbaudiodetective.io.native import binding as native
    except Exception:
        native = None
    if native is not None and native.available():
        try:
            # Container-dispatching C++ decode (CAF/WAV/AIFF/AU by magic);
            # semantics-validated vs the NumPy readers per container/codec
            # (tests/test_native_decoder.py).
            return native.read_audio(path)
        except Exception:
            # A codec the built .so predates (ADPCM WAV, new formats) or a
            # native-only failure: the NumPy readers below are the
            # behavioural source of truth — let them either decode the
            # file or raise the typed error.
            pass
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"RIFF":
        from lbaudiodetective.io.wav import read_wav

        return read_wav(path)
    if magic == b"FORM":
        from lbaudiodetective.io.aiff import read_aiff

        return read_aiff(path)
    if magic == b".snd":
        from lbaudiodetective.io.au import read_au

        return read_au(path)
    if magic == b"caff":
        return _caf.read_caf(path)
    # Unknown magic: a perceptual codec (MP3/AAC/ALAC — formats the
    # reference accepted through AudioToolbox, LBAudioDetective.m:224) or
    # garbage.  The guarded external shim decodes via a system ffmpeg when
    # one is installed and raises a typed UnsupportedFormatError otherwise.
    from lbaudiodetective.io.external import decode_via_external

    return decode_via_external(path)


def decode_audio_file(path: str, processing_rate: float = 5512.0) -> DecodedAudio:
    """Decode an audio file and resample to the processing rate."""
    from lbaudiodetective.errors import DecodeError

    samples, file_rate = _read_file(path)
    if not (1000.0 <= file_rate <= 1e6):
        # A header this far outside real audio rates is corruption, and an
        # extreme upsample ratio would let one malformed request allocate
        # unbounded output (serving hardening).
        raise DecodeError(f"file sample rate {file_rate!r} out of range")
    file_frames = int(samples.shape[0])
    resampled = resample_rational(samples, file_rate, processing_rate)
    return DecodedAudio(
        samples=np.ascontiguousarray(resampled, dtype=np.float32),
        processing_rate=processing_rate,
        file_frames=file_frames,
        file_rate=file_rate,
    )


def decode_audio_file_raw(path: str) -> tuple[np.ndarray, float]:
    """Decode WITHOUT resampling: (native-rate mono float32, file rate).

    The MAA (essay §3.2.1.1) operates at the file's native rate — the
    essay introduces downsampling only with the AFA; this is the entry
    point for consumers that want the un-resampled signal.
    """
    from lbaudiodetective.errors import DecodeError

    samples, file_rate = _read_file(path)
    if not (1000.0 <= file_rate <= 1e6):
        # Same corruption guard as decode_audio_file: a rate this far
        # outside real audio is a malformed header, not a format.
        raise DecodeError(f"file sample rate {file_rate!r} out of range")
    return samples, file_rate
