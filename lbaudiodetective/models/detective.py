"""AudioDetective: the end-to-end pipeline object.

The pythonic analogue of the reference's public C API
(LBAudioDetective.h:41-235): construction with defaults, preference
getters/setters, ``process_audio_file`` (decode -> extract) and
``compare_audio_files``.  Configuration lives in an immutable
FingerprintConfig; setters replace it (JAX idiom — the config is the jit
cache key), preserving the reference's semantics that preferences take effect
on the next process call (LBAudioDetective.h setter docs).

Use as a context manager for API symmetry with New/Dispose; there is no
device state to free, so dispose is a no-op.
"""

from __future__ import annotations

import numpy as np

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.io.decode import DecodedAudio, decode_audio_file
from lbaudiodetective.models.fingerprint import Fingerprint
from lbaudiodetective.ops.extract import extract_fingerprint, extract_fingerprint_batch
from lbaudiodetective.ops.match import match_fingerprints, match_one_vs_many_padded


class AudioDetective:
    """Decode -> extract -> match pipeline with reference-compatible knobs."""

    def __init__(self, config: FingerprintConfig | None = None):
        self.config = config or FingerprintConfig()
        #: Recording-format preference (LBAudioDetective.h:127-143: the
        #: capture format for the streaming path; must be signed-int PCM).
        #: Only the sample rate is tunable — our streaming ingest is int16.
        self.recording_sample_rate = 44100.0
        #: The detective retains its most recent fingerprint
        #: (LBAudioDetectiveGetFingerprint, h:63; after CompareAudioURLs it
        #: belongs to the second file, h:224).
        self.last_fingerprint: Fingerprint | None = None

    # -- context manager (New/Dispose analogue) -----------------------------

    def __enter__(self) -> "AudioDetective":
        return self

    def __exit__(self, *exc) -> None:
        self.dispose()

    def dispose(self) -> None:
        """No-op; kept for API parity with LBAudioDetectiveDispose."""

    # -- preferences (LBAudioDetective.h:63-201) ----------------------------

    @property
    def processing_sample_rate(self) -> float:
        return self.config.processing_sample_rate

    @processing_sample_rate.setter
    def processing_sample_rate(self, value: float) -> None:
        self.config = self.config.with_updates(processing_sample_rate=float(value))

    @property
    def number_of_pitch_steps(self) -> int:
        return self.config.pitch_step_count

    @number_of_pitch_steps.setter
    def number_of_pitch_steps(self, value: int) -> None:
        self.config = self.config.with_updates(pitch_step_count=int(value))

    @property
    def subfingerprint_length(self) -> int:
        return self.config.subfingerprint_length

    @subfingerprint_length.setter
    def subfingerprint_length(self, value: int) -> None:
        self.config = self.config.with_updates(subfingerprint_length=int(value))

    @property
    def window_size(self) -> int:
        return self.config.window_size

    @window_size.setter
    def window_size(self, value: int) -> None:
        self.config = self.config.with_updates(window_size=int(value))

    @property
    def analysis_stride(self) -> int:
        return self.config.analysis_stride

    @analysis_stride.setter
    def analysis_stride(self, value: int) -> None:
        self.config = self.config.with_updates(analysis_stride=int(value))

    # -- processing (LBAudioDetectiveProcessAudioURL / CompareAudioURLs) ----

    def process_audio_file(self, path: str) -> Fingerprint:
        if path is None:
            from lbaudiodetective.errors import InvalidArgumentError

            raise InvalidArgumentError(
                "path must not be None (kLBAudioDetectiveArgumentInvalid)")
        audio = decode_audio_file(path, self.config.processing_sample_rate)
        return self.process_decoded(audio)

    def process_decoded(self, audio: DecodedAudio) -> Fingerprint:
        pos, neg, n_sub = extract_fingerprint(audio, self.config)
        fp = Fingerprint.from_planes(pos[:n_sub], neg[:n_sub],
                                     self.config.subfingerprint_length)
        self.last_fingerprint = fp
        return fp

    def process_batch(self, paths: list[str]) -> list[Fingerprint]:
        """All clips in one padded device dispatch (BASELINE config 2)."""
        clips = [decode_audio_file(p, self.config.processing_sample_rate) for p in paths]
        pos, neg, n_subs = extract_fingerprint_batch(clips, self.config)
        return [Fingerprint.from_planes(pos[i, :n], neg[i, :n],
                                        self.config.subfingerprint_length)
                for i, n in enumerate(n_subs)]

    def compare_audio_files(self, path1: str, path2: str,
                            comparison_range: int = 0) -> float:
        fp1 = self.process_audio_file(path1)
        fp2 = self.process_audio_file(path2)
        return self.compare_fingerprints(fp1, fp2, comparison_range)

    def compare_fingerprints(self, fp1: Fingerprint, fp2: Fingerprint,
                             comparison_range: int = 0) -> float:
        return match_fingerprints((fp1.pos, fp1.neg), (fp2.pos, fp2.neg),
                                  comparison_range, self.config.subfingerprint_length)

    def match_against_library(self, query: Fingerprint,
                              library: list[Fingerprint],
                              comparison_range: int = 0) -> np.ndarray:
        """One-vs-many: returns ``[len(library)]`` match scores (BASELINE
        config 3)."""
        import jax.numpy as jnp

        from lbaudiodetective.ops.extract import bucket_subfingerprints

        if not library:
            return np.zeros(0, dtype=np.float32)
        s_max = bucket_subfingerprints(max(max(f.num_subfingerprints for f in library),
                                           query.num_subfingerprints, 1))
        pairs = query.pairs

        def pad(f: Fingerprint):
            p = np.zeros((s_max, pairs), np.uint8)
            n = np.zeros((s_max, pairs), np.uint8)
            p[:f.num_subfingerprints] = f.pos
            n[:f.num_subfingerprints] = f.neg
            return p, n

        qp, qn = pad(query)
        lib = [pad(f) for f in library]
        lib_pos = np.stack([p for p, _ in lib])
        lib_neg = np.stack([n for _, n in lib])
        n_lib = np.array([f.num_subfingerprints for f in library], np.int32)
        scores = match_one_vs_many_padded(
            jnp.asarray(qp), jnp.asarray(qn), jnp.int32(query.num_subfingerprints),
            jnp.asarray(lib_pos), jnp.asarray(lib_neg), jnp.asarray(n_lib),
            comparison_range, self.config.subfingerprint_length)
        return np.asarray(scores)
