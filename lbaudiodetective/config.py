"""Pipeline configuration.

The reference holds its preferences mutably on an opaque detective struct
(`LBAudioDetective.m:28-44`, defaults at `LBAudioDetective.m:22-26`).  Here the
configuration is a frozen, hashable dataclass so it can key jit caches; the
compat layer (`lbaudiodetective.compat`) reproduces the setter names by
returning updated copies.

Derived spectral-band constants replicate the reference's integer-truncating
band-edge arithmetic exactly (`LBAudioDetective.m:361-383`, quirk Q6 of
SURVEY.md): band edges are first computed in FFT-bin-like units with two
separate float->int truncations, then re-converted to bin indices as if they
were Hz.  We precompute the final 33 integer indices once.
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property

import numpy as np

#: Defaults mirroring LBAudioDetective.m:22-26.
DEFAULT_WINDOW_SIZE = 2048
DEFAULT_ANALYSIS_STRIDE = 64
DEFAULT_PITCH_STEP_COUNT = 32
DEFAULT_ROWS_PER_FRAME = 128
DEFAULT_SUBFINGERPRINT_LENGTH = 200
DEFAULT_PROCESSING_SAMPLE_RATE = 5512.0
#: Lower edge of the analysed spectrum in Hz (LBAudioDetective.m:363).
MIN_ANALYSIS_FREQUENCY = 318.0


@dataclasses.dataclass(frozen=True)
class FingerprintConfig:
    """Frozen fingerprinting configuration (hashable -> usable as jit cache key).

    ``hop_domain`` selects the stride-unit interpretation of quirk Q8
    (SURVEY.md §2.2): the reference seeks ``ExtAudioFileSeek(offset += 64)``
    while lengths come from the 44.1 kHz file domain and windows are read in
    the 5512 Hz client domain.

    - ``"file"``: the 64-frame hop is in *file* frames (44.1 kHz) -> the
      effective hop is ~8 processing samples and the row count derives from
      the file-rate length.  (Calibrated: this reproduces the essay's
      Figure 24 identification scores; see tests/test_corpus_identification.py.)
    - ``"proc"``: the hop is 64 *processing* samples (5512 Hz), row count
      derived from the processing-rate length.  A "spec-corrected" variant:
      cheaper (8x fewer rows) and what a clean implementation would do.
    """

    processing_sample_rate: float = DEFAULT_PROCESSING_SAMPLE_RATE
    window_size: int = DEFAULT_WINDOW_SIZE
    analysis_stride: int = DEFAULT_ANALYSIS_STRIDE
    pitch_step_count: int = DEFAULT_PITCH_STEP_COUNT
    rows_per_frame: int = DEFAULT_ROWS_PER_FRAME
    subfingerprint_length: int = DEFAULT_SUBFINGERPRINT_LENGTH
    min_frequency: float = MIN_ANALYSIS_FREQUENCY
    hop_domain: str = "file"
    #: Sample rate of the decoded source files; the hop/row-count arithmetic
    #: of quirk Q8 depends on it in "file" mode.
    file_sample_rate: float = 44100.0
    #: Spec choice: quantise the window hop to the nearest integer
    #: number of processing samples (8 for the default rates instead of the
    #: reference's fractional 64*5512/44100 = 7.99927).  The cumulative start
    #: drift this removes is < 7 samples (1.2 ms) over a 13 s clip —
    #: statistically invisible in match scores (revalidated against the
    #: essay's Figure 24-28 results) — and it makes the window grid a uniform
    #: stride, so the spectral stage maps onto strided convolutions
    #: (ops.spectral.conv_band_rows).  Set False for the drift-faithful
    #: oracle mode.
    integer_hop: bool = True
    #: Float32 contraction precision of the spectral, band and Haar
    #: matmuls/convolutions (see :attr:`precision`).  On a GPU, "default"
    #: and "medium" let cuBLAS/cuDNN run f32 products in TF32 (10-bit
    #: mantissa); "high" and "highest" keep full f32 products.  Every fingerprint
    #: bit is decided by a |coefficient| ranking, so only the full-f32 tiers
    #: hold oracle bit agreement >= 0.999 (measured per tier on an H100 by
    #: ``chip_smoke.py``; PERF.md); "high" is the validated default.  On the
    #: CPU every tier computes full f32 products.
    matmul_precision: str = "high"

    def __post_init__(self):
        if self.window_size & (self.window_size - 1):
            # Spec-corrected Q4: the reference's power-of-two validation is
            # inverted (LBAudioDetective.m:183-187) and errors on every valid
            # size; we validate properly.
            raise ValueError(f"window_size must be a power of two, got {self.window_size}")
        if self.subfingerprint_length % 2:
            raise ValueError("subfingerprint_length must be even (bits are sign pairs)")
        if self.hop_domain not in ("file", "proc"):
            raise ValueError(f"hop_domain must be 'file' or 'proc', got {self.hop_domain!r}")
        if self.matmul_precision not in ("default", "medium", "high", "highest"):
            raise ValueError(f"invalid matmul_precision {self.matmul_precision!r}")

    # ------------------------------------------------------------------ #
    # Derived quantities
    # ------------------------------------------------------------------ #

    @property
    def num_wavelet_pairs(self) -> int:
        """Effective number of stored sign pairs per subfingerprint.

        Quirk Q1: the reference extracts sign bits for the top
        ``subfingerprint_length`` wavelets into a 2x buffer but stores only the
        first ``subfingerprint_length`` booleans = sign pairs of the top
        ``subfingerprint_length/2`` ranked coefficients
        (LBAudioDetective.m:321-328, LBAudioDetectiveFingerprint.m:92-94).
        """
        return self.subfingerprint_length // 2

    @property
    def coeffs_per_frame(self) -> int:
        return self.rows_per_frame * self.pitch_step_count

    @property
    def hop_in_processing_samples(self) -> float:
        """Effective window hop measured in processing-rate samples."""
        if self.hop_domain == "file":
            hop = self.analysis_stride * self.processing_sample_rate / self.file_sample_rate
            return float(round(hop)) if self.integer_hop else hop
        return float(self.analysis_stride)

    @property
    def has_integer_hop(self) -> bool:
        return float(self.hop_in_processing_samples).is_integer()

    @property
    def precision(self):
        """jax.lax.Precision for the spectral/Haar contractions.

        "high" maps to HIGHEST: on a GPU, Precision.HIGH still permits TF32
        products, which flip fingerprint bits (see :attr:`matmul_precision`).
        """
        import jax

        return {"default": jax.lax.Precision.DEFAULT,
                "medium": jax.lax.Precision.HIGH,
                "high": jax.lax.Precision.HIGHEST,
                "highest": jax.lax.Precision.HIGHEST}[self.matmul_precision]

    @property
    def identification_validated(self) -> bool:
        """True when this precision tier reproduces the CPU-golden
        fingerprints on an accelerator: only the full-f32 tiers do;
        "default" and "medium" run reduced-precision products there and
        shift scores by enough to flip identified counts on the knife-edge
        suites."""
        return self.matmul_precision in ("high", "highest")

    def warn_if_unvalidated_for_identification(self, backend: str | None = None
                                               ) -> None:
        """Loud once-per-config warning when an identification entry point
        runs at a precision whose fingerprints diverge from the goldens.
        CPU backends are exempt: there every tier computes full f32
        products (see :attr:`matmul_precision`)."""
        if self.identification_validated:
            return
        import warnings

        import jax

        if (backend or jax.default_backend()) == "cpu":
            return
        warnings.warn(
            f"matmul_precision={self.matmul_precision!r} is NOT validated for "
            "corpus identification on an accelerator (reduced-precision "
            "products flip fingerprint bits vs the CPU goldens); use "
            "matmul_precision='high' when identification results must "
            "reproduce the calibration", stacklevel=3)

    def num_rows(self, file_frames: int, proc_frames: int) -> int:
        """Spectrogram row count (``imageWidth``, LBAudioDetective.m:250).

        The reference computes ``(fileLengthFrames - windowSize) / stride``
        using the *file-rate* length regardless of hop domain (quirk Q8); in
        "proc" mode we use the processing-rate length (the spec-corrected
        variant), since the file-rate count would run 8x past EOF.
        """
        if self.hop_domain == "file":
            n = (file_frames - self.window_size) // self.analysis_stride
        else:
            n = (proc_frames - self.window_size) // self.analysis_stride
        return max(int(n), 0)

    def num_subfingerprints(self, file_frames: int, proc_frames: int) -> int:
        """Quirk Q9: only complete 128-row frames produce subfingerprints."""
        return self.num_rows(file_frames, proc_frames) // self.rows_per_frame

    def row_starts(self, n_rows: int) -> np.ndarray:
        """Window start positions in processing samples for each row (int64)."""
        hop = self.hop_in_processing_samples
        return np.floor(np.arange(n_rows, dtype=np.float64) * hop).astype(np.int64)

    @cached_property
    def band_bin_ranges(self) -> np.ndarray:
        """``[pitch_step_count, 2]`` int array of ``[low, high)`` FFT-bin index
        ranges per band, plus see :attr:`band_widths` for the (different!)
        normalisation widths.

        Exact replication of LBAudioDetective.m:361-383 including both integer
        truncations (quirk Q6).
        """
        bins = self.pitch_step_count
        sr = self.processing_sample_rate
        max_freq = sr / 2.0
        min_freq = self.min_frequency
        log_base = math.exp(math.log(max_freq / min_freq) / bins)
        mincoef = float(self.window_size) / sr * min_freq
        indices = np.empty(bins + 1, dtype=np.int64)
        for j in range(bins + 1):
            start = int((log_base ** j - 1.0) * mincoef)  # C UInt32 truncation
            indices[j] = start + int(mincoef)
        ranges = np.empty((bins, 2), dtype=np.int64)
        for i in range(bins):
            low, high = indices[i], indices[i + 1]
            # Q6 second conversion: the "Hz-like" values are re-divided by the
            # bin width sr/window and shifted by -1, truncating to UInt32.
            ranges[i, 0] = int((2.0 * low) / (sr / self.window_size) - 1.0)
            ranges[i, 1] = int((2.0 * high) / (sr / self.window_size) - 1.0)
        return ranges

    @cached_property
    def band_widths(self) -> np.ndarray:
        """Normalisation denominators per band: ``highBound - lowBound`` in the
        *first*-stage (bin-unit) indices, not the final index width
        (LBAudioDetective.m:404)."""
        bins = self.pitch_step_count
        sr = self.processing_sample_rate
        log_base = math.exp(math.log((sr / 2.0) / self.min_frequency) / bins)
        mincoef = float(self.window_size) / sr * self.min_frequency
        indices = np.array(
            [int((log_base ** j - 1.0) * mincoef) + int(mincoef) for j in range(bins + 1)],
            dtype=np.int64,
        )
        return (indices[1:] - indices[:-1]).astype(np.float32)

    @cached_property
    def spectrum_scale_divisor(self) -> float:
        """Quirk Q5 positive-component divisor: ``(window/2)/2`` with integer
        division (LBAudioDetective.m:373,390-395)."""
        width = self.window_size // 2
        return float(width // 2)

    def with_updates(self, **kwargs) -> "FingerprintConfig":
        return dataclasses.replace(self, **kwargs)
