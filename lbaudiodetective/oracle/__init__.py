"""Golden NumPy oracle: a scalar-faithful re-derivation of the reference
pipeline (all quirks Q1-Q11 of SURVEY.md §2.2), used as the fixture generator
and parity target for the JAX implementation."""

from lbaudiodetective.oracle.pipeline import (
    oracle_fingerprint,
    oracle_fingerprint_from_file,
    oracle_compare,
    oracle_match_fingerprints,
    haar_decompose_array,
    haar_decompose_frame,
    compute_band_energies,
)

__all__ = [
    "oracle_fingerprint",
    "oracle_fingerprint_from_file",
    "oracle_compare",
    "oracle_match_fingerprints",
    "haar_decompose_array",
    "haar_decompose_frame",
    "compute_band_energies",
]
