"""Device-side (JAX/XLA) compute ops: spectral analysis, Haar
transform, subfingerprint extraction and fingerprint matching."""
