"""LBAudioDetective: an audio fingerprinting framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
lbrndnr/LBAudioDetective: Shazam-style binary
audio fingerprints (Haitsma-Kalker / Waveprint family) computed with batched
XLA ops on an accelerator, plus a vectorized offset-sliding matcher expressed
as matmuls, library-sharded matching over a device mesh, and a streaming
(incremental) extraction runtime.

Public surface (see also `lbaudiodetective.compat` for 1:1 C-API names):

    FingerprintConfig   -- frozen, hashable pipeline configuration
    Fingerprint         -- value type holding packed subfingerprint bits
    AudioDetective      -- end-to-end convenience object (decode->extract->match)
    extract_fingerprint -- jittable batched extraction kernel
    match_fingerprints  -- jittable offset-sliding matcher

Imports are lazy (PEP 562) so host-only paths (decode, oracle) do not pay the
JAX import cost.
"""

__version__ = "0.3.0"

_EXPORTS = {
    "FingerprintConfig": "lbaudiodetective.config",
    "Fingerprint": "lbaudiodetective.models.fingerprint",
    "FingerprintBuilder": "lbaudiodetective.models.fingerprint",
    "AudioDetective": "lbaudiodetective.models.detective",
    "FingerprintLibrary": "lbaudiodetective.models.library",
    "StreamingDetective": "lbaudiodetective.streaming.runtime",
    "StreamingExtractor": "lbaudiodetective.streaming.runtime",
    "extract_fingerprint": "lbaudiodetective.ops.extract",
    "match_fingerprints": "lbaudiodetective.ops.match",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        module = importlib.import_module(_EXPORTS[name])
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
