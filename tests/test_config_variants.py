"""Non-default preference configurations end to end (the reference's setter
surface: window size, pitch steps, subfingerprint length, sample rate —
LBAudioDetective.h:144-201)."""

import numpy as np
import pytest

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.io.decode import DecodedAudio
from lbaudiodetective.oracle.pipeline import (
    oracle_fingerprint, oracle_match_fingerprints)
from lbaudiodetective.ops.extract import extract_fingerprint
from lbaudiodetective.ops.match import match_fingerprints

VARIANTS = [
    FingerprintConfig(window_size=1024),
    FingerprintConfig(pitch_step_count=16),
    FingerprintConfig(subfingerprint_length=128),
    FingerprintConfig(analysis_stride=32),
    FingerprintConfig(processing_sample_rate=8000.0, integer_hop=False),
]


def _clip(cfg, seconds=2.0, seed=99):
    rng = np.random.default_rng(seed)
    file_frames = int(seconds * cfg.file_sample_rate)
    proc_frames = int(seconds * cfg.processing_sample_rate)
    x = (rng.standard_normal(proc_frames) * 0.1).astype(np.float32)
    return DecodedAudio(x, cfg.processing_sample_rate, file_frames,
                        cfg.file_sample_rate)


@pytest.mark.parametrize("cfg", VARIANTS, ids=lambda c: (
    f"w{c.window_size}_p{c.pitch_step_count}_l{c.subfingerprint_length}"
    f"_s{c.analysis_stride}_r{int(c.processing_sample_rate)}"))
def test_variant_jax_matches_oracle(cfg):
    a = _clip(cfg, seed=99)
    b = _clip(cfg, seed=100)
    jp_a = extract_fingerprint(a, cfg)
    op_a = oracle_fingerprint(a, cfg)
    assert jp_a[2] == op_a[0].shape[0]
    assert jp_a[2] > 0, "variant produced no subfingerprints"
    agree = ((jp_a[0][:jp_a[2]] == op_a[0]).mean()
             + (jp_a[1][:jp_a[2]] == op_a[1]).mean()) / 2
    assert agree >= 0.995, f"bit agreement {agree:.4f}"
    jp_b = extract_fingerprint(b, cfg)
    op_b = oracle_fingerprint(b, cfg)
    s_j = match_fingerprints((jp_a[0][:jp_a[2]], jp_a[1][:jp_a[2]]),
                             (jp_b[0][:jp_b[2]], jp_b[1][:jp_b[2]]),
                             0, cfg.subfingerprint_length)
    s_o = oracle_match_fingerprints(op_a, op_b, 0, cfg.subfingerprint_length)
    assert abs(s_j - s_o) < 0.02


def test_low_min_frequency_routes_to_xla():
    """Band edges at/below bin 0 (vDSP packed DC slot, or the Q6 int(x-1.0)
    truncation's -1) must gate the matmul-DFT/conv specialisations off
    and raise in the paths that cannot handle them (ADVICE r1)."""
    from lbaudiodetective.ops.extract import _rows_impl_auto
    from lbaudiodetective.ops.spectral import (
        bands_in_interior, conv_band_rows)

    cfg = FingerprintConfig(min_frequency=2.0)     # lo bin = -1
    assert not bands_in_interior(cfg)
    assert _rows_impl_auto(cfg) == "xla"
    import jax.numpy as jnp
    with pytest.raises(ValueError):
        conv_band_rows(jnp.zeros((1, 4096), jnp.float32), cfg, 2)
    from lbaudiodetective.ops.dft import band_stage_constants
    with pytest.raises(ValueError):
        band_stage_constants(cfg)
    # The xla path still runs end-to-end and matches the oracle.
    a = _clip(cfg, seconds=2.0, seed=7)
    jp = extract_fingerprint(a, cfg)
    op = oracle_fingerprint(a, cfg)
    assert jp[2] == op[0].shape[0] > 0
    agree = ((jp[0][:jp[2]] == op[0]).mean() + (jp[1][:jp[2]] == op[1]).mean()) / 2
    assert agree >= 0.995, f"bit agreement {agree:.4f}"
