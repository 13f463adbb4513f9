"""FingerprintConfig derived-constant tests (quirk Q6 band arithmetic)."""

import numpy as np
import pytest

from lbaudiodetective.config import FingerprintConfig


def test_default_band_ranges_exact():
    """Frozen expectations of the double-truncated band arithmetic
    (LBAudioDetective.m:361-383): first band [86, 92), last ends at 759."""
    cfg = FingerprintConfig()
    r = cfg.band_bin_ranges
    assert r.shape == (32, 2)
    assert r[0, 0] == 86 and r[0, 1] == 92
    assert r[-1, 1] == 759
    assert (r[:, 1] >= r[:, 0]).all()
    assert r[:, 1].max() < cfg.window_size // 2  # packed-spectrum bounds
    # Contiguity in the index domain.
    np.testing.assert_array_equal(r[1:, 0], r[:-1, 1])


def test_band_widths_are_first_stage_units():
    cfg = FingerprintConfig()
    w = cfg.band_widths
    assert w.shape == (32,)
    assert w[0] == 8.0  # indices[1]-indices[0] = 126-118
    assert (w > 0).all()


def test_spectrum_scale_divisor():
    assert FingerprintConfig().spectrum_scale_divisor == 512.0
    assert FingerprintConfig(window_size=1024).spectrum_scale_divisor == 256.0


def test_hop_domains():
    cfg = FingerprintConfig()
    assert cfg.hop_domain == "file"
    # Spec choice: the fractional file-domain hop (7.99927) quantises to 8.
    assert cfg.integer_hop and cfg.hop_in_processing_samples == 8.0
    faithful = cfg.with_updates(integer_hop=False)
    assert abs(faithful.hop_in_processing_samples - 64 * 5512.0 / 44100.0) < 1e-9
    proc = cfg.with_updates(hop_domain="proc")
    assert proc.hop_in_processing_samples == 64.0
    # Row counts: file mode uses the file-rate length (quirk Q8).
    assert cfg.num_rows(file_frames=397046, proc_frames=49626) == (397046 - 2048) // 64
    assert proc.num_rows(file_frames=397046, proc_frames=49626) == (49626 - 2048) // 64


def test_validation():
    with pytest.raises(ValueError):
        FingerprintConfig(window_size=2000)  # Q4 spec-corrected
    with pytest.raises(ValueError):
        FingerprintConfig(subfingerprint_length=201)
    with pytest.raises(ValueError):
        FingerprintConfig(hop_domain="banana")


def test_hashable_and_jit_key():
    a, b = FingerprintConfig(), FingerprintConfig()
    assert a == b and hash(a) == hash(b)
    c = a.with_updates(analysis_stride=32)
    assert c != a and c.analysis_stride == 32 and a.analysis_stride == 64


def test_unvalidated_precision_warns_on_accelerator():
    """Identify paths must loudly warn when the precision tier's corpus
    identification diverges from goldens (VERDICT r2 weakness 2)."""
    import warnings

    from lbaudiodetective.config import FingerprintConfig

    for tier in ("default", "medium"):
        cfg = FingerprintConfig(matmul_precision=tier)
        assert not cfg.identification_validated
        with pytest.warns(UserWarning, match="NOT validated"):
            cfg.warn_if_unvalidated_for_identification(backend="gpu")
        # CPU backends run full f32 contractions -> exempt.
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            cfg.warn_if_unvalidated_for_identification(backend="cpu")
    for tier in ("high", "highest"):
        cfg = FingerprintConfig(matmul_precision=tier)
        assert cfg.identification_validated
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            cfg.warn_if_unvalidated_for_identification(backend="gpu")


@pytest.mark.parametrize("tier,want", [
    ("default", "DEFAULT"), ("medium", "HIGH"), ("high", "HIGHEST"),
    ("highest", "HIGHEST")])
def test_precision_tier_mapping(tier, want):
    """"high" (the default) maps to HIGHEST: on a GPU, Precision.HIGH still
    lets f32 products run in TF32, which flips fingerprint bits."""
    import jax

    from lbaudiodetective.config import FingerprintConfig

    cfg = FingerprintConfig(matmul_precision=tier)
    assert cfg.precision == getattr(jax.lax.Precision, want)
    assert cfg.identification_validated == (want == "HIGHEST")
