"""Spectral stage: vDSP packed-FFT semantics and quirk-Q5 normalisation."""

import jax.numpy as jnp
import numpy as np

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.oracle.pipeline import compute_band_energies, vdsp_packed_spectrum
from lbaudiodetective.ops.spectral import band_energies, packed_spectrum


def test_packed_spectrum_semantics_oracle():
    """Oracle packed layout: slot 0 carries (2*DC, 2*Nyquist); bin k carries
    2x the DFT value."""
    n = 2048
    rng = np.random.default_rng(4)
    x = rng.standard_normal(n).astype(np.float32)
    re, im = vdsp_packed_spectrum(x)
    spec = np.fft.rfft(x.astype(np.float64))
    np.testing.assert_allclose(re[0], 2 * spec[0].real, rtol=1e-5)
    np.testing.assert_allclose(im[0], 2 * spec[n // 2].real, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(re[100], 2 * spec[100].real, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(im[100], 2 * spec[100].imag, rtol=1e-4, atol=1e-4)


def test_packed_spectrum_jax_matches_oracle():
    n = 2048
    rng = np.random.default_rng(5)
    x = rng.standard_normal(n).astype(np.float32)
    re_o, im_o = vdsp_packed_spectrum(x)
    re_j, im_j = packed_spectrum(jnp.asarray(x[None]))
    np.testing.assert_allclose(np.asarray(re_j)[0], re_o, rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(np.asarray(im_j)[0], im_o, rtol=2e-4, atol=2e-3)


def test_band_energies_jax_vs_oracle():
    cfg = FingerprintConfig()
    rng = np.random.default_rng(6)
    wins = rng.standard_normal((4, cfg.window_size)).astype(np.float32) * 0.1
    expected = np.stack([compute_band_energies(w, cfg) for w in wins])
    got = np.asarray(band_energies(jnp.asarray(wins), cfg))
    np.testing.assert_allclose(got, expected, rtol=2e-4, atol=1e-9)


def test_q5_asymmetric_normalisation():
    """A pure cosine places +A at one bin: positive re is divided by 512, the
    mirrored negative parts are not — check the asymmetry exists."""
    cfg = FingerprintConfig()
    n = cfg.window_size
    k = 200  # inside band coverage (bins 86..759)
    t = np.arange(n)
    x_pos = np.cos(2 * np.pi * k * t / n).astype(np.float32)
    x_neg = -x_pos
    e_pos = compute_band_energies(x_pos, cfg)
    e_neg = compute_band_energies(x_neg, cfg)
    # +cos -> re[k] = +2*(n/2) = 2048 -> /512 = 4 -> v = 16
    # -cos -> re[k] = -2048, kept -> v = 2048^2: wildly larger (quirk Q5).
    assert e_neg.max() > 1000 * e_pos.max()


def test_dc_only_window_zero_bands():
    """Constant signal has energy only at DC (bin 0) which no band covers."""
    cfg = FingerprintConfig()
    x = np.full(cfg.window_size, 0.5, np.float32)
    e = compute_band_energies(x, cfg)
    np.testing.assert_allclose(e, 0.0, atol=1e-6)
