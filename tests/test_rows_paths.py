"""The spectral rows paths against each other and the oracle.

Extraction picks its rows path from the config alone (ops.extract.
_rows_impl_auto): the strided-convolution factorisation for integer hops,
the window gather + matmul DFT otherwise.  The gather path with the full
packed rfft is the third candidate.  All must produce the oracle's band
energies and the same Haar coefficients."""

import importlib.util
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.ops import extract, spectral
from lbaudiodetective.ops.extract import (
    extract_fingerprint_padded, required_padded_length)
from lbaudiodetective.ops.haar import haar_2d
from lbaudiodetective.oracle.pipeline import compute_band_energies


def _audio(cfg, n_rows, batch=2, seed=50):
    rng = np.random.default_rng(seed)
    t_pad = required_padded_length(cfg, n_rows)
    return jnp.asarray((np.cumsum(rng.standard_normal((batch, t_pad)), axis=1)
                        * 0.01).astype(np.float32))


def _xla_rows(cfg, audio, n_rows, use_matmul_dft=True):
    starts = spectral.window_starts(cfg, n_rows)
    wins = spectral.frame_windows(audio, starts, cfg.window_size)
    return np.asarray(jax.jit(lambda w: spectral.band_energies(
        w, cfg, use_matmul_dft=use_matmul_dft))(wins))


@pytest.mark.parametrize("hop_domain,integer_hop", [
    ("file", True), ("file", False), ("proc", True)])
def test_rows_paths_match_oracle(hop_domain, integer_hop):
    """Every rows path available for the config matches the oracle's band
    energies window by window."""
    cfg = FingerprintConfig(hop_domain=hop_domain, integer_hop=integer_hop)
    n_rows = 256
    audio = _audio(cfg, n_rows)
    starts = spectral.window_starts(cfg, n_rows)
    a = np.asarray(audio)
    ref = np.stack([[compute_band_energies(a[b, s:s + cfg.window_size], cfg)
                     for s in starts] for b in range(a.shape[0])])
    got = {"xla_matmul_dft": _xla_rows(cfg, audio, n_rows),
           "xla_rfft": _xla_rows(cfg, audio, n_rows, use_matmul_dft=False)}
    if cfg.has_integer_hop:
        got["conv"] = np.asarray(jax.jit(
            lambda x: spectral.conv_band_rows(x, cfg, n_rows))(audio))
    scale = float(np.abs(ref).max())
    for name, rows in got.items():
        np.testing.assert_allclose(rows, ref, rtol=1e-4, atol=1e-6 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("stride_cfg,n_rows", [
    (dict(), 256),                                        # parity hop 8
    (dict(), 3 * 128),                                    # odd frame count
    (dict(hop_domain="proc"), 256),                       # deployment hop 64
    (dict(hop_domain="proc"), 7 * 128),
    (dict(hop_domain="proc", analysis_stride=128), 256),  # hop 128
    (dict(analysis_stride=32), 256),                      # hop 4
])
def test_conv_coeffs_match_xla(stride_cfg, n_rows):
    """Haar coefficients from the conv rows equal those from the gather
    path, and both rows paths give the same fingerprint bits."""
    cfg = FingerprintConfig(**stride_cfg)
    assert cfg.has_integer_hop
    audio = _audio(cfg, n_rows, seed=51)
    conv = np.asarray(jax.jit(
        lambda x: spectral.conv_band_rows(x, cfg, n_rows))(audio))
    xla = _xla_rows(cfg, audio, n_rows)
    frames = (2, n_rows // 128, 128, 32)
    c_conv = np.asarray(haar_2d(jnp.asarray(conv.reshape(frames))))
    c_xla = np.asarray(haar_2d(jnp.asarray(xla.reshape(frames))))
    np.testing.assert_allclose(c_conv, c_xla, rtol=5e-4,
                               atol=3e-6 * float(np.abs(c_xla).max()))
    n_sub = jnp.full((2,), n_rows // 128, jnp.int32)
    bits = [np.asarray(extract_fingerprint_padded(audio, n_sub, cfg, n_rows,
                                                  rows_impl=impl)[0])
            for impl in ("conv", "xla")]
    assert (bits[0] == bits[1]).mean() >= 0.999


@pytest.mark.parametrize("cfg,want", [
    (FingerprintConfig(), "conv"),
    (FingerprintConfig(hop_domain="proc"), "conv"),
    (FingerprintConfig(hop_domain="proc", analysis_stride=128), "conv"),
    (FingerprintConfig(integer_hop=False), "xla"),
    (FingerprintConfig(min_frequency=2.0), "xla"),
], ids=["parity", "proc", "proc_hop128", "fractional", "low_band"])
def test_dispatch_on_gpu_backend(monkeypatch, cfg, want):
    """With the backend reported as a GPU, the rows path still follows the
    config alone, and nothing imports a kernel package."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert extract._rows_impl_auto(cfg) == want
    assert importlib.util.find_spec("lbaudiodetective.ops.pallas") is None
    assert not any(m.startswith("lbaudiodetective.ops.pallas")
                   for m in sys.modules)


def test_unknown_rows_impl_rejected():
    cfg = FingerprintConfig()
    with pytest.raises(ValueError, match="rows_impl"):
        extract_fingerprint_padded(jnp.zeros((1, 4096)), jnp.ones((1,), jnp.int32),
                                   cfg, 128, rows_impl="fused")
