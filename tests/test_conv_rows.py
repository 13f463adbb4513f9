"""Strided-convolution spectral path vs the gather+DFT XLA path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.ops import spectral
from lbaudiodetective.ops.extract import required_padded_length


@pytest.mark.parametrize("hop_domain", ["file", "proc"])
def test_conv_rows_matches_xla(hop_domain):
    cfg = FingerprintConfig(hop_domain=hop_domain)
    assert cfg.has_integer_hop
    n_rows = 256
    t_pad = required_padded_length(cfg, n_rows)
    rng = np.random.default_rng(70)
    audio = jnp.asarray((rng.standard_normal((2, t_pad)) * 0.1).astype(np.float32))
    got = np.asarray(jax.jit(
        lambda a: spectral.conv_band_rows(a, cfg, n_rows))(audio))
    starts = spectral.window_starts(cfg, n_rows)
    wins = np.asarray(audio)[:, starts[:, None] + np.arange(cfg.window_size)[None, :]]
    exp = np.asarray(jax.jit(lambda w: spectral.band_energies(w, cfg))(jnp.asarray(wins)))
    np.testing.assert_allclose(got, exp, rtol=1e-4,
                               atol=1e-6 * float(np.abs(exp).max()))


def test_conv_rows_rejects_fractional_hop():
    cfg = FingerprintConfig(integer_hop=False)
    with pytest.raises(ValueError):
        spectral.conv_band_rows(jnp.zeros((1, 4096), jnp.float32), cfg, 128)


def test_conv_rows_short_audio_padded():
    cfg = FingerprintConfig()
    rows = np.asarray(jax.jit(
        lambda a: spectral.conv_band_rows(a, cfg, 128))(
            jnp.zeros((1, 1000), jnp.float32)))
    assert rows.shape == (1, 128, 32)
    np.testing.assert_allclose(rows, 0.0)
