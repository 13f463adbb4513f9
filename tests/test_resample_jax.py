"""Device-side JAX resampler vs the host polyphase path."""

import numpy as np
import jax.numpy as jnp

from lbaudiodetective.io.resample import (
    design_polyphase_bank, polyphase_plan, resample_rational_jax)


def _host_reference(x, up, down):
    bank = design_polyphase_bank(up, down)
    taps = bank.shape[1]
    n_out, base, phase = polyphase_plan(len(x), up, down, bank)
    xp = np.concatenate([np.zeros(taps, np.float32), x, np.zeros(taps, np.float32)])
    idx = (base + taps)[:, None] + np.arange(taps)[None, :]
    return np.einsum("nt,nt->n", xp[idx], bank[phase]).astype(np.float32)


def test_jax_resampler_matches_host():
    rng = np.random.default_rng(93)
    x = (rng.standard_normal(22050) * 0.3).astype(np.float32)
    got = np.asarray(resample_rational_jax(jnp.asarray(x), 44100.0, 5512.0))
    expected = _host_reference(x, 1378, 11025)
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, atol=2e-6)


def test_jax_resampler_batched():
    rng = np.random.default_rng(94)
    x = (rng.standard_normal((3, 11025)) * 0.3).astype(np.float32)
    got = np.asarray(resample_rational_jax(jnp.asarray(x), 44100.0, 5512.0))
    assert got.shape == (3, (11025 * 1378) // 11025)
    for i in range(3):
        np.testing.assert_allclose(got[i], _host_reference(x[i], 1378, 11025),
                                   atol=2e-6)
