"""Polyphase resampler tests (replaces AudioToolbox implicit SRC)."""

import numpy as np

from lbaudiodetective.io.resample import (
    design_polyphase_bank, polyphase_plan, resample_rational)


def test_tone_preserved():
    """A 440 Hz tone resampled 44100 -> 5512 keeps frequency and amplitude."""
    fs_in, fs_out, f0 = 44100.0, 5512.0, 440.0
    t = np.arange(int(fs_in)) / fs_in
    x = np.sin(2 * np.pi * f0 * t).astype(np.float32)
    y = resample_rational(x, fs_in, fs_out)
    assert abs(len(y) - int(fs_out * 1.0)) <= 2
    core = y[200:-200]
    # Dominant DFT bin at 440 Hz.
    spec = np.abs(np.fft.rfft(core * np.hanning(len(core))))
    freqs = np.fft.rfftfreq(len(core), 1.0 / fs_out)
    assert abs(freqs[np.argmax(spec)] - f0) < 3.0
    # Amplitude preserved within 1%.
    assert abs(core.max() - 1.0) < 0.01


def test_alias_rejection():
    """Content above the output Nyquist (2756 Hz) must be strongly attenuated."""
    fs_in, fs_out = 44100.0, 5512.0
    t = np.arange(int(fs_in)) / fs_in
    x = np.sin(2 * np.pi * 8000.0 * t).astype(np.float32)
    y = resample_rational(x, fs_in, fs_out)
    rms = float(np.sqrt(np.mean(y[200:-200] ** 2)))
    assert rms < 1e-3  # > 55 dB rejection


def test_dc_gain_unity():
    x = np.ones(44100, np.float32)
    y = resample_rational(x, 44100.0, 5512.0)
    np.testing.assert_allclose(y[100:-100], 1.0, atol=1e-4)


def test_identity_when_rates_equal():
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    np.testing.assert_array_equal(resample_rational(x, 5512.0, 5512.0), x)


def test_plan_phase_periodicity():
    bank = design_polyphase_bank(1378, 11025)
    n_out, base, phase = polyphase_plan(44100, 1378, 11025, bank)
    assert n_out == (44100 * 1378) // 11025
    # Phase pattern repeats with period lcm structure: phase[n+1378] == phase[n].
    assert np.array_equal(phase[:100], phase[1378:1478])
    # Bank rows are normalised to unit DC gain.
    np.testing.assert_allclose(bank.sum(axis=1), 1.0, atol=1e-6)
