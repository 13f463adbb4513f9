"""Rational-rate polyphase windowed-sinc resampling.

Replaces the reference's implicit AudioToolbox sample-rate conversion (client
format 5512 Hz forced on a 44.1 kHz file, LBAudioDetective.m:229).  The ratio
5512/44100 reduces to 1378/11025, so this is a true rational polyphase
resampler: a Kaiser-windowed sinc prototype evaluated at L=1378 fractional
phases.  The same precomputed bank drives both the host (NumPy) decode path
and the on-device JAX gather+dot formulation, so the two produce identical
samples.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np


def _reduce_ratio(fs_in: float, fs_out: float) -> tuple[int, int]:
    # Ratios of interest are rational with modest denominators (44100/5512 etc).
    from fractions import Fraction

    frac = Fraction(fs_out).limit_denominator(1 << 20) / Fraction(fs_in).limit_denominator(1 << 20)
    return frac.numerator, frac.denominator  # L (up), M (down)


@lru_cache(maxsize=8)
def design_polyphase_bank(
    up: int,
    down: int,
    half_width_out: int = 20,
    beta: float = 9.0,
    rolloff: float = 0.945,
) -> np.ndarray:
    """Design the ``[up, taps]`` float32 polyphase filter bank.

    ``half_width_out`` is the kernel half-width measured in *output*-rate
    samples; the per-output tap count is ``2 * half_width_out * max(1, down/up)``
    input samples, covering that many sinc lobes of the (downsampling-scaled)
    kernel.
    """
    ratio = down / up
    cutoff = min(1.0, 1.0 / ratio) * rolloff  # in units of input Nyquist
    half_in = max(1, int(math.ceil(half_width_out * max(1.0, ratio))))
    taps = 2 * half_in
    # Tap j of phase p evaluates the prototype at (j - half_in + 1 - p/up).
    j = np.arange(taps, dtype=np.float64)[None, :]
    p = (np.arange(up, dtype=np.float64) / up)[:, None]
    tau = j - (half_in - 1) - p
    kernel = cutoff * np.sinc(cutoff * tau)
    # Kaiser window evaluated at continuous tau via the analytic form.
    x = tau / half_in
    win = np.where(np.abs(x) <= 1.0, np.i0(beta * np.sqrt(np.maximum(0.0, 1 - x * x))) / np.i0(beta), 0.0)
    bank = (kernel * win).astype(np.float64)
    # Normalise each phase to unit DC gain so pure tones keep amplitude.
    bank /= bank.sum(axis=1, keepdims=True)
    return bank.astype(np.float32)


def polyphase_plan(n_in: int, up: int, down: int, bank: np.ndarray):
    """Compute gather indices for resampling a length-``n_in`` signal.

    Returns ``(n_out, base_index, phase)`` where output ``n`` is the dot of
    ``x_padded[base_index[n] : base_index[n] + taps]`` with ``bank[phase[n]]``.
    ``x`` must be left/right padded with ``taps`` zeros (see resample_rational).
    """
    n_out = (n_in * up) // down
    n = np.arange(n_out, dtype=np.int64)
    num = n * down
    i0 = num // up                     # floor(n * M / L)
    phase = (num - i0 * up).astype(np.int64)  # fractional part * L
    half_in = bank.shape[1] // 2
    base = i0 - (half_in - 1)
    return n_out, base, phase


def resample_rational(x: np.ndarray, fs_in: float, fs_out: float,
                      bank: np.ndarray | None = None) -> np.ndarray:
    """Resample mono float32 ``x`` from ``fs_in`` to ``fs_out`` (NumPy host path)."""
    if fs_in == fs_out:
        return np.asarray(x, dtype=np.float32)
    up, down = _reduce_ratio(fs_in, fs_out)
    if bank is None:
        bank = design_polyphase_bank(up, down)
    try:
        from lbaudiodetective.io.native import binding as native

        if native.available():
            return native.resample(np.asarray(x, np.float32), bank, up, down)
    except Exception:
        pass
    taps = bank.shape[1]
    n_out, base, phase = polyphase_plan(len(x), up, down, bank)
    xp = np.concatenate([np.zeros(taps, np.float32), np.asarray(x, np.float32),
                         np.zeros(taps, np.float32)])
    # Gather [n_out, taps] windows and contract with the per-phase taps.
    idx = (base + taps)[:, None] + np.arange(taps, dtype=np.int64)[None, :]
    windows = xp[idx]
    return np.einsum("nt,nt->n", windows, bank[phase]).astype(np.float32)


def resample_rational_jax(x, fs_in: float, fs_out: float, n_in: int | None = None):
    """Device-side resampler: same polyphase bank as the host path, as a
    JAX gather + per-row dot (identical plan arithmetic -> identical samples
    up to contraction order).

    ``x``: ``[..., T]`` float32 on device; ``n_in`` fixes the plan length for
    jit (defaults to T).  Returns ``[..., n_out]``.
    """
    import jax.numpy as jnp

    if fs_in == fs_out:
        return x
    up, down = _reduce_ratio(fs_in, fs_out)
    bank = design_polyphase_bank(up, down)
    taps = bank.shape[1]
    n_in = int(x.shape[-1]) if n_in is None else n_in
    n_out, base, phase = polyphase_plan(n_in, up, down, bank)
    pad = [(0, 0)] * (x.ndim - 1) + [(taps, taps)]
    xp = jnp.pad(x, pad)
    idx = jnp.asarray((base + taps)[:, None] + np.arange(taps, dtype=np.int64)[None, :])
    windows = xp[..., idx]                                   # [..., n_out, taps]
    weights = jnp.asarray(bank[phase])                       # [n_out, taps]
    return jnp.einsum("...nt,nt->...n", windows, weights)
