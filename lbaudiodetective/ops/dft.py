"""Real DFT as matmuls (two-stage Cooley-Tukey), restricted to the
spectral bins the band reduction actually consumes.

The pipeline needs only bins [86, 760) of a 2048-point real DFT (the
quirk-Q6 band ranges), so a dense factored DFT over just those bins
replaces a full FFT.  Factoring N = A * B (16 * 128 by default):

    n = a*B + b
    X[k] = sum_b e^{-2 pi i k b / N} * G[b, k mod A]
    G[b, r] = sum_a w[a*B + b] * e^{-2 pi i a r / A}      (stage 1: [B,A]@[A,A])
    stage 2: one batched complex matmul per residue class r over the b axis.

FLOPs per window ~0.8 MFLOP vs 5.5 MFLOP for a direct dense DFT over the same
bins, and every op is a matmul.  The vDSP 2x output scale (SURVEY Q5) is
folded into the stage-2 twiddle matrices.

Precision: float32 with HIGHEST matmul precision — required for bit-parity of
the |coeff| ranking with the float64-FFT golden oracle.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.ops.spectral import band_projection_matrix, bands_in_interior

_STAGE1 = 16   # A: DFT length over the strided axis
_STAGE2 = 128  # B: window_size // A


@lru_cache(maxsize=8)
def _dft_constants(window_size: int, bin_lo: int, bin_hi: int):
    """Precompute stage matrices for bins [bin_lo, bin_hi).

    Returns (c1, s1, t_re, t_im, perm):
      c1/s1: ``[A, A]`` stage-1 real/imag DFT matrices
      t_re/t_im: ``[A, B, K]`` per-residue stage-2 twiddles (zero-padded
                 ragged classes), including the vDSP 2x scale
      perm: ``[n_bins]`` gather indices mapping (r, slot) -> ascending k
    """
    a_len, b_len = _STAGE1, window_size // _STAGE1
    n = window_size
    ks = np.arange(bin_lo, bin_hi)
    n_bins = len(ks)

    aa, rr = np.meshgrid(np.arange(a_len), np.arange(a_len), indexing="ij")
    theta1 = 2.0 * np.pi * aa * rr / a_len
    c1 = np.cos(theta1).astype(np.float32)
    s1 = (-np.sin(theta1)).astype(np.float32)

    # Group bins by residue class r = k mod A.
    classes = [ks[ks % a_len == r] for r in range(a_len)]
    k_max = max(len(c) for c in classes)
    t_re = np.zeros((a_len, b_len, k_max), np.float32)
    t_im = np.zeros((a_len, b_len, k_max), np.float32)
    perm = np.zeros(n_bins, np.int64)
    b = np.arange(b_len)
    for r, cls in enumerate(classes):
        for slot, k in enumerate(cls):
            theta = 2.0 * np.pi * k * b / n
            # 2x fold: vDSP fft_zrip packed output is twice the DFT value.
            t_re[r, :, slot] = 2.0 * np.cos(theta)
            t_im[r, :, slot] = -2.0 * np.sin(theta)
            perm[np.searchsorted(ks, k)] = r * k_max + slot
    # NumPy out (not jnp): this cache must not capture jit tracers/buffers.
    return c1, s1, t_re, t_im, perm


def rdft_bins(windows: jnp.ndarray, bin_lo: int, bin_hi: int,
              precision=None) -> tuple[jnp.ndarray, jnp.ndarray]:
    """``[..., window] -> (re, im)`` each ``[..., bin_hi-bin_lo]``: 2x the real
    DFT at bins [bin_lo, bin_hi), vDSP-scaled (see packed_spectrum).

    Requires ``1 <= bin_lo`` and ``bin_hi <= window/2`` (no packed DC/Nyquist
    slots in range).
    """
    n = windows.shape[-1]
    if not (1 <= bin_lo and bin_hi <= n // 2):
        raise ValueError("rdft_bins requires bins inside (0, n/2)")
    a_len, b_len = _STAGE1, n // _STAGE1
    c1_np, s1_np, t_re_np, t_im_np, perm_np = _dft_constants(n, bin_lo, bin_hi)
    c1, s1 = jnp.asarray(c1_np), jnp.asarray(s1_np)
    t_re, t_im = jnp.asarray(t_re_np), jnp.asarray(t_im_np)
    perm = jnp.asarray(perm_np)
    hi = precision if precision is not None else jax.lax.Precision.HIGHEST

    y = windows.reshape(*windows.shape[:-1], a_len, b_len)  # [..., a, b]
    # Stage 1: DFT over a for every b -> G[..., b, r].
    g_re = jnp.einsum("...ab,ar->...br", y, c1, precision=hi,
                      preferred_element_type=jnp.float32)
    g_im = jnp.einsum("...ab,ar->...br", y, s1, precision=hi,
                      preferred_element_type=jnp.float32)
    # Stage 2: per residue class, contract over b.
    x_re = (jnp.einsum("...br,rbk->...rk", g_re, t_re, precision=hi,
                       preferred_element_type=jnp.float32)
            - jnp.einsum("...br,rbk->...rk", g_im, t_im, precision=hi,
                         preferred_element_type=jnp.float32))
    x_im = (jnp.einsum("...br,rbk->...rk", g_re, t_im, precision=hi,
                       preferred_element_type=jnp.float32)
            + jnp.einsum("...br,rbk->...rk", g_im, t_re, precision=hi,
                         preferred_element_type=jnp.float32))
    lead = x_re.shape[:-2]
    x_re = x_re.reshape(*lead, -1)[..., perm]
    x_im = x_im.reshape(*lead, -1)[..., perm]
    return x_re, x_im


@lru_cache(maxsize=8)
def band_stage_constants(config: FingerprintConfig):
    """Stage matrices of the factored DFT for ``config``'s band bins, with
    the band projection pre-permuted into (residue, slot) order so the
    strided-convolution path (ops.spectral.conv_band_rows) never reorders
    bins.

    Returns ``(c16, s16, t_re, t_im, proj_perm, k_max)``.
    """
    if not bands_in_interior(config):
        raise ValueError(
            "the factored DFT requires band bins strictly inside "
            "(0, window/2); use the xla rows path for this config")
    n = config.window_size
    b_len = n // _STAGE1
    ranges = config.band_bin_ranges
    lo, hi = int(ranges[:, 0].min()), int(ranges[:, 1].max())
    ks = np.arange(lo, hi)

    a = np.arange(_STAGE1)
    theta1 = 2.0 * np.pi * np.outer(a, np.arange(_STAGE1)) / _STAGE1
    c16 = np.cos(theta1).astype(np.float32)          # [a, r]
    s16 = (-np.sin(theta1)).astype(np.float32)

    classes = [ks[ks % _STAGE1 == r] for r in range(_STAGE1)]
    k_max = max(len(c) for c in classes)
    t_re = np.zeros((_STAGE1, b_len, k_max), np.float32)
    t_im = np.zeros((_STAGE1, b_len, k_max), np.float32)
    proj = band_projection_matrix(config)            # [n/2, bands]
    proj_perm = np.zeros((_STAGE1 * k_max, config.pitch_step_count), np.float32)
    bb = np.arange(b_len)
    for r, cls in enumerate(classes):
        for slot, k in enumerate(cls):
            theta = 2.0 * np.pi * k * bb / n
            t_re[r, :, slot] = 2.0 * np.cos(theta)   # vDSP 2x scale folded in
            t_im[r, :, slot] = -2.0 * np.sin(theta)
            proj_perm[r * k_max + slot] = proj[k]
    return c16, s16, t_re, t_im, proj_perm, k_max
