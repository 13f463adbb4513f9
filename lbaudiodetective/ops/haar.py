"""2-D Haar wavelet transform as matrix multiplication.

The reference decomposes each 128x32 spectrogram frame with a recursive
scalar Haar transform (rows then columns, LBAudioDetectiveFrame.m:113-153).
The transform is linear, so we express it as two small matmuls:

    coeffs = H_128 @ frame @ H_32^T

where ``H_n`` is the dense matrix of the reference's 1-D decomposition
(1/sqrt(n) pre-normalisation followed by log2(n) butterfly halvings).  The
matrices are built once (float64, cast to float32) by applying the golden
oracle's recursion to identity columns, so the linear map is exactly the
oracle's up to float reassociation.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=8)
def haar_matrix(n: int) -> np.ndarray:
    """Dense ``[n, n]`` float32 matrix of the reference's 1-D Haar transform."""
    if n & (n - 1):
        raise ValueError(f"Haar length must be a power of two, got {n}")
    m = np.eye(n, dtype=np.float64) / np.sqrt(n)
    size = n
    while size > 1:
        size //= 2
        even = m[0:2 * size:2]
        odd = m[1:2 * size:2]
        lo = (even + odd) / np.sqrt(2.0)
        hi = (even - odd) / np.sqrt(2.0)
        m[:size] = lo
        m[size:2 * size] = hi
    return m.astype(np.float32)


def haar_2d(frames: jnp.ndarray, precision=None) -> jnp.ndarray:
    """Batched 2-D Haar: ``[..., rows, cols] -> [..., rows, cols]`` coefficient
    tensors, rows/cols each a power of two.  Two matmuls."""
    if precision is None:
        precision = jax.lax.Precision.HIGHEST
    rows, cols = frames.shape[-2], frames.shape[-1]
    h_rows = jnp.asarray(haar_matrix(rows))
    h_cols = jnp.asarray(haar_matrix(cols))
    # Row pass operates along the length-`cols` axis, column pass along rows.
    # Elevated precision: reduced-precision f32 products (TF32, bf16)
    # would perturb the |coeff| ranking that defines the fingerprint bits.
    row_pass = jnp.einsum("...rc,kc->...rk", frames, h_cols,
                          preferred_element_type=jnp.float32,
                          precision=precision)
    return jnp.einsum("qr,...rk->...qk", h_rows, row_pass,
                      preferred_element_type=jnp.float32,
                      precision=precision)
