"""Haar wavelet transform: oracle recursion vs matmul form, plus the
reference test's 3x4 example (LBAudioDetectiveTests.m:157-176)."""

import numpy as np

from lbaudiodetective.oracle.pipeline import haar_decompose_array, haar_decompose_frame
from lbaudiodetective.ops.haar import haar_2d, haar_matrix


def test_haar_array_energy_preserved():
    """The reference 1-D transform is orthonormal up to the 1/sqrt(n)
    pre-scale: ||H x||^2 == ||x||^2 / n."""
    rng = np.random.default_rng(1)
    for n in (2, 8, 32, 128):
        x = rng.standard_normal(n).astype(np.float32)
        y = haar_decompose_array(x)
        np.testing.assert_allclose((y ** 2).sum(), (x ** 2).sum() / n, rtol=1e-5)


def test_haar_array_constant_input():
    """A constant vector concentrates into the approximation coefficient."""
    x = np.full(32, 3.0, np.float32)
    y = haar_decompose_array(x)
    # After /sqrt(32) then 5 averaging stages each *sqrt(2): 3/sqrt(32)*sqrt(32)...
    np.testing.assert_allclose(y[0], 3.0, rtol=1e-6)
    np.testing.assert_allclose(y[1:], 0.0, atol=1e-6)


def test_haar_matrix_matches_recursion():
    rng = np.random.default_rng(2)
    for n in (32, 128):
        h = haar_matrix(n)
        x = rng.standard_normal(n).astype(np.float32)
        np.testing.assert_allclose(h @ x, haar_decompose_array(x), rtol=2e-5, atol=1e-6)


def test_haar_2d_matches_oracle_frame():
    rng = np.random.default_rng(3)
    frame = rng.standard_normal((128, 32)).astype(np.float32)
    expected = haar_decompose_frame(frame)
    got = np.asarray(haar_2d(frame[None])[0])
    np.testing.assert_allclose(got, expected, rtol=3e-4, atol=3e-6)


def test_haar_nonpow2_reference_example():
    """The reference's own smoke test decomposes a 3-row x 4-col frame
    (LBAudioDetectiveTests.m:160-166); columns of length 3 exercise the
    non-power-of-two path of the recursion (only one halving step, the third
    element left scaled)."""
    frame = np.array([[538, 940, 1940, 1794],
                      [1840, 213, 1320, 913],
                      [192, 591, 492, 1921]], dtype=np.float32)
    out = haar_decompose_frame(frame)
    # Row pass of row 0: /2 then butterflies.
    r0 = haar_decompose_array(frame[0])
    expected_first = haar_decompose_array(
        np.array([r0[0],
                  haar_decompose_array(frame[1])[0],
                  haar_decompose_array(frame[2])[0]], dtype=np.float32))
    np.testing.assert_allclose(out[:, 0], expected_first, rtol=1e-6)
    assert np.isfinite(out).all()
