"""Sign selection (ops.extract.select_sign_classes) vs a NumPy stable argsort.

The selection must be element-exact: same top-k membership AND rank order,
with |coeff| ties broken toward the lower flat index — the reference's
NSNumber-sort behaviour (LBAudioDetectiveFrame.m:165-191)."""

import numpy as np
import jax
import jax.numpy as jnp

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.ops.extract import (
    extract_fingerprint_padded, required_padded_length, select_sign_classes,
    subfingerprints_from_rows)
from lbaudiodetective.ops.haar import haar_2d

_select = jax.jit(select_sign_classes, static_argnums=1)


def _ref_cls(flat, k=100):
    bits = flat.view(np.uint32)
    keys = ~(bits & 0x7FFFFFFF)
    cls = (flat > 0).astype(np.uint8) + 2 * (flat < 0).astype(np.uint8)
    order = np.argsort(keys, axis=-1, kind="stable")
    return np.take_along_axis(cls, order, axis=-1)[..., :k]


def _check(x, k=100):
    got = np.asarray(_select(jnp.asarray(x), k))
    np.testing.assert_array_equal(got, _ref_cls(x, k))


def test_random():
    rng = np.random.default_rng(0)
    _check(rng.standard_normal((64, 4096)).astype(np.float32))
    _check(rng.standard_normal((8, 2048)).astype(np.float32), k=64)


def test_plus_minus_tie_pairs():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 4096)).astype(np.float32)
    x[:, 1::2] = -x[:, ::2]          # every |value| duplicated with both signs
    _check(x)


def test_k_boundary_ties():
    x = np.zeros((64, 4096), np.float32)
    x[:, :50] = 1.5
    x[:, 100:160] = -1.5             # 110 equal-|x| elements straddling k=100
    _check(x)
    # Ties spanning the blocked sort's block boundaries (block = 512).
    y = np.zeros((4, 4096), np.float32)
    y[:, 480:560] = 2.0
    y[:, 1000:1100] = -2.0
    _check(y)


def test_all_zero_and_few_values():
    _check(np.zeros((32, 4096), np.float32))
    rng = np.random.default_rng(2)
    x = rng.choice(np.float32([0.5, -0.5, 2.0, -2.0, 0.0]), size=(32, 4096))
    _check(x.astype(np.float32))


def test_padding_path():
    """Subfingerprints past ``n_valid_sub`` come back zeroed, and the valid
    ones equal the Haar + select reference on the unpadded frames."""
    cfg = FingerprintConfig(hop_domain="proc")
    n_rows = 5 * cfg.rows_per_frame
    rng = np.random.default_rng(3)
    audio = (rng.standard_normal((2, required_padded_length(cfg, n_rows)))
             * 0.1).astype(np.float32)
    pos, neg = extract_fingerprint_padded(
        jnp.asarray(audio), jnp.asarray([5, 3], jnp.int32), cfg, n_rows)
    pos, neg = np.asarray(pos), np.asarray(neg)
    assert pos.shape == (2, 5, cfg.num_wavelet_pairs)
    assert not pos[1, 3:].any() and not neg[1, 3:].any()
    assert (pos[:, :3] + neg[:, :3] == 1).all()
    # subfingerprints_from_rows == haar_2d then select, frame by frame.
    rows = rng.standard_normal((3, 2 * 128, 32)).astype(np.float32)
    p, n = subfingerprints_from_rows(jnp.asarray(rows), FingerprintConfig())
    coeffs = np.asarray(haar_2d(jnp.asarray(rows.reshape(3, 2, 128, 32))))
    cls = _ref_cls(coeffs.reshape(3, 2, 4096))
    np.testing.assert_array_equal(np.asarray(p), (cls == 1).astype(np.uint8))
    np.testing.assert_array_equal(np.asarray(n), (cls == 2).astype(np.uint8))


def test_nan_and_inf_classes_match_xla_path():
    # NaN classifies as 0 ((x>0) and (x<0) both false); +/-inf keep their
    # sign class.
    rng = np.random.default_rng(4)
    x = rng.standard_normal((32, 4096)).astype(np.float32)
    x[:, 7] = np.nan
    x[:, 11] = np.inf
    x[:, 13] = -np.inf
    _check(x)
