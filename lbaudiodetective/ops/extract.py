"""Fingerprint extraction: audio -> packed binary subfingerprints, end to end
on device.

The pipeline (one fused jitted graph, batched over clips):

    windows -> DFT -> Q5 scaling -> band matmul -> [rows, 32]
    -> reshape to 128-row frames -> 2-D Haar (two matmuls)
    -> |coeff| top-k (rank order, stable tie-break) -> sign classes
    -> (pos, neg) {0,1} planes [n_sub, pairs]

This replaces the reference's per-window scalar hot loop and its NSNumber-boxed
sort (LBAudioDetective.m:262-290, LBAudioDetectiveFrame.m:165-191).  Static
shapes: clips are padded to a bucket length; the number of valid rows /
subfingerprints travels alongside as data (SURVEY §7 padding discipline).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.io.decode import DecodedAudio
from lbaudiodetective.ops import spectral
from lbaudiodetective.ops.haar import haar_2d


def subfingerprints_from_rows(rows: jnp.ndarray, config: FingerprintConfig
                              ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """``[..., n_rows, bands] -> (pos, neg)`` uint8 ``[..., n_sub, pairs]``.

    ``n_rows`` must be a multiple of ``rows_per_frame``.  Rank order is
    preserved: pos/neg column j corresponds to the j-th largest-|coefficient|
    (ties break toward the lower flat index).
    """
    *lead, n_rows, bands = rows.shape
    rpf = config.rows_per_frame
    n_sub = n_rows // rpf
    frames = rows.reshape(*lead, n_sub, rpf, bands)
    coeffs = haar_2d(frames, precision=config.precision)
    flat = coeffs.reshape(*lead, n_sub, rpf * bands)
    topcls = select_sign_classes(flat, config.num_wavelet_pairs)
    pos = (topcls == 1).astype(jnp.uint8)
    neg = (topcls == 2).astype(jnp.uint8)
    return pos, neg


def select_sign_classes(flat: jnp.ndarray, k: int) -> jnp.ndarray:
    """``[..., n] -> [..., k]`` uint8 sign classes (1 positive, 2 negative,
    0 zero or NaN) of the ``k`` largest-|x| entries, largest first, ties
    toward the lower index.

    Gather-free exact selection: stable-sort ascending on ~abs_bits (== |x|
    descending, index ties kept in reference order — the NSNumber sort in
    LBAudioDetectiveFrame.m:165-191 is index-stable) with the sign class as
    a payload.  Bit-identical to top_k(|x|) + take_along_axis.
    """
    n = flat.shape[-1]
    bits = jax.lax.bitcast_convert_type(flat, jnp.uint32)
    keys = ~(bits & jnp.uint32(0x7FFFFFFF))
    cls = ((flat > 0.0).astype(jnp.uint8) + 2 * (flat < 0.0).astype(jnp.uint8))
    nb = 8
    keep = min(n // nb, ((max(k, 128) + 127) // 128) * 128)
    if n % nb == 0 and n // nb >= keep >= k and n // nb >= 256:
        # Two-stage blocked sort: per-block stable sorts use much shorter
        # networks; keeping `keep` >= k per block still covers the global
        # top-k, and the stable merge keeps cross-block ties in index order
        # (blocks concatenated block-major), so the result is exact.
        bs = n // nb
        k2 = keys.reshape(*keys.shape[:-1], nb, bs)
        c2 = cls.reshape(*cls.shape[:-1], nb, bs)
        sk, sc = jax.lax.sort((k2, c2), dimension=-1, num_keys=1,
                              is_stable=True)
        keys = sk[..., :keep].reshape(*keys.shape[:-1], nb * keep)
        cls = sc[..., :keep].reshape(*cls.shape[:-1], nb * keep)
    _, topcls = jax.lax.sort((keys, cls), dimension=-1, num_keys=1,
                             is_stable=True)
    return topcls[..., :k]


def _rows_impl_auto(config: FingerprintConfig) -> str:
    """Pick the spectral-rows implementation from the config alone.

    - "conv": strided-convolution factorisation (no window
      materialisation) — every integer hop with interior bands.
    - "xla": window gather + matmul-DFT (or packed rfft when a band edge
      reaches bin 0) — fractional hops and low-frequency configs.
    """
    if config.has_integer_hop and spectral.bands_in_interior(config):
        return "conv"
    return "xla"


@partial(jax.jit, static_argnames=("config", "n_rows", "rows_impl"))
def extract_fingerprint_padded(audio: jnp.ndarray, n_valid_sub: jnp.ndarray,
                               config: FingerprintConfig, n_rows: int,
                               rows_impl: str = "auto"
                               ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Core jitted extraction over padded audio.

    audio: ``[..., T]`` float32, padded so the last window fits
           (``T >= floor((n_rows-1)*hop) + window``).
    n_valid_sub: ``[...]`` int32, number of valid subfingerprints per clip;
           trailing subfingerprints (computed from padding) are zeroed so
           downstream code may rely on zero padding.
    n_rows: static row count, a multiple of ``rows_per_frame``.
    rows_impl: "conv", "xla", or "auto" (:func:`_rows_impl_auto`).

    Returns (pos, neg) uint8 ``[..., n_sub, pairs]``.
    """
    if n_rows % config.rows_per_frame:
        raise ValueError("n_rows must be a multiple of rows_per_frame")
    impl = _rows_impl_auto(config) if rows_impl == "auto" else rows_impl
    if impl not in ("conv", "xla"):
        raise ValueError(f"unknown rows_impl {rows_impl!r}")
    if impl == "conv" and audio.ndim in (1, 2):
        batched = audio if audio.ndim == 2 else audio[None]
        rows = spectral.conv_band_rows(batched, config, n_rows)
        rows = rows if audio.ndim == 2 else rows[0]
    else:
        starts = spectral.window_starts(config, n_rows)
        windows = spectral.frame_windows(audio, starts, config.window_size)
        rows = spectral.band_energies(windows, config)
    pos, neg = subfingerprints_from_rows(rows, config)
    n_sub = n_rows // config.rows_per_frame
    valid = (jnp.arange(n_sub) < n_valid_sub[..., None]).astype(jnp.uint8)
    return pos * valid[..., None], neg * valid[..., None]


def required_padded_length(config: FingerprintConfig, n_rows: int) -> int:
    """Minimum audio length (processing samples) for a static row count."""
    if n_rows <= 0:
        return config.window_size
    starts = config.row_starts(n_rows)
    return int(starts[-1]) + config.window_size


def rows_for_subfingerprints(config: FingerprintConfig, n_sub: int) -> int:
    return n_sub * config.rows_per_frame


def bucket_subfingerprints(n_sub: int, granularity: int = 8) -> int:
    """Round a subfingerprint count up to a bucket size so variable-length
    clips share jit compilations (SURVEY §7: pad to bucket sizes).

    Granularity 8 bounds the padding waste of short clips (a 10 s
    'proc'-mode clip is ~7 subfingerprints: bucket 8, not 16)."""
    if n_sub <= 0:
        return 0
    return ((n_sub + granularity - 1) // granularity) * granularity


def extract_fingerprint(audio: DecodedAudio, config: FingerprintConfig | None = None,
                        n_sub_max: int | None = None
                        ) -> tuple[np.ndarray, np.ndarray, int]:
    """Convenience single-clip extraction: decoded audio -> (pos, neg, n_sub).

    Pads to the clip's own subfingerprint count (or ``n_sub_max`` for shape
    bucketing) and returns NumPy uint8 planes trimmed to valid length.
    """
    config = config or FingerprintConfig()
    n_sub = config.num_subfingerprints(audio.file_frames, audio.proc_frames)
    bucket = n_sub_max if n_sub_max is not None else bucket_subfingerprints(n_sub)
    if bucket == 0:
        pairs = config.num_wavelet_pairs
        return (np.zeros((0, pairs), np.uint8), np.zeros((0, pairs), np.uint8), 0)
    n_rows = rows_for_subfingerprints(config, bucket)
    t_pad = required_padded_length(config, n_rows)
    x = audio.samples
    if x.shape[0] < t_pad:
        x = np.concatenate([x, np.zeros(t_pad - x.shape[0], np.float32)])
    else:
        x = x[:t_pad]
    pos, neg = extract_fingerprint_padded(
        jnp.asarray(x), jnp.int32(n_sub), config, n_rows)
    return np.asarray(pos)[:n_sub], np.asarray(neg)[:n_sub], n_sub


def extract_fingerprint_batch(clips: list[DecodedAudio],
                              config: FingerprintConfig | None = None,
                              pad_batch_to: int = 0, n_sub_cap: int = 0
                              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched extraction: pads all clips to one bucket and runs a single
    dispatch.  Returns (pos, neg, n_sub) with shapes ``[B, S_max, pairs]`` /
    ``[B]``; invalid subfingerprints are zeroed.

    ``pad_batch_to``/``n_sub_cap`` pin the dispatch to STATIC shapes for
    serving: the batch axis zero-pads up to ``pad_batch_to`` clips and the
    subfingerprint bucket is fixed at ``bucket(n_sub_cap)`` regardless of
    batch composition, so every serving batch shares ONE jit compilation
    (a compile per new shape stalls the serving path).
    Clips longer than the cap are truncated to it — results for in-cap
    clips are bit-identical to the dynamic-bucket path.
    """
    config = config or FingerprintConfig()
    n_subs = np.array([config.num_subfingerprints(c.file_frames, c.proc_frames)
                       for c in clips], dtype=np.int32)
    if n_sub_cap:
        n_subs = np.minimum(n_subs, n_sub_cap)
        s_max = bucket_subfingerprints(n_sub_cap)
    else:
        s_max = bucket_subfingerprints(int(n_subs.max(initial=0)))
    b_out = len(clips)
    b_pad = max(b_out, pad_batch_to)
    if s_max == 0:
        pairs = config.num_wavelet_pairs
        return (np.zeros((b_out, 0, pairs), np.uint8),
                np.zeros((b_out, 0, pairs), np.uint8), n_subs)
    n_rows = rows_for_subfingerprints(config, s_max)
    t_pad = required_padded_length(config, n_rows)
    batch = np.zeros((b_pad, t_pad), dtype=np.float32)
    for i, c in enumerate(clips):
        t = min(c.samples.shape[0], t_pad)
        batch[i, :t] = c.samples[:t]
    n_subs_pad = np.zeros(b_pad, np.int32)
    n_subs_pad[:b_out] = n_subs
    pos, neg = extract_fingerprint_padded(
        jnp.asarray(batch), jnp.asarray(n_subs_pad), config, n_rows)
    return np.asarray(pos)[:b_out], np.asarray(neg)[:b_out], n_subs
