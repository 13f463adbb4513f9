"""The essay's Melody Analyzing Algorithm (MAA) — the AFA's rejected
predecessor, reimplemented in JAX for completeness.

The reference repository ships only the AFA; the MAA exists solely as the
essay's first algorithm (PDF §3.2.1.1 Listing 1, §3.2.3.1 Listing 3,
results §4.1.1 Figure 23: equality-count metric, 3/10 birds identified,
"without significant differences in equality" — which is why it was
rejected in favour of the AFA).  This module replicates that published
design so the framework covers both algorithms of the reference project:

- the signal is split into NON-overlapping windows of 512 sample frames at
  the file's native rate (no downsampling — the essay introduces
  downsampling only for the AFA, §3.2.1.2);
- each window is FFT'd; the spectrum is split into 5 frequency categories
  of 4,400 Hz each (the essay's example: "if the pitch is 3800Hz, the
  category ... would have a frequency range of 0Hz-4400Hz");
- per category, the frequency (pitch) with the highest magnitude is kept:
  one subfingerprint = 5 peak frequencies per window;
- matching a pair of subfingerprints sums the absolute frequency
  differences over the 5 categories (d = d1+..+d5) and declares a match
  when d < 400 (Listing 3); the fingerprint-level result is the NUMBER of
  matching subfingerprints — not a percentage (§4.1.1) — maximised over
  alignment offsets like the AFA's offset slide.

Where the essay's pseudocode is ambiguous (it elides the subtraction lines
and its loop header steps by 2 — an artefact shared with the AFA listing,
where the step-2 iterates bit PAIRS), this implementation compares every
aligned window and documents the choice; the corpus test pins the
resulting deterministic behaviour.

Device mapping: the window DFT runs as the same two-stage matmul
factorisation the AFA uses (:func:`ops.dft.rdft_bins` — window 512 =
16x32), the per-category peak is a masked argmax over static category
masks, and the offset slide is one skewed-index reduction.  MAA is a
documented predecessor, not a hot path: clarity over kernel fusion here.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from lbaudiodetective.ops.dft import rdft_bins
from lbaudiodetective.ops.match import banded_diagonal_sums

WINDOW = 512             # essay: "windows of 512 KB in size" (sample frames)
N_CATEGORIES = 5         # essay: "20kHz ... is split into 5 ranges"
CATEGORY_HZ = 4400.0     # essay example: 3800 Hz -> range 0 Hz - 4400 Hz
MATCH_THRESHOLD = 400.0  # essay Listing 3: "if (d < 400) match = YES"


@lru_cache(maxsize=16)
def _category_constants(window: int, sample_rate: float, n_categories: int,
                        category_hz: float):
    """Static per-bin frequency table and [n_categories, n_bins] masks.

    Bins run [1, window/2) — DC is not a pitch and the packed-FFT Nyquist
    slot is out of rdft_bins range; bins above the last category edge are
    masked out of every category.  NumPy out (lru_cache must not hold
    tracers).
    """
    ks = np.arange(1, window // 2)
    freqs = ks * (sample_rate / window)
    cat = np.floor(freqs / category_hz).astype(np.int64)
    masks = np.stack([(cat == c) for c in range(n_categories)])
    if not masks.any(axis=1).all():
        # An empty category's masked argmax would silently report bin 0 and
        # contribute d=0 to every comparison, inflating match counts; the
        # essay's design assumes the iPhone's 44.1 kHz pipeline populates
        # all 5 ranges.  Refuse the out-of-spec regime instead.
        raise ValueError(
            f"sample rate {sample_rate:g} Hz leaves a frequency category "
            f"empty ({n_categories} x {category_hz:g} Hz needs Nyquist >= "
            f"{(n_categories - 1) * category_hz:g} Hz); the MAA is specified "
            "for 44.1 kHz material")
    return freqs.astype(np.float32), masks


@partial(jax.jit, static_argnames=("sample_rate", "window", "n_categories",
                                   "category_hz"))
def maa_subfingerprints(samples: jnp.ndarray, sample_rate: float,
                        window: int = WINDOW,
                        n_categories: int = N_CATEGORIES,
                        category_hz: float = CATEGORY_HZ) -> jnp.ndarray:
    """``[..., T] float32 -> [..., T//window, n_categories]`` peak Hz.

    Essay §3.2.1.1 Listing 1: non-overlapping windows, FFT, per-category
    peak frequency.  The trailing partial window is dropped (reshape
    truncation), matching the listing's whole-window loop.
    """
    n_win = samples.shape[-1] // window
    if n_win < 1:
        raise ValueError(f"clip shorter than one {window}-frame window")
    frames = samples[..., : n_win * window].reshape(
        *samples.shape[:-1], n_win, window)
    re, im = rdft_bins(frames, 1, window // 2)
    mag = re * re + im * im                   # [..., n_win, n_bins]
    freqs_np, masks_np = _category_constants(window, float(sample_rate),
                                             n_categories, category_hz)
    freqs, masks = jnp.asarray(freqs_np), jnp.asarray(masks_np)
    # Masked argmax per category: out-of-category bins at -inf.  Ties take
    # the lowest bin (argmax first-occurrence), deterministically.
    scores = jnp.where(masks, mag[..., None, :], -jnp.inf)  # [..., cat, bins]
    peak_bin = jnp.argmax(scores, axis=-1)                  # [..., cat]
    return freqs[peak_bin]                                  # [..., cat] Hz


def _offset_match_counts(match: jnp.ndarray, n1: jnp.ndarray,
                         n2: jnp.ndarray) -> jnp.ndarray:
    """``counts[o] = sum_{j < n2} match[o+j, j]`` for valid o, else -1.

    match: ``[S1, S2]`` float32 in {0, 1}, rows/cols beyond n1/n2 zero.
    Reuses the AFA matcher's gather-free banded-diagonal reduction.
    """
    counts = banded_diagonal_sums(match, n2)
    o_valid = jnp.arange(match.shape[-2]) <= (n1 - n2)
    return jnp.where(o_valid, counts, -1.0)


@jax.jit
def _match_padded(f1, n1, f2, n2, threshold: float = MATCH_THRESHOLD):
    swap = n1 < n2
    f_l, f_s = jnp.where(swap, f2, f1), jnp.where(swap, f1, f2)
    n_l, n_s = jnp.where(swap, n2, n1), jnp.where(swap, n1, n2)
    d = jnp.abs(f_l[:, None, :] - f_s[None, :, :]).sum(-1)  # [S1, S2]
    valid = ((jnp.arange(f_l.shape[0])[:, None] < n_l)
             & (jnp.arange(f_s.shape[0])[None, :] < n_s))
    match = (d < threshold) & valid                          # Listing 3
    counts = _offset_match_counts(match.astype(jnp.float32), n_l, n_s)
    return jnp.maximum(jnp.max(counts), 0.0)


def maa_match_count(f1: np.ndarray, f2: np.ndarray,
                    threshold: float = MATCH_THRESHOLD) -> int:
    """Best number of matching subfingerprints over alignment offsets.

    Essay §3.2.3.1 + §4.1.1: the MAA reports a match COUNT ("the number of
    common frequencies"), not a percentage.  Shapes are padded to 128-window
    buckets so corpus sweeps reuse one compile per bucket pair.
    """
    f1, f2 = np.asarray(f1, np.float32), np.asarray(f2, np.float32)
    if f1.ndim != 2 or f2.ndim != 2 or f1.shape[1] != f2.shape[1]:
        raise ValueError("expected [n_windows, n_categories] inputs")
    # One common bucket so the jitted swap sees equal shapes.
    s = -(-max(f1.shape[0], f2.shape[0], 1) // 128) * 128

    def pad(a):
        return np.pad(a, ((0, s - a.shape[0]), (0, 0)))

    return int(_match_padded(jnp.asarray(pad(f1)), jnp.int32(f1.shape[0]),
                             jnp.asarray(pad(f2)), jnp.int32(f2.shape[0]),
                             threshold))


def maa_fingerprint_file(path: str) -> np.ndarray:
    """Decode (native rate, no resampling) and extract MAA subfingerprints."""
    from lbaudiodetective.io.decode import decode_audio_file_raw

    samples, rate = decode_audio_file_raw(path)
    return np.asarray(maa_subfingerprints(jnp.asarray(samples), float(rate)))


def maa_compare_audio_files(path1: str, path2: str,
                            threshold: float = MATCH_THRESHOLD) -> int:
    """End-to-end MAA pair comparison (the essay's Test-1 harness unit)."""
    return maa_match_count(maa_fingerprint_file(path1),
                           maa_fingerprint_file(path2), threshold)
