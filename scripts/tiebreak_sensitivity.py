"""Q2 sort-tie sensitivity bound (completes the CALIBRATION attribution).

The reference ranks wavelet coefficients with an UNSTABLE NSArray sort
(LBAudioDetectiveFrame.m:165-191): coefficients with exactly equal |value|
can come out in any order, and which of them cross the top-``pairs``
selection boundary changes fingerprint bits.  CALIBRATION.md lists this
tie nondeterminism as one of the two live explanations (with the
stale-tail EOF cascade) for the residual diag-mean delta vs essay Fig. 24
after the SRC filter was refuted (scripts/src_filter_sensitivity.py,
0.21-pt spread).  This script BOUNDS it the same way: recompute the full
10x10 _eql identification matrix with the within-tie order randomised per
seed (a random secondary sort key — non-tied elements cannot move), and
report the spread of diag means across seeds.

The expensive spectral + Haar stages are tie-independent, so coefficients
are computed once per clip (oracle_frame_coeffs) and only the ranked-sign
selection reruns per seed.

Writes scripts/tiebreak_results.json; headline numbers in CALIBRATION.md.

Run (CPU): PYTHONPATH=. python
scripts/tiebreak_sensitivity.py
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

from conftest import BIRDS, corpus_path  # noqa: E402

from lbaudiodetective.config import FingerprintConfig  # noqa: E402
from lbaudiodetective.io.decode import decode_audio_file  # noqa: E402
from lbaudiodetective.ops.match import match_fingerprints  # noqa: E402
from lbaudiodetective.oracle.pipeline import (  # noqa: E402
    oracle_frame_coeffs, select_from_coeffs)

N_SEEDS = 6


def tie_stats(coeffs: np.ndarray, pairs: int) -> tuple[int, int]:
    """(#windows with a tie group crossing the selection boundary,
    #windows total) — how often tie order can change bits at all."""
    crossing = 0
    for s in range(coeffs.shape[0]):
        a = np.sort(np.abs(coeffs[s].reshape(-1)))[::-1]
        if pairs < a.size and a[pairs - 1] == a[pairs]:
            crossing += 1
    return crossing, coeffs.shape[0]


def main():
    cfg = FingerprintConfig()
    names = [b for b in BIRDS] + [b + "_eql" for b in BIRDS]
    print("computing tie-independent coefficient frames (once per clip)...",
          flush=True)
    coeffs = {}
    t0 = time.time()
    for n in names:
        coeffs[n] = oracle_frame_coeffs(decode_audio_file(corpus_path(n)),
                                        cfg)
        c, tot = tie_stats(coeffs[n], cfg.num_wavelet_pairs)
        print(f"  {n:20s} windows={tot:3d} boundary-tie windows={c:3d}",
              flush=True)
    print(f"coeffs in {time.time() - t0:.0f}s", flush=True)

    def matrix(tie_rng):
        fps = {n: select_from_coeffs(coeffs[n], cfg, tie_rng) for n in names}
        m = np.zeros((10, 10))
        for i, a in enumerate(BIRDS):
            for j, b in enumerate(BIRDS):
                m[i, j] = match_fingerprints(fps[a], fps[b + "_eql"]) * 100.0
        return m

    results = []
    for seed in range(-1, N_SEEDS):
        t0 = time.time()
        label = ("deterministic (shipped stable flat-index tie-break)"
                 if seed < 0 else f"random tie order, seed {seed}")
        m = matrix(None if seed < 0 else np.random.default_rng(seed))
        diag = np.diag(m)
        ident = int(sum(m[i, i] == m[i].max() for i in range(10)))
        mean_wo = float(np.delete(diag, 2).mean())  # Chaffinch anomaly out
        r = dict(variant=label, identified=ident,
                 diag_mean=float(diag.mean()),
                 diag_mean_wo_chaffinch=mean_wo,
                 diag_min=float(diag.min()), diag_max=float(diag.max()),
                 seconds=round(time.time() - t0, 1))
        results.append(r)
        print(f"{label:48s} ident={ident:2d}/10 diag mean={r['diag_mean']:5.1f}"
              f" (wo Chaffinch {mean_wo:5.1f})  ({r['seconds']}s)", flush=True)

    means = [r["diag_mean_wo_chaffinch"] for r in results]
    spread = max(means) - min(means)
    print(f"\ndiag-mean spread across tie orders (wo Chaffinch): "
          f"{spread:.2f} points", flush=True)
    out = {"n_seeds": N_SEEDS, "results": results,
           "diag_mean_spread": spread}
    with open(REPO / "scripts" / "tiebreak_results.json", "w") as f:
        json.dump(out, f, indent=2)
    print("wrote scripts/tiebreak_results.json")


if __name__ == "__main__":
    main()
