"""Measure the corpus impact of the reference's short-read stale-buffer tail
(VERDICT r2 missing item 4; LBAudioDetective.m:252,275).

For every corpus clip, fingerprints are computed by the oracle with and
without ``stale_tail`` and all five 10x10 identification matrices are scored
both ways (vectorised matcher on oracle bits — same scores as the scalar
matcher).  Reports per-suite max |delta| in match points and any identified-
count changes.  Results go into CALIBRATION.md.

Run: python scripts/stale_tail_experiment.py   (CPU, ~minutes with warm
decode cache; forces the CPU backend)
"""
import pathlib
import sys

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.io.decode import decode_audio_file
from lbaudiodetective.oracle.pipeline import oracle_fingerprint
from lbaudiodetective.ops.match import match_fingerprints

BIRDS = ["BlackBird", "BlueTit", "Chaffinch", "Sparrow", "GreatTit",
         "Crow", "Wren", "Chiffchaff", "Kestrel", "Pigeon"]
SUFFIXES = ["_eql", "_dif", "_blu1", "_blu2", "_rec"]
CORPUS = pathlib.Path("/root/reference/LBAudioDetectiveTests/Birds")


def find(name):
    hits = list(CORPUS.rglob(f"{name}.caf"))
    assert hits, name
    return str(hits[0])


def main():
    cfg = FingerprintConfig()
    fps = {}
    for tail in (False, True):
        for b in BIRDS:
            names = [b] + [b + s for s in SUFFIXES]
            for n in names:
                if (n, tail) not in fps:
                    clip = decode_audio_file(find(n), cfg.processing_sample_rate)
                    fps[(n, tail)] = oracle_fingerprint(clip, cfg,
                                                        stale_tail=tail)
            print(f"fingerprinted {b} (stale_tail={tail})", flush=True)

    for suf in SUFFIXES:
        deltas = []
        ident = {False: 0, True: 0}
        flips = []
        for tail in (False, True):
            mat = np.zeros((10, 10))
            for i, orig in enumerate(BIRDS):
                for j, unk in enumerate(BIRDS):
                    mat[i, j] = match_fingerprints(
                        fps[(orig, tail)], fps[(unk + suf, tail)],
                        0, cfg.subfingerprint_length) * 100.0
            if tail:
                d = np.abs(mat - base)
                deltas = d
            else:
                base = mat
            ident[tail] = int(sum(np.argmax(mat[:, j]) == j for j in range(10)))
        print(f"{suf}: max |delta| {deltas.max():.3f} pts "
              f"(mean {deltas.mean():.3f}); identified "
              f"{ident[False]}/10 -> {ident[True]}/10"
              + ("  ** IDENT CHANGED **" if ident[False] != ident[True] else ""),
              flush=True)


if __name__ == "__main__":
    main()
