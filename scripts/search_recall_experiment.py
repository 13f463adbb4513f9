"""Two-stage search recall measurement on planted near-duplicates.

VERDICT r3 weak #5 / next-round #4: the two-stage search
(models/library.py::search) is exact only when the true top-k survives the
coarse shortlist; this script measures shortlist-miss rate vs
(coarse_stride, coarse_range, shortlist, phases) on realistic
near-duplicate queries — the corpus' own crop/noise/mic-re-record variants
plus subfingerprint-offset crops and bit-flip re-encode analogs — planted
among random distractors.  Exactness bar: the reference's max over ALL
offsets (LBAudioDetectiveFingerprint.m:119-149).

Outputs a table + JSON artifact (scripts/search_recall_results.json);
the headline numbers live in CALIBRATION.md.

Run on CPU (backend-independent measurement; scores are exact integers of
the popcount path): PYTHONPATH=. python
scripts/search_recall_experiment.py
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

from lbaudiodetective.config import FingerprintConfig  # noqa: E402
from lbaudiodetective.models.detective import AudioDetective  # noqa: E402
from lbaudiodetective.models.fingerprint import Fingerprint  # noqa: E402
from lbaudiodetective.models.library import FingerprintLibrary  # noqa: E402

sys.path.insert(0, str(REPO / "tests"))
from conftest import BIRDS, corpus_path  # noqa: E402

L_TOTAL = 8192
MARGIN_STRONG = 0.02


def random_fp(rng, n, pairs=100):
    pos = np.zeros((n, pairs), np.uint8)
    neg = np.zeros((n, pairs), np.uint8)
    sign = rng.random((n, pairs)) < 0.5
    nz = rng.random((n, pairs)) > 0.03
    pos[sign & nz] = 1
    neg[(~sign) & nz] = 1
    return Fingerprint(pos, neg)


def build():
    det = AudioDetective()
    print("extracting corpus fingerprints...", flush=True)
    birds = [det.process_audio_file(corpus_path(b)) for b in BIRDS]
    rng = np.random.default_rng(23)
    lens = [f.num_subfingerprints for f in birds]
    distractors = [random_fp(rng, int(rng.integers(min(lens), max(lens) + 1)))
                   for _ in range(L_TOTAL - len(birds))]
    lib = FingerprintLibrary.from_fingerprints(birds + distractors,
                                               FingerprintConfig())

    queries = []
    for suffix in ("_eql", "_blu1", "_blu2", "_rec"):
        for t, b in enumerate(BIRDS):
            queries.append((b + suffix, t,
                            det.process_audio_file(corpus_path(b + suffix))))
    for t in range(10):
        fp = birds[t]
        for k in (1, 2, 3, 5):       # offset crops, all residues mod 4
            queries.append((f"{BIRDS[t]}_crop{k}", t,
                            Fingerprint(fp.pos[k:], fp.neg[k:])))
    for t in range(10):
        fp = birds[t]
        for p in (0.02, 0.05, 0.10):
            flips = rng.random(fp.pos.shape) < p
            pos = np.where(flips, 1 - fp.pos, fp.pos).astype(np.uint8)
            neg = (fp.neg * (1 - pos)).astype(np.uint8)
            queries.append((f"{BIRDS[t]}_flip{int(p*100)}", t,
                            Fingerprint(pos, neg)))
    return lib, queries


def evaluate(lib, queries, brute, *, shortlist, coarse_range, coarse_stride,
             coarse_phases):
    fps = [q for _, _, q in queries]
    idx = np.empty((len(fps), 5), np.int64)
    for s in range(0, len(fps), 16):             # bound vmap batch memory
        bi, _ = lib.search_many(fps[s:s + 16], top_k=5, shortlist=shortlist,
                                coarse_range=coarse_range,
                                coarse_stride=coarse_stride,
                                coarse_phases=coarse_phases)
        idx[s:s + len(bi)] = bi
    ident = ident_hit = strong = strong_hit = 0
    lost = []
    for i, (label, t, _) in enumerate(queries):
        floor = float(np.max(np.delete(brute[i], t)))
        is_ident = int(np.argmax(brute[i])) == t
        is_strong = brute[i][t] >= floor + MARGIN_STRONG
        hit = int(idx[i][0]) == t
        if is_ident:
            ident += 1
            ident_hit += hit
            if not hit:
                lost.append(label)
        if is_strong:
            strong += 1
            strong_hit += hit
    return dict(identifiable=ident, identifiable_found=ident_hit,
                strong=strong, strong_found=strong_hit, lost=lost)


def main():
    lib, queries = build()
    print(f"library {len(lib)} entries; {len(queries)} planted queries",
          flush=True)
    t0 = time.time()
    brute = np.empty((len(queries), len(lib)), np.float32)
    for s in range(0, len(queries), 16):
        brute[s:s + 16] = lib.match_many([q for _, _, q in queries[s:s + 16]])
    print(f"brute force done in {time.time() - t0:.0f}s", flush=True)

    n_ident = sum(int(np.argmax(brute[i])) == t
                  for i, (_, t, _) in enumerate(queries))
    print(f"brute-force identifiable: {n_ident}/{len(queries)}", flush=True)

    results = []
    configs = []
    # 1. shortlist sweep at shipped stride/range, robust vs phase-1 coarse.
    for sl in (128, 256, 512, 1024):
        for ph in (None, 1):
            configs.append(dict(shortlist=sl, coarse_range=64,
                                coarse_stride=4, coarse_phases=ph))
    # 2. coarse_range sweep.
    for cr in (32, 128, 200):
        configs.append(dict(shortlist=512, coarse_range=cr, coarse_stride=4,
                            coarse_phases=None))
    # 3. stride sweep.
    for st in (1, 2, 8):
        configs.append(dict(shortlist=512, coarse_range=64, coarse_stride=st,
                            coarse_phases=None))

    for cfg in configs:
        t0 = time.time()
        r = evaluate(lib, queries, brute, **cfg)
        r.update(cfg, seconds=round(time.time() - t0, 1))
        results.append(r)
        ph = "all" if cfg["coarse_phases"] is None else cfg["coarse_phases"]
        print(f"stride={cfg['coarse_stride']} range={cfg['coarse_range']:3d} "
              f"shortlist={cfg['shortlist']:4d} phases={ph:>3}: "
              f"identifiable {r['identifiable_found']}/{r['identifiable']}, "
              f"strong {r['strong_found']}/{r['strong']} "
              f"({r['seconds']}s) lost={r['lost']}", flush=True)

    out = {"library_size": len(lib), "n_queries": len(queries),
           "margin_strong": MARGIN_STRONG, "results": results}
    with open(REPO / "scripts" / "search_recall_results.json", "w") as f:
        json.dump(out, f, indent=2)
    print("wrote scripts/search_recall_results.json")


if __name__ == "__main__":
    main()
