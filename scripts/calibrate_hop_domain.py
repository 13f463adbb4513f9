"""Q8 hop-domain calibration: reproduce the essay's Figure 24 (_eql matrix).

Runs the golden oracle over the Birds corpus in both hop-domain modes and
prints the 10x10 match matrices.  The mode whose diagonal reproduces the
published 92.7-98.9% scores (Wren highest at 98.9, 10/10 identified) becomes
the parity default in FingerprintConfig.
"""

import sys
import time

import numpy as np

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.io.decode import decode_audio_file
from lbaudiodetective.oracle.pipeline import oracle_fingerprint, oracle_match_fingerprints

BIRDS = ["BlackBird", "BlueTit", "Chaffinch", "Sparrow", "GreatTit",
         "Crow", "Wren", "Chiffchaff", "Kestrel", "Pigeon"]
CORPUS = "/root/reference/LBAudioDetectiveTests/Birds"

# Essay Fig. 24 diagonal (percent).
FIG24 = {"BlackBird": 93.3, "BlueTit": 92.9, "Chaffinch": 93.0, "Sparrow": 93.6,
         "GreatTit": 93.3, "Crow": 92.8, "Wren": 98.9, "Chiffchaff": 93.2,
         "Kestrel": 92.7, "Pigeon": 93.1}


def run(mode: str, suffix: str = "_eql", subdir: str = "Equal"):
    cfg = FingerprintConfig(hop_domain=mode)
    decoded = {}
    for b in BIRDS:
        decoded[b] = decode_audio_file(f"{CORPUS}/Archive/{b}.caf")
        decoded[b + suffix] = decode_audio_file(f"{CORPUS}/Cropped/{subdir}/{b}{suffix}.caf")
    fps = {}
    t0 = time.time()
    for name, audio in decoded.items():
        fps[name] = oracle_fingerprint(audio, cfg)
    t_fp = time.time() - t0
    matrix = np.zeros((10, 10))
    t0 = time.time()
    for i, orig in enumerate(BIRDS):
        for j, seq in enumerate(BIRDS):
            matrix[i, j] = oracle_match_fingerprints(fps[orig], fps[seq + suffix]) * 100.0
    t_match = time.time() - t0

    print(f"\n=== mode={mode} suffix={suffix}  (fp {t_fp:.1f}s, match {t_match:.1f}s) ===")
    print("          " + " ".join(f"{b[:7]:>7}" for b in BIRDS))
    identified = 0
    for i, orig in enumerate(BIRDS):
        row = " ".join(f"{matrix[i, j]:7.1f}" for j in range(10))
        diag_wins = matrix[i, i] == matrix[i].max()
        identified += diag_wins
        print(f"{orig[:9]:>9} {row}  {'OK' if diag_wins else 'MISS'}")
    diag = np.diag(matrix)
    fig24 = np.array([FIG24[b] for b in BIRDS])
    print(f"identified {identified}/10 | diag mean {diag.mean():.1f} (essay {fig24.mean():.1f}) "
          f"| max |diag-fig24| {np.abs(diag - fig24).max():.1f}")
    return matrix


if __name__ == "__main__":
    modes = sys.argv[1:] or ["proc", "file"]
    for mode in modes:
        run(mode)
