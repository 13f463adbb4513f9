"""Root-cause experiment for the Chaffinch_eql anomaly (CALIBRATION.md).

The shipped `Chaffinch_eql.caf` scores ~57 vs the essay's published 93.0
(Fig. 24).  This script proves, from the mounted corpus alone, that the
shipped file is a different generation of the audio than the essay measured
and that the reference implementation itself would also score ~57 on it:

  1. byte-exactness of every `_eql` crop vs its archive prefix (9/10 exact,
     Chaffinch alone differs with residual RMS 0.014 = 11.6% of signal RMS);
  2. the residual's per-octave spectral shape (in-band content at
     500-1000 Hz with ~5.9x the signal power there; NOT broadband noise);
  3. quirk-faithful oracle scores for controlled perturbations of the true
     archive prefix: bit-exact crop ~96.6, IMA4 re-encode ~67, 0.5-sample
     shift ~65, 1.58% uniform noise ~58 — the last matching the essay's own
     Fig. 26 value for Chaffinch+1.58% noise (57.1), the same class and
     magnitude as the shipped file's perturbation (which scores 56.6).

Run: PYTHONPATH=/root/repo python scripts/chaffinch_experiment.py
Runtime: ~1 min on CPU.
"""

import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from lbaudiodetective.io import caf
from lbaudiodetective.io.decode import DecodedAudio, decode_audio_file
from lbaudiodetective.io.resample import resample_rational
from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.oracle.pipeline import (
    oracle_fingerprint, oracle_match_fingerprints)

BASE = pathlib.Path("/root/reference/LBAudioDetectiveTests/Birds")
BIRDS = ["BlackBird", "BlueTit", "Chaffinch", "Sparrow", "GreatTit",
         "Crow", "Wren", "Chiffchaff", "Kestrel", "Pigeon"]


def ima4_reencode(x: np.ndarray) -> np.ndarray:
    """One IMA4 encode->decode generation (standard IMA ADPCM quantiser)."""
    idx_t, step_t = caf.IMA_INDEX_TABLE, caf.IMA_STEP_TABLE
    x16 = np.clip(np.round(np.asarray(x) * 32768.0), -32768, 32767).astype(np.int64)
    pred, index = 0, 0
    out = np.zeros(len(x16), np.float32)
    for i, s in enumerate(x16):
        step = step_t[index]
        diff = int(s) - pred
        nib = 0
        if diff < 0:
            nib, diff = 8, -diff
        d = step >> 3
        if diff >= step:
            nib |= 4
            diff -= step
        if diff >= step >> 1:
            nib |= 2
            diff -= step >> 1
        if diff >= step >> 2:
            nib |= 1
            diff -= step >> 2
        d += ((step if nib & 4 else 0) + ((step >> 1) if nib & 2 else 0)
              + ((step >> 2) if nib & 1 else 0))
        pred += -d if nib & 8 else d
        pred = max(-32768, min(32767, pred))
        index = max(0, min(88, index + idx_t[nib & 7]))
        out[i] = pred / 32768.0
    return out


def as_decoded(x44: np.ndarray, file_frames: int) -> DecodedAudio:
    proc = resample_rational(np.asarray(x44, np.float32), 44100.0, 5512.0)
    return DecodedAudio(np.asarray(proc, np.float32), 5512.0, file_frames, 44100.0)


def main() -> None:
    print("== 1. byte-exactness of _eql crops vs archive prefix (44.1 kHz) ==")
    for b in BIRDS:
        a, _ = caf.read_caf(str(BASE / "Archive" / f"{b}.caf"))
        e, _ = caf.read_caf(str(BASE / "Cropped/Equal" / f"{b}_eql.caf"))
        n = len(e)
        res = np.asarray(a[:n], np.float64) - np.asarray(e, np.float64)
        print(f"  {b:10s} exact={bool(np.array_equal(a[:n], e))!s:5s} "
              f"res_rms={np.sqrt((res ** 2).mean()):.6f}")

    a44, _ = caf.read_caf(str(BASE / "Archive" / "Chaffinch.caf"))
    e44, _ = caf.read_caf(str(BASE / "Cropped/Equal" / "Chaffinch_eql.caf"))
    a44 = np.asarray(a44, np.float64)
    e44 = np.asarray(e44, np.float64)
    n = len(e44)
    pre = a44[:n]

    print("\n== 2. residual spectral shape (res/sig power per band) ==")
    res = e44 - pre
    spec_r = np.abs(np.fft.rfft(res)) ** 2
    spec_s = np.abs(np.fft.rfft(pre)) ** 2
    fr = np.fft.rfftfreq(n, 1 / 44100)
    for lo, hi in zip([0, 500, 1000, 2000, 4000, 8000],
                      [500, 1000, 2000, 4000, 8000, 22050]):
        m = (fr >= lo) & (fr < hi)
        print(f"  {lo:5d}-{hi:5d} Hz: {spec_r[m].sum() / max(spec_s[m].sum(), 1e-12):8.4f}")

    print("\n== 3. quirk-faithful oracle scores, archive vs perturbed prefix ==")
    cfg = FingerprintConfig()
    arch = decode_audio_file(str(BASE / "Archive" / "Chaffinch.caf"))
    eql = decode_audio_file(str(BASE / "Cropped/Equal" / "Chaffinch_eql.caf"))
    fa = oracle_fingerprint(arch, cfg)

    def score(d: DecodedAudio) -> float:
        return oracle_match_fingerprints(fa, oracle_fingerprint(d, cfg),
                                         0, cfg.subfingerprint_length) * 100

    print(f"  shipped Chaffinch_eql.caf : {score(eql):5.1f}   (essay claims 93.0)")
    print(f"  bit-exact prefix crop     : {score(as_decoded(pre, n)):5.1f}   (in essay's 93-99 range)")
    print(f"  IMA4 re-encode generation : {score(as_decoded(ima4_reencode(pre), n)):5.1f}")
    spec = np.fft.rfft(pre)
    shifted = np.fft.irfft(spec * np.exp(-2j * np.pi * np.fft.rfftfreq(n) * 0.5), n)
    print(f"  0.5-sample shifted prefix : {score(as_decoded(shifted, n)):5.1f}")
    rng = np.random.default_rng(1)
    noisy = pre + rng.uniform(-0.0158, 0.0158, n)
    print(f"  +1.58% uniform noise      : {score(as_decoded(noisy, n)):5.1f}   (essay Fig.26 Chaffinch: 57.1)")

    print("\nConclusion: the shipped Chaffinch_eql is a re-exported generation "
          "with in-band content\ndifferences; the 2013 implementation's own "
          "noise curve places this perturbation at ~57.")


if __name__ == "__main__":
    main()
