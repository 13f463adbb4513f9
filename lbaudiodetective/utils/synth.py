"""Seeded bird-call-like audio for tests, smoke runs and benchmarks.

Each clip is a train of short harmonic chirps (a random start pitch in the
band the fingerprint analyses, a random sweep, 2-4 harmonics with falling
amplitude, a raised-cosine envelope) over low-level brown and white noise.
The same ``seed`` always gives the same clips, and different clips carry
different call trains, so each one identifies as its own track.
"""

from __future__ import annotations

import numpy as np


def bird_calls(seed: int, n_clips: int, seconds: float = 10.0,
               rate: float = 44100.0) -> np.ndarray:
    """``[n_clips, round(seconds * rate)]`` float32 clips in [-1, 1)."""
    rng = np.random.default_rng(seed)
    n = int(round(seconds * rate))
    out = np.empty((n_clips, n), np.float32)
    for c in range(n_clips):
        x = (0.01 * rng.standard_normal(n)).astype(np.float32)
        brown = np.cumsum(rng.standard_normal(n).astype(np.float32))
        x += 0.02 * (brown - brown.mean()) / (np.abs(brown).max() + 1e-6)
        t0 = rng.uniform(0.0, 0.3)
        while t0 < seconds:
            dur = rng.uniform(0.08, 0.45)
            a, b = int(t0 * rate), min(int((t0 + dur) * rate), n)
            if b - a > 16:
                t = np.arange(b - a, dtype=np.float64) / rate
                f0 = rng.uniform(900.0, 2400.0)
                sweep = rng.uniform(-3000.0, 3000.0)
                phase = 2.0 * np.pi * (f0 * t + 0.5 * sweep * t * t)
                env = np.sin(np.pi * t / t[-1]) ** 2
                call = np.zeros(b - a)
                for h in range(1, int(rng.integers(2, 5)) + 1):
                    call += rng.uniform(0.4, 1.0) / h * np.sin(h * phase)
                x[a:b] += (rng.uniform(0.15, 0.35) * env * call).astype(np.float32)
            t0 += dur + rng.uniform(0.05, 0.6)
        out[c] = np.clip(x, -1.0, 32767.0 / 32768.0)
    return out
