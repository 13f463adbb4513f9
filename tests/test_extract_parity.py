"""JAX extraction vs golden oracle: bit-level and score-level parity
(SURVEY §4 'bit-exactness tests JAX vs NumPy oracle per clip')."""

import numpy as np

from lbaudiodetective.ops.extract import (
    extract_fingerprint, extract_fingerprint_batch)
from lbaudiodetective.ops.match import match_fingerprints
from lbaudiodetective.oracle.pipeline import oracle_match_fingerprints

CLIPS = ["BlackBird", "BlackBird_eql", "Wren_dif", "Crow_blu1", "Pigeon_rec"]


def test_bits_match_oracle(decoded_corpus, oracle_fingerprints, default_config):
    for name in CLIPS:
        pos, neg, n_sub = extract_fingerprint(decoded_corpus[name], default_config)
        opos, oneg = oracle_fingerprints[name]
        assert n_sub == opos.shape[0], name
        agreement = ((pos[:n_sub] == opos).mean() + (neg[:n_sub] == oneg).mean()) / 2
        # Backs the README claim: >=99.9% bits vs the golden oracle (not
        # bit-for-bit: the XLA conv-path summation order differs from the
        # oracle's scalar order at f32).
        assert agreement >= 0.999, f"{name}: bit agreement {agreement:.4f}"


def test_batch_extraction_matches_single(decoded_corpus, default_config):
    clips = [decoded_corpus[n] for n in CLIPS[:3]]
    bpos, bneg, n_subs = extract_fingerprint_batch(clips, default_config)
    for i, c in enumerate(clips):
        pos, neg, n = extract_fingerprint(c, default_config)
        assert n == n_subs[i]
        np.testing.assert_array_equal(bpos[i, :n], pos[:n])
        np.testing.assert_array_equal(bneg[i, :n], neg[:n])
    # Padding rows must be zeroed.
    for i in range(len(clips)):
        assert bpos[i, n_subs[i]:].sum() == 0
        assert bneg[i, n_subs[i]:].sum() == 0


def test_scores_match_oracle(decoded_corpus, oracle_fingerprints, default_config):
    pairs = [("BlackBird", "BlackBird_eql"), ("BlackBird", "Wren_dif")]
    for a, b in pairs:
        ja = extract_fingerprint(decoded_corpus[a], default_config)
        jb = extract_fingerprint(decoded_corpus[b], default_config)
        jax_score = match_fingerprints((ja[0][:ja[2]], ja[1][:ja[2]]),
                                       (jb[0][:jb[2]], jb[1][:jb[2]]))
        oracle_score = oracle_match_fingerprints(
            oracle_fingerprints[a], oracle_fingerprints[b])
        assert abs(jax_score - oracle_score) < 0.01, (a, b, jax_score, oracle_score)


def test_determinism(decoded_corpus, default_config):
    """Reference testFingerprintVersatility (Tests.m:119-139): repeated
    extraction must produce identical fingerprints."""
    a1 = extract_fingerprint(decoded_corpus["BlueTit"], default_config)
    a2 = extract_fingerprint(decoded_corpus["BlueTit"], default_config)
    np.testing.assert_array_equal(a1[0], a2[0])
    np.testing.assert_array_equal(a1[1], a2[1])


def test_pos_neg_mutually_exclusive(decoded_corpus, default_config):
    pos, neg, n = extract_fingerprint(decoded_corpus["Kestrel"], default_config)
    assert ((pos & neg) == 0).all()


def test_oracle_stale_tail_mode(default_config):
    """Q8 tail opt-in: the short-read cascade only perturbs the final
    windows (those past EOF), leaves everything before bit-identical, and is
    deterministic (CALIBRATION.md 'short-read stale-buffer tail')."""
    import numpy as np

    from lbaudiodetective.io.decode import DecodedAudio
    from lbaudiodetective.oracle.pipeline import spectrogram_rows

    cfg = default_config
    rng = np.random.default_rng(40)
    file_frames = 300_000                       # ~6.8 s at 44.1k
    proc = int(file_frames * cfg.processing_sample_rate / cfg.file_sample_rate)
    clip = DecodedAudio((rng.standard_normal(proc) * 0.1).astype(np.float32),
                        cfg.processing_sample_rate, file_frames,
                        cfg.file_sample_rate)
    base = spectrogram_rows(clip, cfg)
    tail = spectrogram_rows(clip, cfg, stale_tail=True)
    assert base.shape == tail.shape
    starts = cfg.row_starts(base.shape[0])
    first_short = int(np.searchsorted(starts + cfg.window_size, proc, "right"))
    assert first_short < base.shape[0]          # the clip does have a tail
    np.testing.assert_array_equal(base[:first_short], tail[:first_short])
    assert not np.array_equal(base[first_short:], tail[first_short:])
    tail2 = spectrogram_rows(clip, cfg, stale_tail=True)
    np.testing.assert_array_equal(tail, tail2)  # deterministic cascade

    # proc mode: no window runs past EOF -> flag is a no-op.
    cfg_p = cfg.with_updates(hop_domain="proc")
    np.testing.assert_array_equal(
        spectrogram_rows(clip, cfg_p),
        spectrogram_rows(clip, cfg_p, stale_tail=True))


def test_silence_extracts_all_zero_subfingerprints(default_config):
    """All-zero audio: every Haar coefficient is 0, so the reference emits
    NEITHER sign bit per wavelet (Frame.m:182-190 — zero sets neither pos
    nor neg); matching such a fingerprint scores 0 (no possible hits, Q10).
    Both the JAX path and the oracle must agree on this degenerate input."""
    import numpy as np

    from lbaudiodetective.io.decode import DecodedAudio
    from lbaudiodetective.ops.extract import extract_fingerprint
    from lbaudiodetective.ops.match import match_fingerprints

    rate = default_config.processing_sample_rate
    file_rate = default_config.file_sample_rate
    secs = 3.0
    d = DecodedAudio(np.zeros(int(secs * rate), np.float32), rate,
                     int(secs * file_rate), file_rate)
    pos, neg, n = extract_fingerprint(d, default_config)
    assert n > 0
    assert not np.asarray(pos[:n]).any() and not np.asarray(neg[:n]).any()
    score = match_fingerprints(
        (np.asarray(pos[:n]), np.asarray(neg[:n])),
        (np.asarray(pos[:n]), np.asarray(neg[:n])))
    assert score == 0.0            # Q10: zero possible hits -> 0
