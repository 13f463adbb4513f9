"""Continuous streaming identification (the essay's Whistles app loop on
lockstep streams): streams of corpus clips must identify their own bird
against a corpus library, and the final streaming scores must equal the
offline identification of the same audio."""

import numpy as np
import pytest

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.models.fingerprint import Fingerprint
from lbaudiodetective.models.library import FingerprintLibrary
from lbaudiodetective.ops.match import match_one_vs_many_padded
from lbaudiodetective.streaming import StreamingIdentifier
from tests.conftest import BIRDS


@pytest.fixture(scope="module")
def corpus_lib(decoded_corpus, default_config):
    from lbaudiodetective.ops.extract import extract_fingerprint

    fps = []
    for b in BIRDS[:4]:
        pos, neg, n = extract_fingerprint(decoded_corpus[b], default_config)
        fps.append(Fingerprint.from_planes(np.asarray(pos[:n]),
                                           np.asarray(neg[:n])))
    return FingerprintLibrary.from_fingerprints(fps, default_config)


def test_streams_identify_their_bird(corpus_lib, decoded_corpus,
                                     default_config):
    cfg = default_config
    batch, chunk = 2, 1024
    # Stream two different birds' exact crops concurrently (BIRDS[3]
    # rather than BIRDS[2]: the shipped Chaffinch_eql is the known
    # re-exported anomaly scoring ~0.57, CALIBRATION.md).
    clips = [decoded_corpus[BIRDS[0] + "_eql"], decoded_corpus[BIRDS[3] + "_eql"]]
    total = min(c.samples.shape[0] for c in clips)
    n_steps = total // chunk
    audio = np.stack([c.samples[: n_steps * chunk] for c in clips])

    ident = StreamingIdentifier(corpus_lib, batch=batch, chunk_size=chunk,
                                config=cfg, match_every=2)
    interim_seen = False
    for s in range(n_steps):
        ident.feed(audio[:, s * chunk:(s + 1) * chunk])
        if ident.best()[0].track != -1:
            interim_seen = True
    results = ident.finalize()
    assert interim_seen                       # matches happen mid-stream
    assert results[0].track == 0              # BIRDS[0]
    assert results[1].track == 3              # BIRDS[3]
    assert results[0].score > 0.9
    assert results[1].score > 0.9

    # Final streaming scores == offline identification of the same audio
    # (the streaming extractor is bit-exact, so this must hold exactly).
    fps = ident.extractor.fingerprints()
    from lbaudiodetective.utils import packing

    lib_pos = packing.unpack_bits(np.asarray(corpus_lib.pos_words),
                                  corpus_lib.pairs)
    lib_neg = packing.unpack_bits(np.asarray(corpus_lib.neg_words),
                                  corpus_lib.pairs)
    for b, fp in enumerate(fps):
        s = max(fp.num_subfingerprints, lib_pos.shape[1])
        qp = np.zeros((s, fp.pairs), np.uint8)
        qn = np.zeros_like(qp)
        qp[: fp.num_subfingerprints] = fp.pos
        qn[: fp.num_subfingerprints] = fp.neg
        lp = np.zeros((len(corpus_lib), s, fp.pairs), np.uint8)
        ln = np.zeros_like(lp)
        lp[:, : lib_pos.shape[1]] = lib_pos
        ln[:, : lib_neg.shape[1]] = lib_neg
        ref = np.asarray(match_one_vs_many_padded(
            qp, qn, np.int32(fp.num_subfingerprints), lp, ln,
            np.asarray(corpus_lib.counts), 0, cfg.subfingerprint_length))
        assert results[b].track == int(ref.argmax())
        assert results[b].score == pytest.approx(float(ref.max()), abs=1e-6)


def test_stream_grouped_match_equals_ungrouped(corpus_lib, decoded_corpus,
                                               default_config):
    """match_stream_group chunks each identify tick's vmapped dispatch into
    fixed stream groups (what bounds the hit transient at 256 streams x 16k
    libraries); results must be identical to the single-dispatch path."""
    cfg = default_config
    batch, chunk = 4, 1024
    clips = [decoded_corpus[BIRDS[i % 4] + "_eql"] for i in range(batch)]
    total = min(c.samples.shape[0] for c in clips)
    n_steps = total // chunk
    audio = np.stack([c.samples[: n_steps * chunk] for c in clips])

    whole = StreamingIdentifier(corpus_lib, batch=batch, chunk_size=chunk,
                                config=cfg, match_every=2)
    grouped = StreamingIdentifier(corpus_lib, batch=batch, chunk_size=chunk,
                                  config=cfg, match_every=2,
                                  match_stream_group=2)
    for s in range(n_steps):
        whole.feed(audio[:, s * chunk:(s + 1) * chunk])
        grouped.feed(audio[:, s * chunk:(s + 1) * chunk])
    rw, rg = whole.finalize(), grouped.finalize()
    for a, b in zip(rw, rg):
        assert a.track == b.track
        assert a.score == pytest.approx(b.score, abs=1e-7)
        assert a.n_subfingerprints == b.n_subfingerprints
    with pytest.raises(ValueError):
        StreamingIdentifier(corpus_lib, batch=4, match_stream_group=3)


def test_streaming_identify_sharded_library(corpus_lib, decoded_corpus,
                                            default_config):
    """StreamingIdentifier over a mesh-sharded library: one collective
    match dispatch per tick, results identical to the single-device
    streaming identifier on the same streams."""
    import jax

    from lbaudiodetective.parallel.mesh import make_mesh
    from lbaudiodetective.parallel.sharded_library import (
        ShardedFingerprintLibrary)

    assert len(jax.devices()) == 8
    mesh = make_mesh(8, library_parallelism=4)
    slib = ShardedFingerprintLibrary(corpus_lib, mesh)

    cfg = default_config
    batch, chunk = 2, 1024
    clips = [decoded_corpus[BIRDS[0] + "_eql"], decoded_corpus[BIRDS[3] + "_eql"]]
    total = min(c.samples.shape[0] for c in clips)
    n_steps = total // chunk
    audio = np.stack([c.samples[: n_steps * chunk] for c in clips])

    plain = StreamingIdentifier(corpus_lib, batch=batch, chunk_size=chunk,
                                config=cfg, match_every=2)
    sharded = StreamingIdentifier(slib, batch=batch, chunk_size=chunk,
                                  config=cfg, match_every=2)
    for s in range(n_steps):
        plain.feed(audio[:, s * chunk:(s + 1) * chunk])
        sharded.feed(audio[:, s * chunk:(s + 1) * chunk])
    rp, rs = plain.finalize(), sharded.finalize()
    for a, b in zip(rp, rs):
        assert a.track == b.track
        assert a.score == pytest.approx(b.score, abs=1e-6)
        assert a.n_subfingerprints == b.n_subfingerprints
    assert rs[0].track == 0 and rs[1].track == 3
