"""Pipelined decode->extract->match: results must equal the unpipelined path."""

import numpy as np
import jax.numpy as jnp

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.ops.extract import required_padded_length
from lbaudiodetective.ops.match import match_one_vs_many_padded
from lbaudiodetective.parallel.pipeline import PipelinedIdentifier
from tests.test_match import random_fp


def test_pipeline_matches_direct():
    cfg = FingerprintConfig()
    rng = np.random.default_rng(90)
    # Library of random fingerprints.
    l, s_lib = 6, 16
    lib = [random_fp(rng, int(n)) for n in rng.integers(4, s_lib + 1, size=l)]
    lib_pos = np.zeros((l, s_lib, 100), np.uint8)
    lib_neg = np.zeros((l, s_lib, 100), np.uint8)
    counts = np.zeros(l, np.int32)
    for i, (p, n) in enumerate(lib):
        counts[i] = p.shape[0]
        lib_pos[i, :p.shape[0]] = p
        lib_neg[i, :n.shape[0]] = n

    pipe = PipelinedIdentifier(lib_pos, lib_neg, counts, cfg)

    n_rows = cfg.rows_per_frame  # 1 subfingerprint per clip
    t_pad = required_padded_length(cfg, n_rows)
    batches = []
    for _ in range(3):
        audio = (rng.standard_normal((2, t_pad)) * 0.1).astype(np.float32)
        batches.append((audio, np.ones(2, np.int64)))

    results = list(pipe.run(batches))
    assert len(results) == 3
    for scores in results:
        assert scores.shape == (2, l)

    # Direct (unpipelined) reference for batch 0.
    pos, neg = pipe._extract(batches[0][0], batches[0][1])
    s = max(s_lib, pos.shape[1])
    direct = np.asarray(match_one_vs_many_padded(
        jnp.pad(pos[0], ((0, s - pos.shape[1]), (0, 0))),
        jnp.pad(neg[0], ((0, s - neg.shape[1]), (0, 0))),
        jnp.int32(1),
        jnp.pad(jnp.asarray(lib_pos), ((0, 0), (0, s - s_lib), (0, 0))),
        jnp.pad(jnp.asarray(lib_neg), ((0, 0), (0, s - s_lib), (0, 0))),
        jnp.asarray(counts), 0, cfg.subfingerprint_length))
    np.testing.assert_allclose(results[0][0], direct, atol=1e-6)


def test_device_split_pipeline_equals_fused():
    """PP with genuinely disjoint stage placement (VERDICT r2 'next' item 9):
    extraction data-parallel on devices[:4], matching library-sharded on
    devices[4:], handoff via device_put — results must equal the fused
    single-placement path, and every stage intermediate must live only on
    its own submesh."""
    import jax

    from lbaudiodetective.ops.extract import extract_fingerprint_padded
    from lbaudiodetective.parallel.pipeline import DeviceSplitPipeline

    devs = jax.devices()
    assert len(devs) == 8
    x_devs, m_devs = devs[:4], devs[4:]

    cfg = FingerprintConfig()
    rng = np.random.default_rng(91)
    l, s_lib = 8, 8
    lib = [random_fp(rng, int(n)) for n in rng.integers(3, s_lib + 1, size=l)]
    lib_pos = np.zeros((l, s_lib, 100), np.uint8)
    lib_neg = np.zeros((l, s_lib, 100), np.uint8)
    counts = np.zeros(l, np.int32)
    for i, (p, n) in enumerate(lib):
        counts[i] = p.shape[0]
        lib_pos[i, :p.shape[0]] = p
        lib_neg[i, :n.shape[0]] = n

    pipe = DeviceSplitPipeline(lib_pos, lib_neg, counts, x_devs, m_devs, cfg)
    assert set(pipe.lib_pos.sharding.device_set) == set(m_devs)

    n_rows = cfg.rows_per_frame
    t_pad = required_padded_length(cfg, n_rows)
    batches = [((rng.standard_normal((4, t_pad)) * 0.1).astype(np.float32),
                np.ones(4, np.int64)) for _ in range(3)]

    # Reference: fused single-placement extract+match.
    refs = []
    for audio, n_subs in batches:
        pos, neg = extract_fingerprint_padded(
            jnp.asarray(audio), jnp.asarray(n_subs.astype(np.int32)), cfg,
            n_rows)
        s = max(s_lib, pos.shape[1])
        posp = jnp.pad(pos, ((0, 0), (0, s - pos.shape[1]), (0, 0)))
        negp = jnp.pad(neg, ((0, 0), (0, s - neg.shape[1]), (0, 0)))
        lp = jnp.pad(jnp.asarray(lib_pos), ((0, 0), (0, s - s_lib), (0, 0)))
        ln = jnp.pad(jnp.asarray(lib_neg), ((0, 0), (0, s - s_lib), (0, 0)))
        scores = jax.vmap(match_one_vs_many_padded,
                          in_axes=(0, 0, 0, None, None, None, None, None))(
            posp, negp, jnp.asarray(n_subs.astype(np.int32)), lp, ln,
            jnp.asarray(counts), 0, cfg.subfingerprint_length)
        refs.append(np.asarray(scores))

    # Stage-placement check on the first batch's intermediates.
    pos0, neg0 = pipe._extract(*batches[0])
    assert set(pos0.sharding.device_set) <= set(x_devs)
    s0 = pipe._match(pos0, neg0, batches[0][1])
    assert set(s0.sharding.device_set) <= set(m_devs)

    outs = []
    for audio, n_subs in batches:
        out = pipe.submit(audio, n_subs)
        if out is not None:
            outs.append(out)
    outs.append(pipe.drain())
    assert len(outs) == 3
    for got, ref in zip(outs, refs):
        np.testing.assert_allclose(got, ref, atol=1e-6)
