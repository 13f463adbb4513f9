"""Streaming runtime: incremental extraction must be bit-identical to the
offline extractor over the concatenated stream (SURVEY §4.5)."""

import numpy as np
import pytest

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.io.decode import DecodedAudio
from lbaudiodetective.ops.extract import extract_fingerprint
from lbaudiodetective.streaming.runtime import StreamingDetective, StreamingExtractor


def _offline_reference(audio_batch, cfg, n_rows_avail):
    """Offline bits for streams: synthesize file_frames so the offline row
    count equals the stream-available rows."""
    out = []
    for x in audio_batch:
        file_frames = n_rows_avail * cfg.analysis_stride + cfg.window_size
        d = DecodedAudio(samples=x, processing_rate=cfg.processing_sample_rate,
                         file_frames=file_frames, file_rate=cfg.file_sample_rate)
        pos, neg, n = extract_fingerprint(d, cfg)
        out.append((pos[:n], neg[:n]))
    return out


@pytest.mark.parametrize("hop_domain", ["file", "proc"])
def test_incremental_equals_offline(hop_domain):
    cfg = FingerprintConfig(hop_domain=hop_domain)
    batch, chunk = 3, 1024
    n_steps = 5
    total = chunk * n_steps
    rng = np.random.default_rng(30)
    audio = (rng.standard_normal((batch, total)) * 0.1).astype(np.float32)

    ext = StreamingExtractor(batch=batch, chunk_size=chunk, config=cfg)
    for s in range(n_steps):
        ext.feed(audio[:, s * chunk:(s + 1) * chunk])
    fps = ext.fingerprints()

    n_rows_avail = ext.rows_done
    refs = _offline_reference(audio, cfg, n_rows_avail)
    n_sub = n_rows_avail // cfg.rows_per_frame
    for b in range(batch):
        assert fps[b].num_subfingerprints == n_sub
        np.testing.assert_array_equal(fps[b].pos, refs[b][0][:n_sub],
                                      err_msg=f"stream {b} pos ({hop_domain})")
        np.testing.assert_array_equal(fps[b].neg, refs[b][1][:n_sub],
                                      err_msg=f"stream {b} neg ({hop_domain})")


def test_reset_clears_state():
    cfg = FingerprintConfig()
    ext = StreamingExtractor(batch=2, chunk_size=1024, config=cfg)
    rng = np.random.default_rng(31)
    a = (rng.standard_normal((2, 1024)) * 0.1).astype(np.float32)
    for _ in range(3):
        ext.feed(a)
    assert ext.rows_done > 0
    ext.reset()
    assert ext.rows_done == 0 and ext.total_samples == 0 and not ext.collected


def test_streaming_detective_lifecycle():
    cfg = FingerprintConfig()
    det = StreamingDetective(cfg, chunk_size=1024)
    done = []
    det.start_processing(max_subfingerprints=1, callback=done.append)
    rng = np.random.default_rng(32)
    # 1 subfingerprint needs 128 rows: ~128*8 + 2048 ~ 3072 samples in file
    # mode; 2048 samples cannot complete a frame yet.
    det.process_samples((rng.standard_normal(2048) * 0.1).astype(np.float32))
    assert not done
    det.pause_processing()
    det.process_samples(np.zeros(8192, np.float32))  # ignored while paused
    assert not done
    det.resume_processing()
    det.process_samples((rng.standard_normal(8192) * 0.1).astype(np.float32))
    assert len(done) == 1
    assert done[0].num_subfingerprints >= 1


def test_streaming_sharded_over_data_axis():
    """256-stream runtime with the stream axis sharded over an 8-device mesh:
    identical bits to the unsharded extractor, state stays sharded."""
    import jax
    from jax.sharding import Mesh

    from lbaudiodetective.config import FingerprintConfig
    from lbaudiodetective.streaming.runtime import StreamingExtractor

    cfg = FingerprintConfig(hop_domain="proc")
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    b, chunk, steps = 16, 1024, 8
    rng = np.random.default_rng(31)
    chunks = (rng.standard_normal((steps, b, chunk)) * 0.1).astype(np.float32)

    plain = StreamingExtractor(batch=b, chunk_size=chunk, config=cfg)
    sharded = StreamingExtractor(batch=b, chunk_size=chunk, config=cfg,
                                 mesh=mesh)
    for t in range(steps):
        plain.feed(chunks[t])
        sharded.feed(chunks[t])

    fp_a = plain.fingerprints()
    fp_b = sharded.fingerprints()
    assert all(a == b_ for a, b_ in zip(fp_a, fp_b))
    shardings = {str(d) for d in sharded.audio_ring.devices()}
    assert len(shardings) == 8, "stream state not spread over the mesh"


def test_feed_pcm16_matches_float_feed():
    """int16 PCM ingest must produce identical bits to float feed of the
    same samples (device-side conversion is exact: i16/32768 in f32)."""
    import numpy as np
    from lbaudiodetective.config import FingerprintConfig
    from lbaudiodetective.streaming.runtime import StreamingExtractor

    cfg = FingerprintConfig()
    rng = np.random.default_rng(9)
    chunk = cfg.rows_per_frame * int(cfg.hop_in_processing_samples)
    i16 = (rng.standard_normal((2, 6, chunk)) * 3276.8).astype(np.int16)
    f32 = i16.astype(np.float32) / 32768.0

    a = StreamingExtractor(batch=2, chunk_size=chunk, config=cfg)
    b = StreamingExtractor(batch=2, chunk_size=chunk, config=cfg)
    for s in range(6):
        a.feed(f32[:, s])
        b.feed_pcm16(i16[:, s])
    fa, fb = a.fingerprints(), b.fingerprints()
    assert fa == fb


@pytest.mark.parametrize("chunk", [512, 768])
def test_incremental_conv_path_non_aligned(chunk):
    """Parity-hop general path: a non-frame-aligned chunk routes through the
    strided-conv step (_stream_step_conv) and must stay bit-identical to
    offline (VERDICT r2 weakness 4: the old ring-gather path was the slow
    orphan; the new path must not change a single bit)."""
    cfg = FingerprintConfig()
    batch, n_steps = 2, 10
    total = chunk * n_steps
    rng = np.random.default_rng(31)
    audio = (rng.standard_normal((batch, total)) * 0.1).astype(np.float32)

    ext = StreamingExtractor(batch=batch, chunk_size=chunk, config=cfg)
    assert not ext.aligned and ext.use_conv
    for s in range(n_steps):
        ext.feed(audio[:, s * chunk:(s + 1) * chunk])
    fps = ext.fingerprints()
    refs = _offline_reference(audio, cfg, ext.rows_done)
    n_sub = ext.rows_done // cfg.rows_per_frame
    assert n_sub >= 1
    for b in range(batch):
        np.testing.assert_array_equal(fps[b].pos, refs[b][0][:n_sub])
        np.testing.assert_array_equal(fps[b].neg, refs[b][1][:n_sub])


def test_streaming_large_rows_per_frame_ring():
    """rows_per_frame > 128 sizes the rows ring up instead of silently
    corrupting (the r2 fixed 256-slot ring assumed rpf <= 128)."""
    cfg = FingerprintConfig(rows_per_frame=256, hop_domain="proc")
    chunk, n_steps = 2048, 12
    rng = np.random.default_rng(32)
    audio = (rng.standard_normal((1, chunk * n_steps)) * 0.1).astype(np.float32)
    ext = StreamingExtractor(batch=1, chunk_size=chunk, config=cfg)
    assert ext.ring_size >= cfg.rows_per_frame + ext.r_max
    for s in range(n_steps):
        ext.feed(audio[:, s * chunk:(s + 1) * chunk])
    fps = ext.fingerprints()
    refs = _offline_reference(audio, cfg, ext.rows_done)
    n_sub = ext.rows_done // cfg.rows_per_frame
    assert n_sub >= 1
    np.testing.assert_array_equal(fps[0].pos, refs[0][0][:n_sub])
    np.testing.assert_array_equal(fps[0].neg, refs[0][1][:n_sub])


def test_incremental_fractional_hop_fallback():
    """integer_hop=False (drift-faithful oracle mode) still streams through
    the mod-ring gather fallback, bit-identical to offline."""
    cfg = FingerprintConfig(integer_hop=False)
    chunk, n_steps = 1024, 6
    rng = np.random.default_rng(33)
    audio = (rng.standard_normal((1, chunk * n_steps)) * 0.1).astype(np.float32)
    ext = StreamingExtractor(batch=1, chunk_size=chunk, config=cfg)
    assert not ext.aligned and not ext.use_conv
    for s in range(n_steps):
        ext.feed(audio[:, s * chunk:(s + 1) * chunk])
    fps = ext.fingerprints()
    refs = _offline_reference(audio, cfg, ext.rows_done)
    n_sub = ext.rows_done // cfg.rows_per_frame
    assert n_sub >= 1
    np.testing.assert_array_equal(fps[0].pos, refs[0][0][:n_sub])
    np.testing.assert_array_equal(fps[0].neg, refs[0][1][:n_sub])
