"""Serving edge (essay "Whistles" server analog): HTTP identify/fingerprint
round trip against a real corpus library."""

import http.client
import json
import threading

import numpy as np
import pytest

from lbaudiodetective.config import FingerprintConfig
from lbaudiodetective.models.fingerprint import Fingerprint
from lbaudiodetective.models.library import FingerprintLibrary
from lbaudiodetective.serving import IdentificationService, make_server
from tests.conftest import BIRDS, corpus_path


@pytest.fixture(scope="module")
def service(decoded_corpus, default_config):
    from lbaudiodetective.ops.extract import extract_fingerprint

    fps = []
    for b in BIRDS[:4]:
        pos, neg, n = extract_fingerprint(decoded_corpus[b], default_config)
        fps.append(Fingerprint.from_planes(np.asarray(pos[:n]),
                                           np.asarray(neg[:n])))
    lib = FingerprintLibrary.from_fingerprints(fps, default_config)
    return IdentificationService(lib, BIRDS[:4], default_config)


@pytest.fixture(scope="module")
def server(service):
    srv = make_server(service)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()


def _post(server, path, payload):
    conn = http.client.HTTPConnection(*server.server_address)
    conn.request("POST", path, body=payload)
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def test_healthz(server):
    conn = http.client.HTTPConnection(*server.server_address)
    conn.request("GET", "/healthz")
    resp = conn.getresponse()
    assert resp.status == 200
    body = json.loads(resp.read())
    assert body == {"ok": True, "tracks": 4}


def test_identify_corpus_clip(server):
    payload = open(corpus_path("BlueTit_eql"), "rb").read()
    status, body = _post(server, "/identify", payload)
    assert status == 200
    assert body["track"] == "BlueTit"
    assert body["score"] > 0.9
    assert set(body["scores"]) == set(BIRDS[:4])


def test_fingerprint_endpoint(server):
    payload = open(corpus_path("Crow_eql"), "rb").read()
    status, body = _post(server, "/fingerprint", payload)
    assert status == 200
    assert body["n"] > 0
    fp = Fingerprint.from_string(body["fingerprint"])
    assert fp.num_subfingerprints == body["n"]


def test_garbage_payload_is_4xx(server):
    status, body = _post(server, "/identify", b"this is not audio at all")
    assert status == 400
    assert "error" in body and body.get("status") is not None


def test_unknown_path_404(server):
    status, _ = _post(server, "/nope", b"")
    assert status == 404


def test_microbatched_identify_equals_unbatched(decoded_corpus, default_config):
    """Concurrent identify requests inside the batch window must be served
    from ONE extraction dispatch with results identical to the unbatched
    path."""
    from lbaudiodetective.ops.extract import extract_fingerprint

    fps = []
    for b in BIRDS[:4]:
        pos, neg, n = extract_fingerprint(decoded_corpus[b], default_config)
        fps.append(Fingerprint.from_planes(np.asarray(pos[:n]),
                                           np.asarray(neg[:n])))
    lib = FingerprintLibrary.from_fingerprints(fps, default_config)
    plain = IdentificationService(lib, BIRDS[:4], default_config)
    batched = IdentificationService(lib, BIRDS[:4], default_config,
                                    batch_window_s=1.0, max_batch=4)

    payloads = [open(corpus_path(b + "_eql"), "rb").read() for b in BIRDS[:4]]
    expected = [plain.identify(p) for p in payloads]

    results = [None] * 4
    errs = []

    def worker(i):
        try:
            results[i] = batched.identify(payloads[i])
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs
    assert batched.extract_dispatches == 1      # one fused device dispatch
    for got, exp in zip(results, expected):
        assert got["track"] == exp["track"]
        for name in exp["scores"]:
            assert got["scores"][name] == pytest.approx(exp["scores"][name],
                                                        abs=1e-6)


def test_microbatched_identify_single_request(decoded_corpus, default_config):
    """A lone request inside the window still completes (leader timeout)."""
    from lbaudiodetective.ops.extract import extract_fingerprint

    pos, neg, n = extract_fingerprint(decoded_corpus[BIRDS[0]], default_config)
    lib = FingerprintLibrary.from_fingerprints(
        [Fingerprint.from_planes(np.asarray(pos[:n]), np.asarray(neg[:n]))],
        default_config)
    svc = IdentificationService(lib, BIRDS[:1], default_config,
                                batch_window_s=0.05, max_batch=8)
    out = svc.identify(open(corpus_path(BIRDS[0]), "rb").read())
    assert out["track"] == BIRDS[0]
    assert out["score"] == pytest.approx(1.0)


def test_microbatch_overflow_and_failure_isolation(decoded_corpus,
                                                   default_config):
    """A burst larger than max_batch is processed in max_batch chunks (no
    follower hangs), and a failing clip fails only its own request."""
    from lbaudiodetective.ops.extract import extract_fingerprint

    pos, neg, n = extract_fingerprint(decoded_corpus[BIRDS[0]], default_config)
    lib = FingerprintLibrary.from_fingerprints(
        [Fingerprint.from_planes(np.asarray(pos[:n]), np.asarray(neg[:n]))],
        default_config)
    svc = IdentificationService(lib, BIRDS[:1], default_config,
                                batch_window_s=0.5, max_batch=2)
    good = open(corpus_path(BIRDS[0] + "_eql"), "rb").read()
    payloads = [good] * 5
    results, errors = [None] * 5, [None] * 5

    def worker(i):
        try:
            results[i] = svc.identify(payloads[i])
        except Exception as e:  # noqa: BLE001
            errors[i] = e

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(e is None for e in errors)
    assert all(r is not None and r["track"] == BIRDS[0] for r in results)

    # Per-entry failure isolation: a clip too short to fingerprint in the
    # same window as valid ones fails only itself (DecodeError), while the
    # valid requests succeed.
    import struct

    from lbaudiodetective.io.wav import write_wav
    import tempfile, pathlib, os

    tiny = np.zeros(64, np.float32)
    tmp = tempfile.mkdtemp()
    tiny_path = str(pathlib.Path(tmp) / "tiny.wav")
    write_wav(tiny_path, tiny, 44100.0)
    tiny_payload = open(tiny_path, "rb").read()

    mixed = [good, tiny_payload, good]
    results2, errors2 = [None] * 3, [None] * 3

    def worker2(i):
        try:
            results2[i] = svc.identify(mixed[i])
        except Exception as e:  # noqa: BLE001
            errors2[i] = e

    threads = [threading.Thread(target=worker2, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert results2[0] is not None and results2[2] is not None
    assert errors2[0] is None and errors2[2] is None
    assert errors2[1] is not None            # only the tiny clip fails


def test_http_identify_with_batching(decoded_corpus, default_config):
    """Socket-level: concurrent HTTP identify requests through the
    micro-batcher return correct per-request results."""
    import http.client

    from lbaudiodetective.ops.extract import extract_fingerprint
    from lbaudiodetective.serving import make_server

    fps = []
    for b in BIRDS[:3]:
        pos, neg, n = extract_fingerprint(decoded_corpus[b], default_config)
        fps.append(Fingerprint.from_planes(np.asarray(pos[:n]),
                                           np.asarray(neg[:n])))
    lib = FingerprintLibrary.from_fingerprints(fps, default_config)
    svc = IdentificationService(lib, BIRDS[:3], default_config,
                                batch_window_s=0.5, max_batch=3)
    srv = make_server(svc)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        host, port = srv.server_address[:2]
        payloads = {b: open(corpus_path(b + "_eql"), "rb").read()
                    for b in BIRDS[:3]}
        results = {}

        def post(bird):
            conn = http.client.HTTPConnection(host, port, timeout=120)
            conn.request("POST", "/identify", body=payloads[bird])
            resp = conn.getresponse()
            results[bird] = (resp.status, json.loads(resp.read()))
            conn.close()

        ts = [threading.Thread(target=post, args=(b,)) for b in BIRDS[:3]]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=180)
        assert set(results) == set(BIRDS[:3])
        for b, (status, body) in results.items():
            assert status == 200
            assert body["track"] == b
    finally:
        srv.shutdown()


def test_search_mode_topk_responses(decoded_corpus, default_config):
    """Above search_threshold the service answers with exact top-k via the
    two-stage search: same winner/score as brute force, 'top' list instead
    of the full per-track scores dict — in both the unbatched and the
    micro-batched paths."""
    from lbaudiodetective.ops.extract import extract_fingerprint

    fps = []
    for b in BIRDS[:4]:
        pos, neg, n = extract_fingerprint(decoded_corpus[b], default_config)
        fps.append(Fingerprint.from_planes(np.asarray(pos[:n]),
                                           np.asarray(neg[:n])))
    lib = FingerprintLibrary.from_fingerprints(fps, default_config)
    brute = IdentificationService(lib, BIRDS[:4], default_config)
    searched = IdentificationService(lib, BIRDS[:4], default_config,
                                     search_threshold=2, top_k=3)
    payload = open(corpus_path(BIRDS[1] + "_eql"), "rb").read()
    exp = brute.identify(payload)
    got = searched.identify(payload)
    assert "scores" not in got and len(got["top"]) == 3
    assert got["track"] == exp["track"]
    assert got["score"] == pytest.approx(exp["score"], abs=1e-6)
    tops = [t["score"] for t in got["top"]]
    assert tops == sorted(tops, reverse=True)

    batched = IdentificationService(lib, BIRDS[:4], default_config,
                                    batch_window_s=1.0, max_batch=2,
                                    search_threshold=2, top_k=3)
    payloads = [open(corpus_path(b + "_eql"), "rb").read() for b in BIRDS[:2]]
    results = [None] * 2
    errs = []

    def worker(i):
        try:
            results[i] = batched.identify(payloads[i])
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs
    for i, b in enumerate(BIRDS[:2]):
        assert results[i]["track"] == b
        assert "top" in results[i] and "scores" not in results[i]


def test_static_shape_batching_identical(decoded_corpus, default_config):
    """n_sub_cap pins every batched extraction to one static shape (batch
    padded to max_batch, fixed subfingerprint bucket): responses must be
    identical to the dynamic-shape batched path for in-cap clips."""
    from lbaudiodetective.ops.extract import (extract_fingerprint,
                                              extract_fingerprint_batch)

    fps = []
    for b in BIRDS[:4]:
        pos, neg, n = extract_fingerprint(decoded_corpus[b], default_config)
        fps.append(Fingerprint.from_planes(np.asarray(pos[:n]),
                                           np.asarray(neg[:n])))
    lib = FingerprintLibrary.from_fingerprints(fps, default_config)
    plain = IdentificationService(lib, BIRDS[:4], default_config)
    capped = IdentificationService(lib, BIRDS[:4], default_config,
                                   batch_window_s=1.0, max_batch=4,
                                   n_sub_cap=64)

    payloads = [open(corpus_path(b + "_eql"), "rb").read() for b in BIRDS[:3]]
    expected = [plain.identify(p) for p in payloads]
    results = [None] * 3
    errs = []

    def worker(i):
        try:
            results[i] = capped.identify(payloads[i])
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs
    assert capped.extract_dispatches == 1
    for got, exp in zip(results, expected):
        assert got["track"] == exp["track"]
        for name in exp["scores"]:
            assert got["scores"][name] == pytest.approx(exp["scores"][name],
                                                        abs=1e-6)


def test_extract_batch_static_shapes_bitexact(decoded_corpus, default_config):
    """extract_fingerprint_batch(pad_batch_to, n_sub_cap): identical planes
    for in-cap clips; clips over the cap truncate to exactly the capped
    prefix of their dynamic extraction."""
    from lbaudiodetective.ops.extract import extract_fingerprint_batch

    clips = [decoded_corpus[b] for b in BIRDS[:3]]
    pos_d, neg_d, n_d = extract_fingerprint_batch(clips, default_config)
    pos_s, neg_s, n_s = extract_fingerprint_batch(
        clips, default_config, pad_batch_to=8, n_sub_cap=64)
    assert pos_s.shape[0] == 3                  # padding trimmed from output
    np.testing.assert_array_equal(n_s, n_d)
    for i in range(3):
        n = int(n_d[i])
        np.testing.assert_array_equal(pos_s[i, :n], pos_d[i, :n])
        np.testing.assert_array_equal(neg_s[i, :n], neg_d[i, :n])
    # Cap below a clip's natural length: truncation, not corruption.
    cap = max(1, int(n_d[0]) - 1)
    pos_t, neg_t, n_t = extract_fingerprint_batch(
        [clips[0]], default_config, n_sub_cap=cap)
    assert int(n_t[0]) == cap
    np.testing.assert_array_equal(pos_t[0, :cap], pos_d[0, :cap])


def test_serving_soak_mixed_load(decoded_corpus, default_config):
    """Soak the micro-batched service with interleaved valid and garbage
    payloads from many threads: every request completes (result or typed
    error), batches never strand a follower, and the pending queue drains."""
    from lbaudiodetective.ops.extract import extract_fingerprint
    from lbaudiodetective import errors

    fps = []
    for b in BIRDS[:3]:
        pos, neg, n = extract_fingerprint(decoded_corpus[b], default_config)
        fps.append(Fingerprint.from_planes(np.asarray(pos[:n]),
                                           np.asarray(neg[:n])))
    lib = FingerprintLibrary.from_fingerprints(fps, default_config)
    svc = IdentificationService(lib, BIRDS[:3], default_config,
                                batch_window_s=0.1, max_batch=3, n_sub_cap=64)
    good = open(corpus_path(BIRDS[0] + "_eql"), "rb").read()
    bad = b"caff" + b"\x00" * 64                 # parses as CAF, no chunks
    outcomes = [None] * 24

    def worker(i):
        try:
            outcomes[i] = svc.identify(good if i % 3 else bad)
        except errors.AudioDetectiveError:
            outcomes[i] = "typed-error"
        except Exception as e:  # noqa: BLE001
            outcomes[i] = f"UNTYPED:{type(e).__name__}"

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads)
    assert svc._pending == []                    # queue fully drained
    for i, o in enumerate(outcomes):
        if i % 3:
            assert o["track"] == BIRDS[0], o
        else:
            assert o == "typed-error", o


def test_identify_fingerprint_endpoint(server):
    """The essay's protocol (PDF §3.2.5): upload the fingerprint STRING,
    the server only matches — response equals the audio-upload path."""
    payload = open(corpus_path("BlueTit_eql"), "rb").read()
    _, via_audio = _post(server, "/identify", payload)
    _, fp_body = _post(server, "/fingerprint", payload)
    status, body = _post(server, "/identify-fingerprint",
                         fp_body["fingerprint"].encode())
    assert status == 200
    assert body["track"] == "BlueTit" and body["score"] > 0.9
    assert body["scores"] == pytest.approx(via_audio["scores"])


def test_identify_fingerprint_rejects_bad_payloads(server):
    # The last two are CONSISTENT '01+' strings of the wrong
    # per-subfingerprint length: they parse fine but mismatch the server
    # config's pair count — must be a 400 at the edge, not an opaque 500
    # from deep inside the packed matcher.
    wrong_len = ("01" * 64 + "+" + "01" * 64).encode()
    for bad in (b"\xff\xfebinary", b"01x10", b"0101+01", b"", b"0101",
                wrong_len):
        status, body = _post(server, "/identify-fingerprint", bad)
        assert status == 400, bad
        assert "error" in body


def test_stream_session_incremental_identify(server):
    """Live-recognition sessions: posting a fingerprint in increments must
    converge on the right track, the final running score must EXACTLY
    equal the one-shot /identify-fingerprint score of the whole string,
    and close frees the session."""
    payload = open(corpus_path("BlueTit_eql"), "rb").read()
    _, fp_body = _post(server, "/fingerprint", payload)
    _, oneshot = _post(server, "/identify-fingerprint",
                       fp_body["fingerprint"].encode())
    subs = fp_body["fingerprint"].split("+")

    status, body = _post(server, "/stream/open", b"")
    assert status == 200
    sid = body["session"]

    # Post in uneven increments (3, 1, 7, rest...).
    cuts, i = [3, 1, 7], 0
    n_seen = 0
    while i < len(subs):
        k = cuts.pop(0) if cuts else len(subs) - i
        status, body = _post(server, f"/stream/{sid}",
                             "+".join(subs[i:i + k]).encode())
        assert status == 200
        i += k
        n_seen = body["n"]
        assert n_seen == i
    assert body["track"] == "BlueTit"
    assert body["score"] == pytest.approx(oneshot["score"], abs=1e-7)
    top_tracks = {t["track"]: t["score"] for t in body["top"]}
    for name, s in top_tracks.items():
        assert s == pytest.approx(oneshot["scores"][name], abs=1e-7)

    # Empty post = heartbeat: state unchanged.
    status, beat = _post(server, f"/stream/{sid}", b"")
    assert status == 200 and beat["n"] == n_seen

    # GET peek returns the same running result without posting.
    conn = http.client.HTTPConnection(*server.server_address)
    conn.request("GET", f"/stream/{sid}")
    resp = conn.getresponse()
    peek = json.loads(resp.read())
    assert resp.status == 200 and peek == beat
    conn.request("GET", "/stream/doesnotexist")
    resp = conn.getresponse()
    assert resp.status == 400 and "unknown session" in \
        json.loads(resp.read())["error"]

    status, final = _post(server, f"/stream/{sid}/close", b"")
    assert status == 200 and final["track"] == "BlueTit"
    # Session gone now.
    status, body = _post(server, f"/stream/{sid}", subs[0].encode())
    assert status == 400


def test_stream_session_errors_and_eviction(decoded_corpus, default_config):
    from lbaudiodetective.ops.extract import extract_fingerprint

    fps = []
    for b in BIRDS[:2]:
        pos, neg, n = extract_fingerprint(decoded_corpus[b], default_config)
        fps.append(Fingerprint.from_planes(np.asarray(pos[:n]),
                                           np.asarray(neg[:n])))
    lib = FingerprintLibrary.from_fingerprints(fps, default_config)
    svc = IdentificationService(lib, BIRDS[:2], default_config,
                                stream_cap=4, max_sessions=2)

    # Unknown session.
    import pytest as _pytest

    from lbaudiodetective import errors as _errors

    with _pytest.raises(_errors.InvalidArgumentError):
        svc.stream_update("nope", b"01")

    sub = "01" * (default_config.subfingerprint_length // 2)
    sid = svc.stream_open()["session"]
    svc.stream_update(sid, ("+".join([sub] * 3)).encode())
    # Cap exceeded -> 400-class error, state intact at n=3.
    with _pytest.raises(_errors.InvalidArgumentError, match="cap"):
        svc.stream_update(sid, ("+".join([sub] * 2)).encode())
    assert svc.stream_update(sid, sub.encode())["n"] == 4

    # Bad payloads are rejected by the shared parser.
    with _pytest.raises(_errors.InvalidArgumentError):
        svc.stream_update(sid, b"01x")
    with _pytest.raises(_errors.InvalidArgumentError):
        svc.stream_update(sid, b"0101")          # wrong length

    # GET peek counts as activity: a polling client must not age toward
    # LRU eviction.
    import time as _time

    t0 = svc._sessions[sid]["t"]
    _time.sleep(0.01)
    svc.stream_peek(sid)
    assert svc._sessions[sid]["t"] > t0

    # At max_sessions with every session recently active, a new open is
    # refused (429-class) — it must NOT destroy a live client's state.
    s2 = svc.stream_open()["session"]
    assert len(svc._sessions) == 2
    with _pytest.raises(_errors.ResourceExhaustedError, match="active"):
        svc.stream_open()
    assert sid in svc._sessions                  # nothing was evicted

    # Once sessions count as idle (threshold 0 here), LRU eviction applies.
    svc.stream_idle_evict_s = 0.0
    s3 = svc.stream_open()["session"]
    assert len(svc._sessions) == 2
    with _pytest.raises(_errors.InvalidArgumentError, match="unknown"):
        svc.stream_close(sid)                    # evicted (oldest update)
    svc.stream_close(s2)
    svc.stream_close(s3)
    assert not svc._sessions

    # Library-size gate: sessions refuse search-scale libraries outright
    # (the incremental matcher would otherwise unpack L x S x pairs device
    # planes on one unauthenticated request).
    svc.stream_library_max = len(lib) - 1
    with _pytest.raises(_errors.ResourceExhaustedError, match="limited"):
        svc.stream_open()
