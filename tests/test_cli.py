"""CLI smoke tests (enroll -> identify -> compare -> fingerprint) on real
corpus clips, exercising the essay's enroll/identify workflow end to end."""

import json
import shutil

import pytest

from lbaudiodetective.__main__ import main
from tests.conftest import CORPUS as BIRDS_DIR


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    for b in ("BlackBird", "Wren"):
        shutil.copy(BIRDS_DIR / "Archive" / f"{b}.caf", d / f"{b}.caf")
    return d


def test_enroll_identify(tiny_corpus, tmp_path, capsys):
    lib = str(tmp_path / "lib.npz")
    assert main(["enroll", str(tiny_corpus), "-o", lib]) == 0
    crop = str(BIRDS_DIR / "Cropped/Equal" / "BlackBird_eql.caf")
    assert main(["identify", crop, "--library", lib, "--all-scores"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["track"] == "BlackBird"
    assert out["score"] > 0.9
    assert set(out["scores"]) == {"BlackBird", "Wren"}


def test_compare_and_fingerprint(capsys):
    a = str(BIRDS_DIR / "Archive" / "Wren.caf")
    b = str(BIRDS_DIR / "Cropped/Equal" / "Wren_eql.caf")
    assert main(["compare", a, b]) == 0
    score = float(capsys.readouterr().out.strip())
    assert score > 0.9
    assert main(["fingerprint", a]) == 0
    s = capsys.readouterr().out.strip()
    assert set(s) <= {"0", "1", "+"} and len(s) > 100


def test_identify_top_k(tiny_corpus, tmp_path, capsys):
    """--top-k answers with a ranked exact top-k list (two-stage search
    path on large libraries; exact path on small ones)."""
    lib = str(tmp_path / "lib.npz")
    assert main(["enroll", str(tiny_corpus), "-o", lib]) == 0
    capsys.readouterr()
    crop = str(BIRDS_DIR / "Cropped/Equal" / "BlackBird_eql.caf")
    assert main(["identify", crop, "--library", lib, "--top-k", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["track"] == "BlackBird"
    assert [e["track"] for e in out["top"]][0] == "BlackBird"
    assert len(out["top"]) == 2
    scores = [e["score"] for e in out["top"]]
    assert scores == sorted(scores, reverse=True)


def test_enroll_empty_dir(tmp_path):
    assert main(["enroll", str(tmp_path), "-o", str(tmp_path / "x.npz")]) == 2


def test_enroll_append(tiny_corpus, tmp_path, tmp_path_factory, capsys):
    """Incremental enrollment: --append grows an existing library and its
    names sidecar; identification covers both generations."""
    lib = str(tmp_path / "lib.npz")
    assert main(["enroll", str(tiny_corpus), "-o", lib]) == 0
    more = tmp_path_factory.mktemp("more")
    shutil.copy(BIRDS_DIR / "Archive" / "Crow.caf", more / "Crow.caf")
    assert main(["enroll", str(more), "-o", lib, "--append"]) == 0
    capsys.readouterr()
    crop = str(BIRDS_DIR / "Cropped/Equal" / "Crow_eql.caf")
    assert main(["identify", crop, "--library", lib, "--all-scores"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["track"] == "Crow"
    assert set(out["scores"]) == {"BlackBird", "Wren", "Crow"}


def test_client_server_roundtrip(tiny_corpus, tmp_path, capsys):
    """The essay's client/server split end to end: serve a library, POST a
    clip with the client subcommand, parse the identification JSON."""
    import threading

    from lbaudiodetective.models.library import FingerprintLibrary
    from lbaudiodetective.serving import IdentificationService, make_server
    from lbaudiodetective.__main__ import _load_library

    lib_path = str(tmp_path / "lib.npz")
    assert main(["enroll", str(tiny_corpus), "-o", lib_path]) == 0
    lib, names = _load_library(lib_path)
    srv = make_server(IdentificationService(lib, names))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        crop = str(BIRDS_DIR / "Cropped/Equal" / "BlackBird_eql.caf")
        capsys.readouterr()
        assert main(["client", crop, "--url", url]) == 0
        out = json.loads(capsys.readouterr().out.strip())
        assert out["track"] == "BlackBird" and out["score"] > 0.9
        assert main(["client", crop, "--url", url, "--fingerprint"]) == 0
        fp = json.loads(capsys.readouterr().out.strip())
        assert fp["n"] > 0 and set(fp["fingerprint"]) <= {"0", "1", "+"}
        # The essay's actual protocol: client-side extraction, the server
        # matches the uploaded fingerprint string only.
        assert main(["client", crop, "--url", url, "--local-extract"]) == 0
        out_fp = json.loads(capsys.readouterr().out.strip())
        assert out_fp["track"] == "BlackBird" and out_fp["score"] > 0.9
        # Unreachable server: exit code 2, not a traceback.
        assert main(["client", crop, "--url", "http://127.0.0.1:1",
                     "--timeout", "2"]) == 2
        # Live recognition: stream the fingerprint in increments, the
        # final close result agrees with the one-shot identification.
        assert main(["listen", crop, "--url", url, "--chunk", "3"]) == 0
        streamed = json.loads(capsys.readouterr().out.strip())
        assert streamed["track"] == "BlackBird"
        assert streamed["score"] == pytest.approx(out_fp["score"], abs=1e-6)
        assert main(["listen", crop, "--url", "http://127.0.0.1:1",
                     "--timeout", "2"]) == 2
    finally:
        srv.shutdown()


def test_identify_negative_top_k(tiny_corpus, tmp_path, capsys):
    lib = str(tmp_path / "lib.npz")
    assert main(["enroll", str(tiny_corpus), "-o", lib]) == 0
    crop = str(BIRDS_DIR / "Cropped/Equal" / "BlackBird_eql.caf")
    assert main(["identify", crop, "--library", lib, "--top-k", "-1"]) == 2


def test_serve_flags_reach_service(tiny_corpus, tmp_path, capsys, monkeypatch):
    """The production serving knobs flow from the CLI into the service."""
    from lbaudiodetective import serving as serving_mod

    lib = str(tmp_path / "lib.npz")
    assert main(["enroll", str(tiny_corpus), "-o", lib]) == 0
    captured = {}

    def fake_serve_forever(service, host="0.0.0.0", port=8080):
        captured["svc"] = service
        captured["host"], captured["port"] = host, port

    monkeypatch.setattr(serving_mod, "serve_forever", fake_serve_forever)
    assert main(["serve", "--library", lib, "--port", "9999",
                 "--batch-window", "0.25", "--max-batch", "4",
                 "--n-sub-cap", "48", "--search-threshold", "2",
                 "--top-k", "3", "--stream-pool",
                 "--stream-flush-window", "0.1"]) == 0
    svc = captured["svc"]
    assert captured["port"] == 9999
    assert svc.batch_window_s == 0.25 and svc.max_batch == 4
    assert svc.n_sub_cap == 48 and svc.search_threshold == 2
    assert svc.top_k == 3
    assert svc.stream_pool and svc.stream_flush_window_s == 0.1


def test_serve_sessions_dir_roundtrip(tiny_corpus, tmp_path, capsys,
                                      monkeypatch):
    """`serve --sessions-dir`: live sessions opened during one server run
    are checkpointed at shutdown and restored by the next boot."""
    from lbaudiodetective import serving as serving_mod

    lib = str(tmp_path / "lib.npz")
    assert main(["enroll", str(tiny_corpus), "-o", lib]) == 0
    sess_dir = str(tmp_path / "sessions")
    state = {}

    def serve_and_open(service, host="0.0.0.0", port=8080):
        state["sid"] = service.stream_open()["session"]
        sub = "01" * (service.config.subfingerprint_length // 2)
        service.stream_update(state["sid"], sub.encode())

    monkeypatch.setattr(serving_mod, "serve_forever", serve_and_open)
    assert main(["serve", "--library", lib,
                 "--sessions-dir", sess_dir]) == 0

    def serve_and_check(service, host="0.0.0.0", port=8080):
        state["restored"] = state["sid"] in service._sessions
        state["n"] = service._sessions[state["sid"]]["m"].n

    monkeypatch.setattr(serving_mod, "serve_forever", serve_and_check)
    assert main(["serve", "--library", lib,
                 "--sessions-dir", sess_dir]) == 0
    assert state["restored"] and state["n"] == 1


def test_dedup_finds_duplicates(tmp_path, capsys):
    """`dedup` reports the near-duplicate pair (archive clip vs its exact
    crop) in both directions and nothing for the unrelated track; the
    2-device ring path pads 3 tracks to 4 and trims the padding."""
    d = tmp_path / "clips"
    d.mkdir()
    shutil.copy(BIRDS_DIR / "Archive" / "BlackBird.caf", d / "BlackBird.caf")
    shutil.copy(BIRDS_DIR / "Cropped/Equal" / "BlackBird_eql.caf",
                d / "BlackBird_eql.caf")
    shutil.copy(BIRDS_DIR / "Archive" / "Wren.caf", d / "Wren.caf")
    lib = str(tmp_path / "lib.npz")
    assert main(["enroll", str(d), "-o", lib]) == 0
    capsys.readouterr()
    for devices in ("1", "2"):
        assert main(["dedup", "--library", lib, "--threshold", "0.8",
                     "--devices", devices]) == 0
        out = json.loads(capsys.readouterr().out.strip())
        got = {e["track"]: {c["track"] for c in e["candidates"]} for e in out}
        assert got == {"BlackBird": {"BlackBird_eql"},
                       "BlackBird_eql": {"BlackBird"}}


def test_dedup_bad_args(tmp_path, capsys):
    d = tmp_path / "one"
    d.mkdir()
    shutil.copy(BIRDS_DIR / "Archive" / "Wren.caf", d / "Wren.caf")
    lib = str(tmp_path / "one.npz")
    assert main(["enroll", str(d), "-o", lib]) == 0
    assert main(["dedup", "--library", lib]) == 2          # < 2 tracks
    assert main(["dedup", "--library", lib, "--top-k", "0"]) == 2
    assert main(["dedup", "--library", lib, "--devices", "0"]) == 2


def test_compare_maa(capsys):
    orig = str(BIRDS_DIR / "Archive" / "Wren.caf")
    crop = str(BIRDS_DIR / "Cropped/Equal" / "Wren_eql.caf")
    assert main(["compare", orig, crop, "--algorithm", "maa"]) == 0
    count = int(capsys.readouterr().out.strip())
    assert count > 300          # bit-exact prefix crop: windows align
