"""chip_smoke.py's phases at tiny sizes on the CPU, and the refusal of the
smoke run and the benchmark to measure without a GPU."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

import chip_smoke as cs

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = cs.Sizes(clips=4, seconds=3.0, proc_clips=2, oracle_clips=2,
                time_batch=2, time_iters=1, tracks=2048, s_lib=16,
                match_tracks=256, queries=2, requests=2, streams=4,
                stream_ticks=12, dedup_tracks=64, dedup_s=4)


@pytest.fixture(scope="module")
def clip_paths(tmp_path_factory):
    return cs.write_clips(0, TINY.clips, TINY.seconds,
                          str(tmp_path_factory.mktemp("clips")))


@pytest.fixture(scope="module")
def extraction(clip_paths):
    return cs.phase_extraction(clip_paths, TINY)


@pytest.fixture(scope="module")
def library(extraction):
    return cs.phase_library(extraction["fingerprints"], extraction["decoded"],
                            TINY, 0)


def test_phase_extraction(extraction):
    assert extraction["parity_batch"] == TINY.clips
    assert extraction["parity_oracle_agreement"] >= cs.ORACLE_FLOOR
    assert extraction["proc_oracle_agreement"] >= cs.ORACLE_FLOOR
    assert set(extraction["tier_agreement"]) == {
        f"{t}/{m}" for t in ("default", "medium", "high", "highest")
        for m in ("parity", "proc")}
    assert all(f.num_subfingerprints == 15 for f in extraction["fingerprints"])


def test_phase_rows_paths(extraction):
    out = cs.phase_rows_paths(extraction["decoded"], extraction["_oracle"],
                              TINY)
    for mode in ("parity", "proc"):
        for path in ("conv", "xla_matmul_dft", "xla_rfft"):
            assert out[f"{mode}/{path}/agreement_vs_conv"] >= 0.999
            assert out[f"{mode}/{path}/oracle_agreement"] >= 0.999
            assert out[f"{mode}/{path}/step_ms"] > 0


def test_phase_library(library):
    assert library["library_tracks"] == TINY.tracks
    assert library["matchers_max_abs_diff"] <= cs.SCORE_ATOL
    assert library["search_top1_min_score"] > 0.55


def test_phase_serving(library, clip_paths):
    out = cs.phase_serving(library["small_library"], library["small_where"],
                           clip_paths, TINY)
    assert out["requests"] == TINY.requests


def test_phase_streaming(extraction, library):
    out = cs.phase_streaming(extraction["decoded"], library["small_library"],
                             library["small_where"], TINY)
    assert out["identified"] == TINY.streams
    assert out["aligned_subfingerprints"] == out["conv_subfingerprints"] > 0


def test_phase_multi_on_four_cpu_devices():
    import jax

    assert len(jax.devices()) >= 4
    out = cs.phase_multi(TINY, 0, 4)
    assert out["mesh"] == {"data": 2, "library": 2}


def test_check_raises_smoke_failure():
    with pytest.raises(cs.SmokeFailure, match="wrong"):
        cs.check(False, "wrong")


def _run(args, cwd, extra_env=None):
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": "", **(extra_env or {})}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script,alone", [
    ("chip_smoke.py", False), ("chip_smoke.py", True), ("bench.py", False)])
def test_refuses_to_run_without_gpu(tmp_path, script, alone):
    """On the CPU (and for chip_smoke also in a directory holding nothing
    else of the repo) the script exits non-zero and prints no result."""
    if alone:
        shutil.copy(REPO / script, tmp_path / script)
        proc = _run([script], tmp_path)
    else:
        proc = _run([str(REPO / script)], tmp_path)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            assert "ok" not in json.loads(line) and "value" not in json.loads(line)
    assert not (tmp_path / "bench_details.json").exists()
