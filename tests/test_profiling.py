"""utils.profiling — the SURVEY §5 tracing hooks the bench harness uses."""

import pathlib

import pytest

from lbaudiodetective.utils import profiling


def test_stage_timers_accumulate():
    t = profiling.StageTimers()
    for _ in range(3):
        with t.stage("extract"):
            pass
    with t.stage("match"):
        pass
    rep = t.report()
    assert set(rep) == {"extract", "match"}
    assert rep["extract"]["calls"] == 3 and rep["match"]["calls"] == 1
    assert rep["extract"]["seconds"] >= 0.0


def test_stage_records_time_even_on_exception():
    t = profiling.StageTimers()
    with pytest.raises(RuntimeError):
        with t.stage("boom"):
            raise RuntimeError("x")
    assert t.report()["boom"]["calls"] == 1


def test_module_level_stage_and_report():
    with profiling.stage("unit-test-stage"):
        pass
    assert profiling.report()["unit-test-stage"]["calls"] >= 1


def test_trace_to_writes_a_trace(tmp_path):
    """Capture a tiny device trace; must at least not raise, and on backends
    that support tracing it writes files under the directory."""
    import jax.numpy as jnp

    with profiling.trace_to(str(tmp_path)):
        jnp.ones(8).sum().block_until_ready()
    # CPU backend supports profiling: expect some artifact to exist.
    produced = list(pathlib.Path(tmp_path).rglob("*"))
    assert produced, "trace_to produced no artifacts on a supporting backend"
