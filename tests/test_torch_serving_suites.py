"""The port's serving suites (``kv_dispersion``, ``serving_slo``) and
their place in ``run.py``, against the reference's suites.

kv_dispersion's rows are the pool's (hit rate, spills, hot KB) over the
suite's own seeded decode trace.  serving_slo's rows and Pareto fronts do
not depend on the weights (greedy decoding, requests end on their
length), so the port's own seeded init is held to the reference's JAX
init.  ``us_per_call`` is a wall time and is left out everywhere.
"""

import contextlib
import io
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

from benchmarks import kv_dispersion as jkv  # noqa: E402
from benchmarks import serving_slo as jslo  # noqa: E402
from repro_torch.benchmarks import kv_dispersion as tkv  # noqa: E402
from repro_torch.benchmarks import run as trun  # noqa: E402
from repro_torch.benchmarks import serving_slo as tslo  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMOKE_EVENTS = 120


def _strip(rows):
    return [{k: v for k, v in r.items() if k != "us_per_call"}
            for r in rows]


def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


def test_kv_dispersion_rows_equal_reference():
    got = tkv.run(device="cpu")
    want = jkv.run()
    assert len(got) == 8
    assert _strip(got) == _strip(want)


def test_kv_dispersion_trace_is_the_reference_trace():
    for steps in (40, 600):
        assert tkv._decode_trace(steps=steps) == jkv._decode_trace(
            steps=steps)
    assert tkv.WARMUP_STEPS == jkv.WARMUP_STEPS


@pytest.mark.parametrize("steps", [80, 200])
def test_kv_dispersion_budget_rows_equal_reference(steps):
    assert _strip(_quiet(tkv.main, max_events=steps, device="cpu")) == \
        _strip(_quiet(jkv.main, max_events=steps))


def test_serving_slo_smoke_rows_and_extra_equal_reference():
    got = _quiet(tslo.main, max_events=SMOKE_EVENTS, device="cpu")
    got_extra = json.loads(json.dumps(tslo.json_extra()))
    want = _quiet(jslo.main, max_events=SMOKE_EVENTS)
    assert len(got) == 4
    assert _strip(got) == _strip(want)
    assert got_extra == json.loads(json.dumps(jslo.json_extra()))
    assert got_extra["axes"]["policy"] == ["fifo"]


def test_serving_slo_grid_constants_match_reference():
    for name in ("ARCH", "SLOTS", "MAX_LEN", "PAGE_SIZE", "DEADLINE",
                 "SEED", "HOT_PAGES", "POLICIES", "MIXES", "FAULTS",
                 "SMOKE_HOT_PAGES"):
        assert getattr(tslo, name) == getattr(jslo, name), name


@pytest.mark.slow
def test_serving_slo_full_grid_equals_reference_and_bench():
    """All 24 rows (~50 s on a CPU): the rows against the reference's
    run(), the extra against BENCH_core.json's."""
    got = _quiet(tslo.main, device="cpu")
    got_extra = json.loads(json.dumps(tslo.json_extra()))
    bench = json.loads((ROOT / "BENCH_core.json").read_text())
    assert got_extra == bench["suites"]["serving_slo"]["extra"]
    assert _strip(got) == _strip(_quiet(jslo.main))


def test_run_py_runs_both_serving_suites(tmp_path):
    path = tmp_path / "report.json"
    rc = _quiet(trun.main, ["--device", "cpu", "--json", str(path),
                            "--max-events", str(SMOKE_EVENTS),
                            "kv_dispersion", "serving_slo"])
    assert rc == 0
    report = json.loads(path.read_text())
    kv, slo = (report["suites"][s] for s in ("kv_dispersion",
                                             "serving_slo"))
    assert (kv["rows"], slo["rows"]) == (8, 4)
    assert kv["device"] == slo["device"] == "cpu"
    assert kv["dispatches"] == slo["dispatches"] == 0
    assert "extra" in slo and "extra" not in kv
    assert "compiles" not in slo


def test_only_network_sweep_is_left_unported():
    """Nothing is left unported: run.py knows every suite of the
    reference's, network_sweep included, and refuses none."""
    import importlib
    assert not hasattr(trun, "NOT_PORTED")
    assert set(trun.SUITES) == set(
        importlib.import_module("benchmarks.run").SUITES)
    assert {"kv_dispersion", "serving_slo",
            "network_sweep"} <= set(trun.SUITES)
