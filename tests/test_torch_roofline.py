"""Port's roofline path (api.SweepResult, metrics, benchmarks) against the
reference.

``SweepResult`` and the metric registry are held against
``repro.api``/``repro.metrics`` on the same tables; the measured roofline
and vmem_dispersion are held against ``benchmarks/`` on every field that
is not a timing.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import benchmarks.roofline as jroofline  # noqa: E402
import benchmarks.vmem_dispersion as jvmem  # noqa: E402
from repro import api as japi  # noqa: E402
from repro import metrics as jmetrics  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import metrics as tmetrics  # noqa: E402
from repro_torch.benchmarks import roofline as troofline  # noqa: E402
from repro_torch.benchmarks import vmem_dispersion as tvmem  # noqa: E402

# Fields of a roofline row that do not depend on a timing.
UNTIMED = ("name", "case", "kernel", "working_set", "precision", "block_m",
           "block_k", "flops", "counted_bytes", "model_bytes", "model_agree",
           "vmem_acc_bytes", "ai_measured", "ai_model")


def _table(seed, n_case=3, ties=False):
    """A roofline-shaped table: case x working_set x precision rows with
    seeded values; ``ties`` repeats values so the Pareto front has ties."""
    rng = np.random.default_rng(seed)
    axes = dict(case=tuple(f"c{i}" for i in range(n_case)),
                working_set=(0, 1, 2, 4), precision=("f32", "bf16"))
    rows = []
    for c in axes["case"]:
        for w in axes["working_set"]:
            for p in axes["precision"]:
                us = float(rng.integers(1, 4) if ties else
                           rng.uniform(1, 100))
                rows.append(dict(
                    case=c, working_set=w, precision=p, us_per_call=us,
                    flops=float(rng.integers(1, 10) * 1e6),
                    counted_bytes=float(rng.integers(1, 10) * 1e5),
                    model_bytes=float(rng.integers(1, 10) * 1e5),
                    vmem_acc_bytes=float(w * 1024 if ties
                                         else rng.integers(0, 5) * 1024),
                    energy=float(rng.integers(1, 4) if ties else
                                 rng.uniform(0, 1))))
    return axes, rows


def _both(axes, rows):
    return (japi.SweepResult.from_table(axes, rows),
            tapi.SweepResult.from_table(axes, rows))


def _same_grid(j, t):
    assert [(a.name, a.values) for a in j.axes] == [
        (a.name, a.values) for a in t.axes]
    assert sorted(j.data) == sorted(t.data)
    for k in j.data:
        np.testing.assert_array_equal(j.data[k], t.data[k])


@pytest.mark.parametrize("seed", [0, 1])
def test_sweep_result_from_table_derive_normalize_value(seed):
    j, t = _both(*_table(seed))
    _same_grid(j, t)
    for m in ("arithmetic_intensity", "model_arithmetic_intensity",
              "achieved_gflops"):
        j, t = j.derive(m), t.derive(m)
    _same_grid(j, t)
    assert j.meta == t.meta
    jn = j.normalize("us_per_call", baseline=dict(working_set=0))
    tn = t.normalize("us_per_call", baseline=dict(working_set=0))
    _same_grid(jn, tn)
    sel = dict(case="c1", working_set=2, precision="bf16")
    assert jn.value("us_per_call", **sel) == tn.value("us_per_call", **sel)
    assert j.to_rows() == t.to_rows()
    assert (j.select(case=["c0", "c2"]).to_rows()
            == t.select(case=["c0", "c2"]).to_rows())
    _same_grid(j.quantile(90, over="case"), t.quantile(90, over="case"))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_sweep_result_pareto_matches_reference(seed, ties):
    j, t = _both(*_table(seed, ties=ties))
    calls = [
        dict(x="vmem_acc_bytes", y="us_per_call"),
        dict(x="vmem_acc_bytes", y="us_per_call", case="c1"),
        dict(axes=["vmem_acc_bytes", "us_per_call", "energy"]),
        dict(axes=["vmem_acc_bytes", "us_per_call", "energy"],
             maximize=("energy",)),
        dict(x="us_per_call", y="achieved_gflops",
             maximize="achieved_gflops"),
    ]
    for kw in calls:
        assert j.pareto(**kw) == t.pareto(**kw), kw


def test_sweep_result_errors_match_reference():
    axes, rows = _table(0)
    j, t = _both(axes, rows)
    cases = [
        lambda r: r.value("us_per_call"),
        lambda r: r.select(case="nope"),
        lambda r: r.pareto("us_per_call"),
        lambda r: r.pareto(axes=["us_per_call"]),
        lambda r: r.pareto("a", "b", axes=["a", "b"]),
        lambda r: r.pareto("us_per_call", "flops", maximize="energy"),
        lambda r: r.normalize("us_per_call", baseline={}),
        lambda r: r.normalize("us_per_call", baseline=dict(nope=1)),
        lambda r: r.derive("no_such_metric"),
    ]
    for fn in cases:
        with pytest.raises(Exception) as want:
            fn(j)
        with pytest.raises(type(want.value)) as got:
            fn(t)
        if not isinstance(want.value, KeyError):
            assert str(got.value) == str(want.value)
    bad = rows[:1] + [dict(rows[1], case="zz")]
    with pytest.raises(ValueError) as want:
        japi.SweepResult.from_table(axes, bad)
    with pytest.raises(ValueError) as got:
        tapi.SweepResult.from_table(axes, bad)
    assert str(got.value) == str(want.value)


def test_axis_value_types_match_reference():
    assert tapi.L1Geometry.from_kbytes(16) == tapi.L1Geometry(256, 2)
    g = japi.L1Geometry.from_kbytes(8, ways=4)
    assert (g.sets, g.ways, g.kbytes, str(g)) == (
        tapi.L1Geometry.from_kbytes(8, ways=4).sets, 4, 8,
        str(tapi.L1Geometry.from_kbytes(8, ways=4)))
    for c in [(3,), (4, "lru"), dict(capacity=8, policy="opt",
                                     alloc_no_fetch=True)]:
        jc, tc = japi._as_config_point(c), tapi._as_config_point(c)
        assert (jc.capacity, jc.policy, jc.alloc_no_fetch) == (
            tc.capacity, tc.policy, tc.alloc_no_fetch)
    with pytest.raises(ValueError) as want:
        japi._policy_id("nope")
    with pytest.raises(ValueError) as got:
        tapi._policy_id("nope")
    assert str(got.value) == str(want.value)
    ja = japi.Axis("policy", (0, 1, 3))
    ta = tapi.Axis("policy", (0, 1, 3))
    assert ja.indices(["lru", "opt"]) == ta.indices(["lru", "opt"])
    assert tapi._CONFIG_FIELDS == japi._CONFIG_FIELDS
    assert tapi._GEOMETRY_FIELDS == japi._GEOMETRY_FIELDS


def test_metric_registry_core_matches_reference():
    roofline_metrics = ["achieved_gflops", "arithmetic_intensity",
                        "model_arithmetic_intensity"]
    # the port's registry is the reference's whole (silicon's metrics
    # included): the same names, kinds and docs, but for module names
    assert tmetrics.names() == jmetrics.names()
    assert set(roofline_metrics) <= set(tmetrics.names())
    for name in tmetrics.names():
        assert tmetrics.get(name).kind == jmetrics.get(name).kind
        assert tmetrics.get(name).doc.replace("repro_torch.", "repro.") \
            == jmetrics.get(name).doc
    with pytest.raises(KeyError, match="unknown metric 'nope'"):
        tmetrics.get("nope")

    @tmetrics.register("ratio_test", "relational", params=())
    def _ratio(ctx, base):
        return ctx.counter("us_per_call") / base.counter("us_per_call")
    try:
        with pytest.raises(ValueError, match="registered twice"):
            tmetrics.register("ratio_test", "derived")(lambda ctx: 0)
        _, t = _both(*_table(2))
        with pytest.raises(ValueError, match="relational"):
            t.derive("ratio_test")
        with pytest.raises(TypeError, match="unknown parameter"):
            t.derive("ratio_test", baseline=dict(working_set=0), bogus=1)
        got = t.derive("ratio_test", baseline=dict(working_set=0))
        want = t.normalize("us_per_call", baseline=dict(working_set=0))
        np.testing.assert_array_equal(got["ratio_test"],
                                      want["us_per_call"])
    finally:
        tmetrics.unregister("ratio_test")
    assert "ratio_test" not in tmetrics.names()


def _untimed(rows):
    return [{k: r[k] for k in UNTIMED} for r in rows]


def test_roofline_smoke_matches_reference_but_timings():
    jg, jf, jrows = jroofline.run_measured(smoke=True)
    jextra = jroofline.json_extra()
    tg, tf, trows = troofline.run_measured(smoke=True, device="cpu")
    textra = troofline.json_extra()
    assert _untimed(trows) == _untimed(jrows)
    assert all(r["model_agree"] for r in trows)
    assert textra["axes"] == jextra["axes"]
    assert textra["device"] == "cpu" and "interpret" not in textra
    for jr, tr in ((jg, tg), (jf, tf)):
        assert [(a.name, a.values) for a in jr.axes] == [
            (a.name, a.values) for a in tr.axes]
        for k in ("flops", "counted_bytes", "model_bytes", "model_agree",
                  "vmem_acc_bytes", "arithmetic_intensity",
                  "model_arithmetic_intensity"):
            np.testing.assert_array_equal(jr[k], tr[k])
    # the Pareto front's inputs: footprint per grid point
    assert sorted(textra["pareto"]) == sorted(jextra["pareto"])
    stats = troofline.perf_stats()
    assert stats["device"] == "cpu"
    assert not any(stats["kernel_launches"].values())
    assert stats["plain_calls"] == {"matmul_grouped": 4,
                                    "matmul_dispersed": 2,
                                    "flash_attention": 2}


def test_roofline_full_grid_matches_reference_with_timing_fixed(monkeypatch):
    """The whole measured grid, with each side's timer replaced by a
    constant so every derived field (speedups, Pareto fronts, equal-
    footprint winners) is comparable; the reference then runs no kernel
    at all, and the port runs only its CPU plain twins' inputs."""
    monkeypatch.setattr(jroofline, "_measure", lambda fn, sig, rep: 1.0)
    monkeypatch.setattr(troofline, "_measure", lambda fn, dev, rep: 1.0)
    _, _, jrows = jroofline.run_measured(smoke=False)
    jextra = dict(jroofline.json_extra())
    _, _, trows = troofline.run_measured(smoke=False, device="cpu")
    textra = dict(troofline.json_extra())
    assert len(trows) == len(jrows) == 33
    assert trows == jrows
    assert textra.pop("device") == "cpu"
    jextra.pop("interpret")
    assert textra == jextra


def test_vmem_dispersion_closed_form_rows_match_reference():
    jrows, trows = jvmem.run(), tvmem.run(device="cpu")
    assert trows[:5] == jrows[:5]
    assert trows[5]["name"] == "cpu_check" and trows[5]["max_err"] < 1e-3


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the defaults would run")
    for fn in (troofline.run_measured, troofline.main, tvmem.run,
               tvmem.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()


def test_roofline_cli_on_cpu():
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.roofline",
         "--device", "cpu", "--smoke"], capture_output=True, text=True,
        timeout=120, cwd=root, env=env)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == ",".join(troofline._HEADER)
    assert any(ln.startswith("gemm_128x256x128_dispersed_f32,")
               for ln in lines)
    assert lines[-1].startswith("# device cpu:")
