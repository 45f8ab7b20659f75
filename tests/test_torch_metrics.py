"""The port's metric registry (``repro_torch.metrics``, with the
``repro_torch.silicon`` plugin and ``repro_torch.core.costmodel``) against
the reference's, on the CPU.

The catalog has the same names, kinds and (but for module names) docs.
Every metric is evaluated on the same seeded hand-made grid in both
packages — engine, cluster, serving and roofline counters side by side,
with a ``cores`` axis and ``meta["cluster"]`` — and on a real reduced grid
run through both Sessions, and must be bitwise equal (the same numpy on
the same float64).  ``area_headline`` gives the paper's 3.5x, 53 % and
23 %, and the silicon plugin loads lazily.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro import metrics as jmetrics  # noqa: E402
from repro.core import costmodel as jcost  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import metrics as tmetrics  # noqa: E402
from repro_torch.core import costmodel as tcost  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MACROS = ("flop", "sram6t", "table")
FULL = dict(capacity=32)
# Relational metrics' arguments: the baseline and the of= counter.
RELATIONAL = {"speedup": {}, "ratio": dict(of="cycles"),
              "savings_pct": dict(of="application_power"),
              "delta": dict(of="hit_rate"), "equal_area_advantage": {}}
CLUSTER_META = dict(cores=[1, 2], l2_sets=512, l2_ways=4, mem_channels=2,
                    l2_hit_cycles=2, l2_bytes=512 * 4 * 32)
ENGINE = ("cycles", "stall_cycles", "vrf_hits", "vrf_misses", "spills",
          "fills", "l1_hits", "l1_misses", "reg_reads", "reg_writes",
          "mem_reads", "mem_writes")
EXTRA = ("contention_stalls", "core_cycles_sum", "tokens_per_tick",
         "degraded_tokens_per_tick", "deadline_miss_rate", "flops",
         "counted_bytes", "model_bytes", "us_per_call")


def _hand_made(api, seed=0):
    """kernel x capacity x policy x anf x L1 x cores x machine latencies,
    every counter any metric reads drawn from a seeded generator."""
    axes = (api.Axis("kernel", ("gemv", "dropout")),
            api.Axis("capacity", (4, 8, 32)),
            api.Axis("policy", (0, 1)),
            api.Axis("alloc_no_fetch", (False,)),
            api.Axis("l1_geometry", (api.L1Geometry(256, 2),
                                     api.L1Geometry(64, 2))),
            api.Axis("cores", (1, 2)),
            api.Axis("mem_latency", (1, 5)),
            api.Axis("l1_hit_cycles", (0,)),
            api.Axis("uop_hit_cycles", (1, 2)))
    shape = tuple(len(a) for a in axes)
    rng = np.random.default_rng(seed)
    data = {k: rng.integers(1, 50_000, shape).astype(np.int32)
            for k in ENGINE}
    data["hit_rate"] = data["vrf_hits"] / (data["vrf_hits"]
                                           + data["vrf_misses"])
    data["event_scale"] = rng.choice([1.0, 1.5], shape)
    data["fold_exact"] = np.ones(shape, bool)
    for k in EXTRA:
        data[k] = rng.uniform(0.01, 1000.0, shape)
    return api.SweepResult(axes, data, dict(kernel_params="reduced",
                                            cluster=dict(CLUSTER_META)))


def _derivations(name):
    """(kwargs of derive) for each evaluation of a metric: its baseline
    and of= for the relational ones, each macro model where it takes
    one."""
    kind = tmetrics.get(name).kind
    params = tmetrics.get(name).params
    kw = dict(baseline=FULL, **RELATIONAL[name]) if kind == "relational" \
        else {}
    if "macro_model" in params:
        return [dict(kw, macro_model=m) for m in MACROS]
    return [kw]


def _same(want, got, name):
    w, g = np.asarray(want), np.asarray(got)
    assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=name)


def test_catalog_equals_reference():
    want, got = jmetrics.catalog(), tmetrics.catalog()
    assert list(got) == list(want)
    assert len(got) == 36
    for name, rec in got.items():
        assert rec["kind"] == want[name]["kind"], name
        assert rec["doc"].replace("repro_torch.", "repro.") \
            == want[name]["doc"], name
        assert tmetrics.get(name).params == jmetrics.get(name).params, name


@pytest.mark.parametrize("name", sorted(jmetrics.catalog()))
def test_metric_equals_reference_on_hand_made_grid(name):
    jres, tres = _hand_made(japi), _hand_made(tapi)
    for kw in _derivations(name):
        want = jres.derive(name, **kw)
        got = tres.derive(name, **kw)
        assert set(got.data) == set(want.data), name
        for k in want.data:
            _same(want[k], got[k], f"{name} {kw}: {k}")


def test_engine_metrics_equal_reference_on_real_grid():
    """Every metric that reads engine counters, on a reduced grid run
    through both Sessions (two geometries, M = 4, capacity x policy)."""
    kw = dict(kernels=("gemv", "dropout", "pathfinder"),
              capacity=(3, 8, 32), policy=("fifo", "lfu"),
              mem_latency=(1, 3, 5, 10),
              l1_geometry=((256, 2), (64, 2)), kernel_params="reduced")
    jres = japi.Session().run(japi.Sweep(**kw))
    tres = tapi.Session(device="cpu").run(tapi.Sweep(**kw))
    skip = {"cluster_area", "sram_budget_bytes", "contention_stall_ratio",
            "silicon_cluster_area", "slo_attainment", "goodput",
            "degraded_throughput_ratio", "arithmetic_intensity",
            "model_arithmetic_intensity", "achieved_gflops"}
    names = [n for n in sorted(jmetrics.catalog()) if n not in skip]
    assert len(names) == 26
    for name in names:
        for dkw in _derivations(name):
            _same(jres.derive(name, **dkw)[name],
                  tres.derive(name, **dkw)[name], f"{name} {dkw}")


def test_cluster_metrics_need_cluster_meta():
    res = _hand_made(tapi)
    res.meta.pop("cluster")
    with pytest.raises(KeyError, match="cluster"):
        res.derive("cluster_area")
    with pytest.raises(KeyError, match="cluster"):
        res.derive("sram_budget_bytes")


def test_cost_model_functions_equal_reference():
    n = np.arange(1, 41)
    for dispersed in (False, True):
        want = jcost.cpu_area_grid(n, dispersed=dispersed)
        got = tcost.cpu_area_grid(n, dispersed=dispersed)
        for key in want:
            _same(want[key], got[key], key)
        for nv in (4, 8, 32):
            assert tcost.cpu_area(nv, dispersed=dispersed).as_dict() == \
                jcost.cpu_area(nv, dispersed=dispersed).as_dict()
    for macro in (None,) + MACROS:
        _same(jcost.l1_sram_area([64, 256], 2, macro=macro),
              tcost.l1_sram_area([64, 256], 2, macro=macro), str(macro))
    rng = np.random.default_rng(3)
    counters = {k: rng.integers(0, 100_000, (3, 4))
                for k in ("reg_reads", "reg_writes", "l1_hits", "l1_misses",
                          "mem_reads", "mem_writes", "cycles")}
    n_vregs = np.asarray([4, 8, 32]).reshape(3, 1)
    want = jcost.application_power_grid(counters, n_vregs,
                                        dispersed=n_vregs < 32)
    got = tcost.application_power_grid(counters, n_vregs,
                                       dispersed=n_vregs < 32)
    for key in want:
        _same(want[key], got[key], key)
    point = {k: float(v[0, 0]) for k, v in counters.items()}
    assert tcost.application_power(point, 4, point["cycles"]) == \
        jcost.application_power(point, 4, point["cycles"])


def test_machine_affine_check_equals_reference():
    """check_machine_affine accepts the ablation-style grid the port's
    Session makes and returns what the reference's returns on the
    reference's grid, and both refuse a broken grid alike."""
    kw = dict(kernels=("gemv", "dropout"), capacity=(8, 32),
              mem_latency=(1, 3, 5, 10), kernel_params="reduced",
              fold=False)
    jgrid = japi.Session().run(japi.Sweep(**kw)).to_grid()
    tres = tapi.Session(device="cpu").run(tapi.Sweep(**kw))
    tgrid = tres.to_grid()
    from repro.core import simulator as jsim
    from repro_torch.core import simulator as tsim
    want = jcost.check_machine_affine(jgrid, jsim.MachineSweep.make(
        (1, 3, 5, 10)))
    got = tcost.check_machine_affine(tgrid, tsim.MachineSweep.make(
        (1, 3, 5, 10)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    broken = {k: v.copy() for k, v in tgrid.items()}
    broken["cycles"][0, 0, 2] += 7
    with pytest.raises(AssertionError):
        tcost.check_machine_affine(broken, tsim.MachineSweep.make(
            (1, 3, 5, 10)))


def test_area_headline_matches_paper_and_reference():
    head = tmetrics.area_headline()
    assert head == jmetrics.area_headline()
    assert abs(head["baseline_vrf_pct_of_vpu"] - 61.0) < 0.5
    assert abs(head["vrf_area_reduction_x"] - 3.5) < 0.1       # 3.5x
    assert abs(head["vpu_area_saving_pct"] - 53.0) < 1.0       # 53%
    assert abs(head["total_area_saving_pct"] - 23.0) < 1.0     # 23%
    assert tmetrics.area_headline(n_cvrf=4) == jmetrics.area_headline(
        n_cvrf=4)


def test_registry_round_trip_and_kind_discipline():
    res = _hand_made(tapi)

    @tmetrics.register("test_double_cycles", "derived", "2x cycles")
    def _double(ctx):
        return ctx.counter("cycles") * 2
    try:
        assert tmetrics.catalog()["test_double_cycles"]["kind"] == "derived"
        np.testing.assert_array_equal(
            res.derive("test_double_cycles")["test_double_cycles"],
            res["cycles"] * 2)
        with pytest.raises(ValueError, match="registered twice"):
            tmetrics.register("test_double_cycles", "derived")(_double)
    finally:
        tmetrics.unregister("test_double_cycles")
    assert "test_double_cycles" not in tmetrics.names()
    with pytest.raises(ValueError, match="relational; pass baseline"):
        res.derive("speedup")
    with pytest.raises(ValueError, match="not relational"):
        res.derive("scaled_cycles", baseline=FULL)
    with pytest.raises(KeyError, match="unknown metric"):
        res.derive("nope")
    with pytest.raises(TypeError, match="unknown parameter.*bogus"):
        res.derive("speedup", baseline=FULL, bogus=1)
    # derive() parameters reach composed metrics without poisoning the
    # canonical-name cache
    cheap = tcost.PowerParams(e_alu_op=0.0, e_l1_access=0.0)
    custom = res.derive("energy", pp=cheap)
    assert "application_power" not in custom.keys()
    assert (custom["energy"] < res.derive("energy")["energy"]).all()


def test_silicon_plugin_loads_lazily():
    """A fresh process that imports the port's metrics never imports its
    silicon package (nor JAX nor the reference) until a silicon metric is
    looked up; the lookup then loads it."""
    code = (
        "import sys\n"
        "from repro_torch import metrics\n"
        "assert 'repro_torch.silicon' not in sys.modules\n"
        "assert metrics.get('silicon_area').kind == 'model'\n"
        "assert 'repro_torch.silicon' in sys.modules\n"
        "assert 'silicon_energy' in metrics.catalog()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'repro')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
