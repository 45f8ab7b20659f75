"""The port's paper suites (``repro_torch.benchmarks``) against the
reference's ``benchmarks/``, on the CPU.

Each of the nine paper suites runs in both packages on the same small
budget (dropout and gemv at ``max_events`` = 2,000, or the suite's fixed
roster at 1,000), and so do the two cluster suites on gemv at N = 1 and 2,
each package on a Session of its own shared by the module's suites (the
port's on the CPU): the rows must be equal but for the wall-clock
``us_per_call`` column, and the cluster suites' fronts and summaries too,
but for their plan-group provenance.  Fig 4's pathfinder row at capacity 3
is the reference's own end-to-end check, at paper size.  The harness
(``run.main``) and the examples are held in ``test_torch_harness.py``.
"""

import importlib

import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro_torch import api as tapi  # noqa: E402

NAMES = ("dropout", "gemv")
BUDGET = 2_000
# the fixed rosters (six and four programs) at half the budget
ROSTER_BUDGET = 1_000
SUITES = {
    "table3_speedup": dict(names=NAMES, max_events=BUDGET),
    "fig2_area_model": {},
    "fig4_cvrf_sweep": dict(names=NAMES, max_events=BUDGET),
    "fig5_min_regs": dict(names=NAMES, max_events=BUDGET),
    "fig6_equal_area": dict(names=NAMES, max_events=BUDGET),
    "fig8_power": dict(names=NAMES, max_events=BUDGET),
    "pareto_frontier": dict(names=NAMES, max_events=BUDGET),
    "policy_headroom": dict(max_events=ROSTER_BUDGET),
    "ablation_sensitivity": dict(max_events=ROSTER_BUDGET),
    # the cluster suites, narrowed: each (L1 geometry, cores) point is one
    # compile of the reference's cluster engine
    "cluster_sweep": dict(names=("gemv",), cores=(1, 2), max_events=BUDGET),
    "dse": dict(names=("gemv",), cores=(1, 2), max_events=BUDGET),
}
# What a cluster suite's extra must hold equal to the reference's; the
# plan-group provenance (plan_group, fused, and the reference's bucket)
# and the engine-call counts differ on purpose
CLUSTER_EXTRA = {
    "cluster_sweep": ("cluster", "points", "plan_groups",
                      "fold_exact_fraction", "iso_budget_front",
                      "iso_area_front"),
    "dse": ("objectives", "macro_models", "cluster", "points",
            "plan_groups", "fold_exact_fraction", "fronts", "fronts_2d",
            "external_baseline", "iso_area_winners")}
PROVENANCE = ("plan_group", "bucket", "fused")


def _untimed(rows):
    return [{k: v for k, v in r.items() if k != "us_per_call"}
            for r in rows]


def _without_provenance(x):
    if isinstance(x, dict):
        return {k: _without_provenance(v) for k, v in x.items()
                if k not in PROVENANCE}
    if isinstance(x, list):
        return [_without_provenance(v) for v in x]
    return x


@pytest.fixture(scope="module")
def sessions():
    """One Session per package for the module, so each suite reuses the
    traces the earlier ones prepared, as a harness run does."""
    return japi.Session(), tapi.Session(device="cpu")


@pytest.mark.parametrize("suite", list(SUITES))
def test_suite_rows_equal_reference(suite, sessions):
    jses, tses = sessions
    ref = importlib.import_module(f"benchmarks.{suite}")
    port = importlib.import_module(f"repro_torch.benchmarks.{suite}")
    kw = SUITES[suite]
    if suite == "fig2_area_model":
        want, got = ref.run(), port.run()
    else:
        d0 = tses.dispatch_count()
        want = ref.run(session=jses, **kw)
        got = port.run(session=tses, **kw)
        assert tses.dispatch_count() > d0
    assert got
    assert _untimed(got) == _untimed(want)
    if suite in CLUSTER_EXTRA:
        jx, tx = ref.json_extra(), port.json_extra()
        for key in CLUSTER_EXTRA[suite]:
            assert _without_provenance(tx[key]) == _without_provenance(
                jx[key]), key
        assert "compiles" not in tx and tx["launches"] == {
            "engine_reg": 0, "engine_l1": 0, "cluster_l2": 0}
        geos = {g for g in tses.history[-1]["axes"]["l1_geometry"]}
        assert tx["dispatches"] == len(geos)


def test_fig4_pathfinder_capacity_3_at_paper_size(sessions):
    """The reference's own spot check of the engine: pathfinder's Fig 4
    row at capacity 3, at paper size, folded as the suite runs it."""
    from benchmarks import fig4_cvrf_sweep as jfig4
    from repro_torch.benchmarks import fig4_cvrf_sweep as tfig4
    jses, tses = sessions
    got = tfig4.run(names=["pathfinder"], session=tses)
    row = next(r for r in got if r["capacity"] == 3)
    assert (row["norm_perf"], row["hit_rate"], row["spills"],
            row["fills"]) == (0.5683, 0.5, 741, 868)
    want = jfig4.run(names=["pathfinder"], session=jses)
    assert _untimed(got) == _untimed(want)
