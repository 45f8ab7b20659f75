"""The port's front door (``repro_torch.api``: ``Sweep``, ``Session``,
``default_session``, ``sweep_program``) against the reference's, on the
CPU.

The same declarative sweep goes through the reference's ``Session.run``
(its JAX engine) and the port's (K1's plain twin, ``device="cpu"``) at
reduced size: every counter, ``hit_rate``, ``event_scale`` and
``fold_exact`` must be bitwise equal, the axes and the expanded label rows
equal.  The grids cover a capacity x policy product, zipped config points
with OPT and ``alloc_no_fetch``, two L1 geometries with M = 4 memory
latencies, folding with a refine (and an uncertified fold kept flagged
above the refine limit), folding off, and ``max_events`` truncation.  The
port's deliberate differences are pinned too: its plan has no shape
buckets, its ``meta`` has ``dispatches`` (one engine call per geometry
plus one per refined program) and ``launches`` but no ``compiles``, and
the reference's ``network`` axis raises until its slice lands (the
``cores`` axis is held in ``test_torch_cluster.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.benchmarks import common as tcommon  # noqa: E402
from repro_torch.core import policies  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402

# The reduced traces fold only after a short warm-up: with this L1 (8 sets
# x 2 ways, 32 warm-up lines) gemv, dropout, densenet121_l105 and
# resnet50_l10 fold, and gemv's fold does not certify, so it is refined.
FOLD_GEO = (8, 2)

CASES = {
    "capacity_x_policy": (
        dict(kernels=("pathfinder", "gemv", "dropout"),
             capacity=(3, 4, 8, 32), policy=("fifo", "lru")), {}),
    "config_points_opt_alloc_no_fetch": (
        dict(kernels=("gemv", "densenet121_l105"),
             config_points=(japi.ConfigPoint(4, policies.FIFO),
                            (4, policies.OPT), (4, policies.FIFO, True),
                            dict(capacity=6, policy="lfu"),
                            (8, policies.OPT, True))), {}),
    "two_geometries_m4": (
        dict(kernels=("gemv", "dropout"), capacity=(4, 8, 32),
             mem_latency=(1, 3, 5, 10), l1_geometry=((256, 2), FOLD_GEO)),
        {}),
    "fold_with_refine": (
        dict(kernels=("gemv", "dropout", "resnet50_l10"), capacity=(4, 32),
             policy=("fifo", "opt"), l1_geometry=(FOLD_GEO,)), {}),
    "fold_kept_above_refine_limit": (
        dict(kernels=("gemv", "dropout"), capacity=(4, 32),
             l1_geometry=(FOLD_GEO,)), dict(refine_max_rows=200)),
    "fold_off": (
        dict(kernels=("gemv", "dropout", "resnet50_l10"), capacity=(4, 32),
             l1_geometry=(FOLD_GEO,), fold=False), {}),
    "max_events": (
        dict(kernels=("dropout", "gemv"), capacity=(3, 8, 32),
             max_events=150), {}),
}


def _port_sweep(kw):
    """The case's sweep with the port's axis value types."""
    kw = dict(kw)
    if "config_points" in kw:
        kw["config_points"] = tuple(
            tapi.ConfigPoint(*dataclasses.astuple(p))
            if isinstance(p, japi.ConfigPoint) else p
            for p in kw["config_points"])
    return tapi.Sweep(kernel_params="reduced", **kw)


def _assert_same_result(want, got):
    """Axes, labels and every data array equal, dtypes included."""
    assert [a.name for a in got.axes] == [a.name for a in want.axes]
    for a, b in zip(want.axes, got.axes):
        assert [repr(v) for v in b.values] == [repr(v) for v in a.values]
    assert got.shape == want.shape
    assert set(got.data) == set(want.data)
    for k, w in want.data.items():
        g = got.data[k]
        assert np.asarray(g).dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert got.to_rows() == want.to_rows()
    for key in ("axes", "points", "kernel_params", "fold"):
        assert got.meta[key] == want.meta[key], key


@pytest.fixture
def fresh_port_session():
    """A fresh process-default port Session on the CPU for one test; the
    previous default is restored afterwards."""
    old = tapi._DEFAULT_SESSION
    ses = tapi.reset_default_session(device="cpu")
    yield ses
    tapi._DEFAULT_SESSION = old


@pytest.mark.parametrize("case", list(CASES))
def test_session_run_matches_reference(case):
    kw, session_kw = CASES[case]
    want = japi.Session(**session_kw).run(
        japi.Sweep(kernel_params="reduced", **kw))
    ses = tapi.Session(device="cpu", **session_kw)
    sweep = _port_sweep(kw)
    got = ses.run(sweep)
    _assert_same_result(want, got)

    # the plan: one engine call per L1 geometry with every kernel in it
    assert got.meta["plan"] == [
        dict(l1_geometry=str(g), kernels=list(sweep.kernels), fused=False)
        for g in sweep.l1_geometry]
    assert "compiles" not in got.meta
    assert got.meta["launches"] == {"engine_reg": 0, "engine_l1": 0,
                                    "cluster_l2": 0}
    assert got.meta["device"] == "cpu"
    # ... plus one per refined program: those whose fold did not certify
    # somewhere on the grid and that fit under the refine limit
    folded = tapi.Session(device="cpu", refine=False, **session_kw).run(
        sweep)
    gi = [a.name for a in sweep.axes()].index("l1_geometry")
    exact = np.moveaxis(folded["fold_exact"], gi, 0).reshape(
        len(sweep.l1_geometry), len(sweep.kernels), -1).all(-1)
    refine = ses.refine and sweep.max_events is None and (
        sweep.fold is not False)
    rows = [ses.built(n, "reduced").program.num_instructions
            for n in sweep.kernels]
    refined = sum(int(not ok and r <= ses.refine_max_rows)
                  for geo in exact for ok, r in zip(geo, rows)) if refine \
        else 0
    assert got.meta["dispatches"] == len(sweep.l1_geometry) + refined
    assert ses.dispatch_count() == got.meta["dispatches"]
    if case == "fold_with_refine":
        assert refined == 1 and not exact.all()
        assert bool(got["fold_exact"].all())
    if case == "fold_kept_above_refine_limit":
        assert refined == 0 and not bool(got["fold_exact"].all())


def test_fused_twin_matches_per_program():
    """batch_programs=True (one engine call over every program, the card's
    default) gives the per-program counters on the CPU too."""
    kw = CASES["two_geometries_m4"][0]
    per = tapi.Session(device="cpu").run(_port_sweep(kw))
    fused = tapi.Session(device="cpu", batch_programs=True).run(
        _port_sweep(kw))
    assert all(p["fused"] for p in fused.meta["plan"])
    for k in per.data:
        np.testing.assert_array_equal(fused[k], per[k], err_msg=k)


def test_grid_matches_run():
    """Session.grid (the legacy-shaped call) equals the run's to_grid view
    of the same sweep, fold certificates included."""
    kw = dict(kernels=("gemv", "dropout"), capacity=(4, 32),
              mem_latency=(1, 10), l1_geometry=(FOLD_GEO,))
    ses = tapi.Session(device="cpu")
    got = ses.grid(kw["kernels"], tsim.SweepConfig.make([4, 32]),
                   machine=tsim.MachineSweep.make((1, 10), l1_sets=8,
                                                  l1_ways=2),
                   params="reduced")
    run = ses.run(_port_sweep(kw)).to_grid()
    assert set(got) == set(run)
    for k in run:
        np.testing.assert_array_equal(got[k], run[k], err_msg=k)


def test_unknown_kernel_raises_with_menu():
    with pytest.raises(KeyError, match="unknown kernel 'nope'.*dropout"):
        tapi.Session(device="cpu").run(tapi.Sweep(kernels=["nope"]))
    with pytest.raises(ValueError, match="at least one kernel"):
        tapi.Sweep(kernels=())
    with pytest.raises(ValueError, match="kernel_params"):
        tapi.Session(device="cpu").built("gemv", params="tiny")


def test_unported_axes_raise():
    with pytest.raises(NotImplementedError, match="P6"):
        tapi.Sweep(kernels=["gemv"], network=("phi3-mini-3.8b",))
    assert tapi.Sweep(kernels=["gemv"], cores=1).cores == (1,)


def test_card_is_the_default():
    """Session() runs on the card; without one it raises instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: Session() runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.Session()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.sweep_program(
            tapi.Session(device="cpu").built("dropout", "reduced").program,
            tsim.SweepConfig.make([4]))
    ses = tapi.Session(device="cpu")
    assert ses.device.type == "cpu" and ses.batch_programs is False
    assert not hasattr(ses, "compile_count")


def test_sessions_share_nothing():
    s1, s2 = tapi.Session(device="cpu"), tapi.Session(device="cpu")
    b1 = s1.built("dropout", params="reduced")
    b2 = s2.built("dropout", params="reduced")
    assert b1 is not b2                      # independent build caches
    assert s1.built("dropout", params="reduced") is b1   # but each caches
    p1 = s1.prepared("dropout", params="reduced")
    assert s1.prepared("dropout", params="reduced") is p1
    assert not s2._prepared                  # s2 never prepared anything
    assert s1.prepare_seconds() > 0 and s2.prepare_seconds() == 0
    s1.run(tapi.Sweep(kernels=["dropout"], kernel_params="reduced"))
    assert s1.dispatch_count() == 1 and s2.dispatch_count() == 0
    s1.reset()
    assert not s1._built and not s1._prepared and not s1.history
    assert s1.dispatch_count() == 0 and s1.prepare_seconds() == 0
    assert s2.built("dropout", params="reduced") is b2   # s2 unaffected


def test_default_session_resettable(fresh_port_session):
    ses = fresh_port_session
    assert tapi.default_session() is ses
    assert not ses._built
    b = ses.built("dropout", params="reduced")
    assert ses._built
    fresh = tapi.reset_default_session(device="cpu")
    assert tapi.default_session() is fresh and fresh is not ses
    assert not fresh._built
    assert ses.built("dropout", params="reduced") is b   # old one intact


def test_sweep_result_accessors():
    geos = (tapi.L1Geometry(sets=48, ways=3), tapi.L1Geometry(sets=96,
                                                              ways=3))
    res = tapi.Session(device="cpu", refine=False).run(tapi.Sweep(
        kernels=("dropout", "gemv"), capacity=(4, 8),
        mem_latency=(1, 5), uop_hit_cycles=(1, 2), l1_geometry=geos,
        kernel_params="reduced"))
    assert res.shape == (2, 2, 1, 1, 2, 2, 1, 2)
    rows = res.to_rows()
    assert len(rows) == np.prod(res.shape) == res.meta["points"]
    r0 = rows[0]
    assert r0["kernel"] == "dropout" and r0["policy_name"] == "fifo"
    assert r0["l1_sets"] == 48 and r0["l1_ways"] == 3
    assert isinstance(r0["cycles"], int)
    assert res.select(kernel="gemv", mem_latency=[1, 5]).shape == (
        1, 2, 1, 1, 2, 2, 1, 2)
    assert res.select(policy="fifo").shape == res.shape
    assert res.select(capacity=(4, 8)).shape == res.shape  # tuple == multi
    assert res.select(l1_geometry=(48, 3)).shape[4] == 1
    np.testing.assert_array_equal(
        res.array("cycles", kernel="gemv", l1_geometry=geos[0]),
        res["cycles"][1, :, 0, 0, 0].squeeze())
    with pytest.raises(KeyError, match="unknown axis"):
        res.select(not_an_axis=3)
    with pytest.raises(ValueError, match="no point"):
        res.select(capacity=99)
    with pytest.raises(ValueError, match="pin every"):
        res.value("cycles", kernel="gemv")
    with pytest.raises(ValueError, match="single L1 geometry"):
        res.to_grid()


def test_config_points_zipped_axis():
    pts = [tapi.ConfigPoint(4, policies.FIFO),
           tapi.ConfigPoint(4, policies.LRU),
           (4, policies.FIFO, True),
           dict(capacity=8, policy="opt")]
    res = tapi.Session(device="cpu", refine=False).run(tapi.Sweep(
        kernels=["dropout"], config_points=pts, kernel_params="reduced"))
    assert [a.name for a in res.axes][1] == "config"
    assert res.shape[1] == 4
    assert res.select(capacity=4).shape[1] == 3
    assert res.select(policy="lru").shape[1] == 1
    assert res.select(capacity=[4, 8]).shape[1] == 4     # field multi-select
    assert res.select(policy=["fifo", "lru"]).shape[1] == 3
    v = res.value("cycles", capacity=4, policy=policies.FIFO,
                  alloc_no_fetch=True)
    assert isinstance(v, int)
    row = res.select(policy="opt").to_rows()[0]
    assert row["capacity"] == 8 and row["policy_name"] == "opt"


def test_sweep_program_and_deprecated_simulate_sweep():
    from repro.core import simulator as jsim
    prog = tapi.Session(device="cpu").built("dropout", "reduced").program
    jprog = japi.Session().built("dropout", "reduced").program
    machines = tsim.MachineSweep.make((1, 5))
    new = tapi.sweep_program(prog, tsim.SweepConfig.make([4, 32]),
                             machine=machines, device="cpu")
    want = japi.sweep_program(jprog, jsim.SweepConfig.make([4, 32]),
                              machine=jsim.MachineSweep.make((1, 5)))
    assert new.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(new[k], want[k], err_msg=k)
    with pytest.warns(DeprecationWarning, match="simulate_sweep"):
        old = tsim.simulate_sweep(prog, tsim.SweepConfig.make([4, 32]),
                                  machine=machines, device="cpu")
    assert old.keys() == new.keys()
    for k in old:
        np.testing.assert_array_equal(old[k], new[k], err_msg=k)


def test_deprecated_prepared_for_max_events(fresh_port_session):
    with pytest.warns(DeprecationWarning, match="max_events"):
        prep = tcommon.prepared_for("dropout", max_events=500)
    # delegates into the default session's cache ...
    assert prep is fresh_port_session.prepared("dropout", max_events=500)
    # ... and matches the direct-prepare path bit for bit.
    legacy = tsim.prepare(tcommon.built("dropout").program, fold=False,
                          max_events=500)
    assert prep.num_rows == legacy.num_rows
    assert prep.event_scale == legacy.event_scale
    np.testing.assert_array_equal(prep.ev.cost, legacy.ev.cost)
    np.testing.assert_array_equal(prep.weight, legacy.weight)
    out = tcommon.sweep_grid(["dropout"], tsim.SweepConfig.make([4, 32]),
                             max_events=500)
    assert out["event_scale"][0, 0] == legacy.event_scale
