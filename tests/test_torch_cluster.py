"""The port's cluster (``repro_torch.cluster``, with K2's plain versions in
``repro_torch.kernels.cluster_scan``) against the reference's
``repro.cluster``, on the CPU.

The contention primitives on the reference's own cases; the cluster
engine (the twin, ``simulate_cluster_grid(..., device="cpu")``) bitwise
equal to the reference's on every output key, ``per_core`` included, over
reduced gemv, dropout and a small flashattention2, folded and unfolded,
FIFO/LRU/OPT with and without ``alloc_no_fetch`` and the full VRF, at N =
1, 2, 4 and 8 behind every kind of shared memory (none, the passthrough,
small and odd L2s); the N = 1 passthrough equal to ``simulate_grid``; the
affine check; the split's plain composition (what K2 is held to on the
card) equal to the twin, also where a program's shifted lines leave
[0, 2^31); the shift invariance K2 stands on, pinned on both packages;
the plan, the wrapper's arguments and the ``Session.run`` cluster branch.
"""

import contextlib
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro import cluster as jcl  # noqa: E402
from repro import rvv as jrvv  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import cluster as tcl  # noqa: E402
from repro_torch import rvv as trvv  # noqa: E402
from repro_torch.cluster.engine import _stride  # noqa: E402
from repro_torch.core import policies  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.kernels import cluster_scan as k2  # noqa: E402
from repro_torch.kernels import engine_scan as k1  # noqa: E402

SRC = Path(k2.__file__).resolve().parent / "csrc" / "cluster_scan.cu"
# A flashattention2 small enough for the twin, whose fold is not
# certifiable (16 folds of 1,560 rows)
FA2_SMALL = dict(seq=8, d=16, bc=8)
PROGRAMS = {"gemv": "reduced", "dropout": "reduced",
            "flashattention2": FA2_SMALL}
CAPS = (3, 4, 32)
POLICIES = (policies.FIFO, policies.LRU, policies.OPT)
MEM = (5, 9)
# (name, n_cores, ClusterConfig fields other than n_cores); "passthrough"
# is ClusterConfig.passthrough(n)
SHARED = {"default": {}, "passthrough": None,
          "no_l2": dict(l2_sets=0, l2_ways=2, mem_channels=2),
          "l2_64x2": dict(l2_sets=64, l2_ways=2, mem_channels=1),
          "l2_32x3": dict(l2_sets=32, l2_ways=3, mem_channels=3)}
# Every shared memory at N = 1, 2 and 4, folded and unfolded; each case is
# one compile of the reference's engine, so they are few (N = 8 is held
# against the twin below and on the card)
CASES = [
    ("unfolded", 1, "passthrough", ("gemv", "dropout")),
    ("folded", 1, "default", ("gemv", "dropout", "flashattention2")),
    ("unfolded", 2, "l2_64x2", ("gemv", "dropout", "flashattention2")),
    ("folded", 2, "no_l2", ("gemv", "dropout")),
    ("unfolded", 4, "l2_32x3", ("gemv", "dropout")),
    ("folded", 4, "l2_64x2", ("dropout",)),
]


def _config(pkg, n, shared):
    fields = SHARED[shared]
    if fields is None:
        return pkg.ClusterConfig.passthrough(n)
    return pkg.ClusterConfig(n_cores=n, **fields)


def _program(rvv, name):
    b = rvv.BENCHMARKS[name]
    params = PROGRAMS[name]
    return b.build(**(b.reduced_params if params == "reduced" else params)
                   ).program


def _prep(sim, rvv, name, fold):
    p = _program(rvv, name)
    return sim.prepare(p, fold=True, warm_lines=16) if fold else \
        sim.prepare(p)


def _sweeps(sim):
    sweep = sim.SweepConfig.product(CAPS, POLICIES, (False, True))
    machines = sim.MachineSweep.from_params(
        [sim.MachineParams(mem_latency=m, l1_sets=16, l1_ways=2)
         for m in MEM])
    return sweep, machines


@pytest.fixture(scope="module")
def preps():
    return {(pkg, name, fold): _prep(sim, rvv, name, fold)
            for pkg, sim, rvv in (("jax", jsim, jrvv), ("torch", tsim, trvv))
            for name in PROGRAMS for fold in (False, True)}


@pytest.fixture(scope="module")
def cases(preps):
    """Each case's reference and port results, computed once."""
    out = {}
    for case in CASES:
        fold, n, shared, names = case
        folded = fold == "folded"
        got = []
        for pkg, sim, cl, kw in (
                ("jax", jsim, jcl, dict(batch_programs=True)),
                ("torch", tsim, tcl, dict(device="cpu"))):
            sweep, machines = _sweeps(sim)
            got.append(cl.simulate_cluster_grid(
                [preps[(pkg, name, folded)] for name in names], sweep,
                machines, _config(cl, n, shared), return_per_core=True,
                **kw))
        out[case] = tuple(got)
    return out


# -- the contention primitives -------------------------------------------------

def test_rank_order_is_the_references_fair_rotation():
    n = 4
    first = []
    for t in range(2 * n):
        got = tcl.rank_order(n, t)
        assert got.tolist() == np.asarray(jcl.rank_order(n, t)).tolist()
        first.append(int(got[0]))
    for core in range(n):
        assert first[:n].count(core) == 1 and first[n:].count(core) == 1


@pytest.mark.parametrize("reqs,channels", [
    ([3, 1, 0, 2], 2), ([7], 1), ([1, 1, 1], 8), ([8, 0, 5, 8, 1], 3)])
def test_queue_rounds_equal_the_references(reqs, channels):
    got = tcl.queue_rounds(torch.tensor(reqs, dtype=torch.int32), channels)
    want = jcl.queue_rounds(np.asarray(reqs, np.int32), channels)
    assert got.tolist() == np.asarray(want).tolist()
    if (reqs, channels) == ([3, 1, 0, 2], 2):
        assert got.tolist() == [0, 1, 2, 2]


def test_l2_access_lru_allocate_and_inactive():
    l2, jl2 = tcl.l2_init(2, 2), jcl.l2_init(2, 2)
    hits = []
    for clock, line in enumerate((0, 2, 0, 4, 2), start=1):
        l2, h = tcl.l2_access(l2, line, clock, 2)
        jl2, jh = jcl.l2_access(jl2, line, clock, 2)
        hits.append(bool(h))
        assert bool(h) == bool(jh)
        assert l2.tolist() == np.asarray(jl2).tolist()
    assert hits == [False, False, True, False, False]
    before = l2.clone()
    l2, h = tcl.l2_access(l2, -1, 6, 2)
    assert not bool(h) and torch.equal(l2, before)


def test_l2_access_per_lane_equals_one_lane_at_a_time():
    rng = np.random.default_rng(0)
    lanes, sets, ways = 5, 4, 3
    batch = tcl.l2_init(sets, ways, lanes)
    one = [tcl.l2_init(sets, ways) for _ in range(lanes)]
    for clock in range(1, 60):
        line = rng.integers(-2, 20, lanes).astype(np.int32)
        _, hit = tcl.l2_access(batch, torch.as_tensor(line),
                               torch.full((lanes,), clock), sets)
        for i in range(lanes):
            _, h = tcl.l2_access(one[i], int(line[i]), clock, sets)
            assert bool(h) == bool(hit[i])
    assert torch.equal(batch, torch.stack(one))


def test_cluster_config_validation_and_passthrough():
    with pytest.raises(ValueError, match="n_cores"):
        tcl.ClusterConfig(n_cores=0)
    with pytest.raises(ValueError, match="mem_channels"):
        tcl.ClusterConfig(mem_channels=0)
    with pytest.raises(ValueError, match="l2_sets"):
        tcl.ClusterConfig(l2_sets=3)
    assert tcl.ClusterConfig(l2_sets=256).l2_bytes == 256 * 4 * 32
    for n in (1, 4):
        assert (tcl.ClusterConfig.passthrough(n).__dict__
                == jcl.ClusterConfig.passthrough(n).__dict__)
    assert tcl.CLUSTER_COUNTER_NAMES == jcl.CLUSTER_COUNTER_NAMES
    assert tcl.CORE_CYCLE_AGGREGATES == jcl.CORE_CYCLE_AGGREGATES
    assert set(tcl.__all__) == set(jcl.__all__)


def test_strides_equal_the_references(preps):
    from repro.cluster.engine import _stride as jstride
    for name in PROGRAMS:
        for fold in (False, True):
            assert _stride(preps[("torch", name, fold)]) == jstride(
                preps[("jax", name, fold)])


# -- the engine against the reference ------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    (c[0], f"n{c[1]}", c[2], "+".join(c[3]))))
def test_simulate_cluster_grid_equals_the_reference(case, cases):
    want, got = cases[case]
    assert set(got) == set(want)
    for key in want:
        if key == "per_core":
            continue
        w, g = np.asarray(want[key]), np.asarray(got[key])
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)
    assert set(got["per_core"]) == set(want["per_core"])
    for key, w in want["per_core"].items():
        np.testing.assert_array_equal(got["per_core"][key], np.asarray(w),
                                      err_msg=key)


def test_n1_passthrough_equals_simulate_grid(cases, preps):
    """The N = 1 passthrough cluster gives the single-core engine's
    counters bitwise, contention zero (the reference's golden pin)."""
    names = CASES[0][3]
    got = cases[CASES[0]][1]
    sweep, machines = _sweeps(tsim)
    single = tsim.simulate_grid([preps[("torch", n, False)] for n in names],
                                sweep, machines, device="cpu")
    for key in tsim.COUNTER_NAMES:
        np.testing.assert_array_equal(got[key], single[key], err_msg=key)
    for key in ("contention_stalls", "l2_hits"):
        assert not got[key].any()


def test_shift_invariance_on_both_packages(cases, preps):
    """Every core's single-core counters but cycles (stall_cycles through
    mem_writes) equal core 0's and the single-core engine's, on the
    reference's outputs and the port's: the shift invariance K2 runs on."""
    for case in CASES:
        fold, n, _, names = case
        if n == 1:
            continue
        sweep, machines = _sweeps(tsim)
        single = tsim.simulate_grid(
            [preps[("torch", m, fold == "folded")] for m in names], sweep,
            machines, device="cpu")
        for res in cases[case]:
            for key in tsim.COUNTER_NAMES[1:]:
                per = np.asarray(res["per_core"][key])     # (P, C, M, N)
                assert (per == per[..., :1]).all(), (case, key)
                np.testing.assert_array_equal(per[..., 0], single[key])


def test_cluster_affine_on_a_latency_sweep(preps):
    machines = tsim.MachineSweep.from_params(
        [tsim.MachineParams(mem_latency=m, l1_sets=8, l1_ways=1)
         for m in (5, 9, 13)])
    jmachines = jsim.MachineSweep.from_params(
        [jsim.MachineParams(mem_latency=m, l1_sets=8, l1_ways=1)
         for m in (5, 9, 13)])
    kw = dict(l2_sets=64, l2_ways=2, mem_channels=1)
    sweep = tsim.SweepConfig.make([4], policies.LRU)
    jsweep = jsim.SweepConfig.make([4], policies.LRU)
    got = tcl.simulate_cluster_grid(
        [preps[("torch", "gemv", False)]], sweep, machines,
        tcl.ClusterConfig(n_cores=4, **kw), return_per_core=True,
        device="cpu")
    want = jcl.simulate_cluster_grid(
        [preps[("jax", "gemv", False)]], jsweep, jmachines,
        jcl.ClusterConfig(n_cores=4, **kw), return_per_core=True)
    coeffs = tcl.check_cluster_affine(got["per_core"], machines)
    jcoeffs = jcl.check_cluster_affine(want["per_core"], jmachines)
    assert coeffs["cycles"].shape == (1, 1, 4, 4)
    assert set(coeffs) == set(jcoeffs)
    for key in coeffs:
        np.testing.assert_array_equal(coeffs[key], jcoeffs[key])
    pc = got["per_core"]
    assert (pc["contention_stalls"][0, 0] > 0).all()
    floor = pc["l1_misses"][0, 0, 0] - pc["l2_hits"][0, 0, 0]
    assert (coeffs["cycles"][0, 0, :, 3] >= floor).all()


# -- the split (K2's oracle on the card) against the twin ----------------------

def _inputs(preps_, names, fold):
    ps = [preps_[("torch", n, fold)] for n in names]
    arrays, spill0s = tsim._stack(ps)
    sweep, machines = _sweeps(tsim)
    return (k1.pack(arrays), torch.as_tensor(spill0s),
            [_stride(p) for p in ps],
            (sweep.capacity, sweep.policy, sweep.alloc_no_fetch),
            (machines.l1_hit_cycles, machines.uop_hit_cycles,
             machines.mem_latency), [p.num_rows for p in ps])


ALL_SHARED = [_config(tcl, n, shared) for n, shared in (
    (1, "passthrough"), (2, "l2_64x2"), (4, "l2_32x3"), (8, "no_l2"))] + [
    tcl.ClusterConfig(n_cores=8, l2_sets=256, l2_ways=4, mem_channels=2)]


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "folded"])
def test_split_equals_the_twin(fold, preps):
    """K1's plain halves then cluster_l2_plain, for every cluster point
    from one K1 run, equal the twin's per-core counters, all three
    counter sets."""
    x, sp0, strides, cfg, mach, lengths = _inputs(
        preps, ("gemv", "dropout"), fold)
    kw = dict(l1_sets=16, l1_ways=2, track_ab=fold, lengths=lengths)
    want = k2.cluster_scan_plain(x, sp0, strides, cfg, mach, ALL_SHARED,
                                 **kw)
    got = k2.cluster_split_plain(x, sp0, strides, cfg, mach, ALL_SHARED,
                                 **kw)
    assert all(k2.address_invariant(x, sp0, strides, lengths, 8))
    for cl, w, g in zip(ALL_SHARED, want, got):
        assert g[0].shape == (2, 18, 2, cl.n_cores, 15)
        for a, b in zip(w, g):
            assert torch.equal(a, b), cl


def test_split_walks_each_core_where_the_shift_leaves_the_range(preps):
    """Lines that are negative, or that pass 2^31 once shifted, break the
    shift invariance: the plan gives such a program one K1b lane per core
    (each with its own base) and the split still equals the twin."""
    x, sp0, strides, cfg, mach, lengths = _inputs(
        preps, ("gemv", "dropout"), False)
    x[0, :, k1.ML:k1.ML + 2] -= 40
    sp0 = sp0.clone()
    sp0[1] = 2 ** 31 - 3 * strides[1] - 20
    assert k2.address_invariant(x, sp0, strides, lengths, 4) == [False,
                                                                 False]
    clusters = [tcl.ClusterConfig(n_cores=4, l2_sets=32, l2_ways=3,
                                  mem_channels=3), tcl.ClusterConfig()]
    kw = dict(l1_sets=16, l1_ways=2, track_ab=False, lengths=lengths)
    plan = k2.cluster_scan_plan(16, 2, lengths, cfg, clusters,
                                strides=strides, invariant=[False, False])
    lanes = plan["groups"][0]["l1_lanes"]
    assert [base for p, k, _, base in lanes if p == 1 and k == 0] == [
        k1._i32(c * strides[1]) for c in range(4)]
    want = k2.cluster_scan_plain(x, sp0, strides, cfg, mach, clusters, **kw)
    got = k2.cluster_split_plain(x, sp0, strides, cfg, mach, clusters, **kw)
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            assert torch.equal(a, b)


# -- the plan and the wrapper ---------------------------------------------------

def _plan(clusters, lengths=(100, 50), invariant=(True, True), **kw):
    cfg = (np.asarray([3, 32, 4, 3]), np.asarray([0, 0, 1, 0]),
           np.zeros(4, bool))
    return k2.cluster_scan_plan(16, 2, list(lengths), cfg, clusters,
                                strides=[101, 77], invariant=list(invariant),
                                **kw)


def test_plan_shares_one_k1_lane_per_class_across_core_counts():
    clusters = [tcl.ClusterConfig(n_cores=n, l2_sets=64, l2_ways=2)
                for n in (1, 2, 8)]
    plan = _plan(clusters)
    (g,) = plan["groups"]
    # classes: capacity 3 FIFO (configs 0 and 3), the full VRF, 4 LRU
    assert plan["classes"] == [0, -1, 2, 0]
    assert g["reg_lanes"] == [(0, 0), (0, 2), (1, 0), (1, 2)]
    assert len(g["l1_lanes"]) == 6 and all(b == 0 for *_, b in
                                           g["l1_lanes"])
    assert len(g["k1_outputs"]) == 8
    assert len(g["k2_lanes"]) == 2 * 3 * 3
    p, k, i, l1s, shifts = g["k2_lanes"][2]
    assert (p, k, i) == (0, 0, 2) and l1s == [0] * 8
    assert shifts == [c * 101 for c in range(8)]
    assert len(g["k2_outputs"]) == 2 * 4 * 3
    assert plan["tile"]["way_slots"] == 2 and plan["l2_sets"] == 64


def test_plan_groups_whole_programs_under_the_budget(monkeypatch):
    clusters = [tcl.ClusterConfig(n_cores=4, l2_sets=64, l2_ways=2)]
    one = _plan(clusters)["groups"][0]["bytes"]
    monkeypatch.setattr(k1, "STREAM_BUDGET_BYTES", sum(one.values()) // 2)
    groups = _plan(clusters)["groups"]
    assert len(groups) == 2
    assert {p for p, *_ in groups[0]["k2_lanes"]} == {0}
    assert groups[1]["k2_outputs"][0][3] == 0      # renumbered per group


@pytest.mark.parametrize("cluster,match", [
    (tcl.ClusterConfig(n_cores=9), "1..8 cores"),
    (tcl.ClusterConfig(l2_sets=64, l2_ways=33), "32 L2 ways"),
    (tcl.ClusterConfig(l2_sets=1 << 15, l2_ways=2), "bucketing")])
def test_plan_refuses_what_k2_does_not_take(cluster, match):
    with pytest.raises(ValueError, match=match):
        _plan([cluster])


def test_plan_constants_match_the_c_source():
    text = SRC.read_text()
    for py, c in (("K2_TILE_CANDIDATES", "TILE_CANDS"),
                  ("K2_HIST_WARPS", "HIST_WARPS"),
                  ("K2_WALK_THREADS", "WALK_THREADS"),
                  ("K2_SCAN_CTAS", "SCAN_CTAS"),
                  ("MAX_CORES", "MAX_CORES"), ("K2_SUMS", "NSUM")):
        m = re.search(rf"constexpr int {c} = (\d+);", text)
        assert int(m.group(1)) == getattr(k2, py), py
    assert re.search(r"constexpr int NCL = (\d+);", text).group(1) == str(
        k2.CLUSTER_COUNTERS)


@pytest.mark.parametrize("name", sorted(k2.ARGTYPES))
def test_ctypes_argtypes_match_the_c_entry_points(name):
    decl = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)",
                     SRC.read_text())
    params = [p.strip() for p in decl.group(1).split(",")]
    argtypes = k2.ARGTYPES[name]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        assert ("*" in p) == (t is ctypes.c_void_p), (name, p)
        if t is ctypes.c_int:
            assert p.startswith("int "), (name, p)
        if t is ctypes.c_longlong:
            assert p.startswith("long long "), (name, p)


@pytest.fixture
def fake_launches(monkeypatch):
    """Every C entry point faked on the CPU: checks its arguments against
    the ctypes signature and answers with rc[0]; the wrappers' device
    checks pass CPU tensors through."""
    calls, rc = [], [0]

    def launch(x, entry, *args, library=None):
        sig = (k2.ARGTYPES if library is k2._library else k1.ARGTYPES)[entry]
        assert len(args) + 1 == len(sig), entry
        for a, t in zip(args, sig):
            assert isinstance(a, int) or (a is None and t is ctypes.c_void_p)
        calls.append(entry)
        if rc[0] == -1:
            raise ValueError(f"{entry}: the kernel refused its arguments")
        if rc[0]:
            raise RuntimeError(f"{entry} failed: cudaError {rc[0]}")

    for mod in (k1, k2):
        monkeypatch.setattr(mod, "_launch", launch)
        monkeypatch.setattr(mod, "_rows_on_card", lambda x, who: x)
    yield calls, rc


@pytest.mark.parametrize("rc,exc", [(0, None), (-1, ValueError),
                                    (700, RuntimeError)])
def test_card_path_launches_k1_then_k2_and_counts_only_success(
        fake_launches, rc, exc, preps):
    calls, set_rc = fake_launches
    x, sp0, strides, cfg, mach, lengths = _inputs(preps, ("gemv",), False)
    before = k2.cluster_l2_cuda.launches
    set_rc[0] = rc
    clusters = [tcl.ClusterConfig(n_cores=2, l2_sets=64, l2_ways=2),
                tcl.ClusterConfig(n_cores=8)]
    with contextlib.ExitStack() as stack:
        if exc:
            stack.enter_context(pytest.raises(exc))
        out = k2._cluster_run(
            x, sp0, strides, cfg, mach, clusters, l1_sets=16, l1_ways=2,
            track_ab=False, lengths=lengths, reg_fn=k1.engine_reg_cuda,
            l1_fn=k1.engine_l1_cuda, k2_fn=k2.cluster_l2_cuda)
    assert calls == ["engine_reg_launch"] + ([] if exc else [
        "engine_l1_launch", "cluster_l2_launch"])
    assert k2.cluster_l2_cuda.launches - before == (0 if exc else 1)
    assert k2.cluster_l2_cuda.by_route().keys() == {"l2set"}
    if not exc:
        assert [o[0].shape for o in out] == [(1, 18, 2, 2, 15),
                                             (1, 18, 2, 8, 15)]


# -- Session.run's cluster branch -----------------------------------------------

_GEOS = (4, 16)


def _session_sweep(api, pkg, geos, **kw):
    # An L2 no test of the reference uses: its Session compiles once per
    # shape and process, and tests/test_cluster.py counts the compiles of
    # its own shape, whichever worker runs both files.
    return api.Sweep(
        kernels=("gemv",), capacity=(3, 5),
        l1_geometry=tuple(api.L1Geometry.from_kbytes(kb) for kb in geos),
        cores=(1, 2), cluster=pkg.ClusterConfig(l2_sets=16, l2_ways=3,
                                                mem_channels=3),
        kernel_params="reduced", fold=False, **kw)


@pytest.fixture(scope="module")
def session_runs():
    """The port's cluster sweep over two geometries, the reference's over
    the first (each of its (geometry, cores) points is a compile), and
    the port's single-core sweep."""
    tses = tapi.Session(device="cpu")
    got = tses.run(_session_sweep(tapi, tcl, _GEOS))
    want = japi.Session(batch_programs=False).run(
        _session_sweep(japi, jcl, _GEOS[:1]))
    single = tses.run(tapi.Sweep(
        kernels=("gemv",), capacity=(3, 5),
        l1_geometry=tuple(tapi.L1Geometry.from_kbytes(kb) for kb in _GEOS),
        kernel_params="reduced", fold=False))
    return got, want, single


def test_session_plans_one_engine_call_per_geometry_for_every_core_count(
        session_runs):
    got, want, _ = session_runs
    plan = got.meta["plan"]
    assert [(g["l1_geometry"], g["cores"]) for g in plan] == [
        (geo, n) for geo in ("4KB/2w", "16KB/2w") for n in (1, 2)]
    assert [(g["l1_geometry"], g["cores"]) for g in plan[:2]] == [
        (g["l1_geometry"], g["cores"]) for g in want.meta["plan"]]
    assert all("bucket" not in g for g in plan)
    assert [g["engine_call"] for g in plan] == [0, 0, 1, 1]
    assert got.meta["dispatches"] == len(_GEOS)
    assert got.meta["launches"] == {"engine_reg": 0, "engine_l1": 0,
                                    "cluster_l2": 0}
    assert "compiles" not in got.meta
    assert got.meta["cluster"] == want.meta["cluster"]
    assert got.axis("cores").values == (1, 2)


def test_session_cluster_grid_equals_the_reference(session_runs):
    got, want, single = session_runs
    assert [a.name for a in got.axes] == [a.name for a in want.axes]
    assert set(got.data) == set(want.data)
    first = got.select(l1_geometry=tapi.L1Geometry.from_kbytes(_GEOS[0]))
    for key, w in want.data.items():
        np.testing.assert_array_equal(first.data[key], w, err_msg=key)
    # the N = 1 slice of the cluster grid is the single-core sweep
    np.testing.assert_array_equal(got.data["cycles"][:, :, :, :, :, 0],
                                  single.data["cycles"])
    assert first.to_rows(["cycles", "l2_hits"]) == want.to_rows(
        ["cycles", "l2_hits"])


def test_session_refines_failing_folds_per_kernel_and_cores():
    """Folded on an 8-set direct-mapped L1, the small flashattention2's
    certificate fails (its fold is not certifiable), so each cores point
    is re-run unfolded, one more engine call each: the grid is the
    unfolded sweep's, as the reference's refine makes it."""
    kw = dict(kernels=("flashattention2",), capacity=(3,),
              l1_geometry=((8, 1),), cores=(1, 2),
              cluster=tcl.ClusterConfig(l2_sets=64, l2_ways=2),
              kernel_params=FA2_SMALL)
    tses = tapi.Session(device="cpu")
    folded = tses.prepared("flashattention2", fold=True, params=FA2_SMALL,
                           machine=tsim.MachineParams(l1_sets=8, l1_ways=1))
    assert folded.num_folds and not folded.certifiable
    got = tses.run(tapi.Sweep(fold=True, **kw))
    assert got.meta["dispatches"] == 1 + 2
    assert got.data["fold_exact"].all()
    want = tses.run(tapi.Sweep(fold=False, **kw))
    for key, w in want.data.items():
        np.testing.assert_array_equal(got.data[key], w, err_msg=key)
