"""K1's split (the cVRF pass K1a and the L1 pass K1b) against the one-walk
engines, bit for bit.

The split's plain halves, ``engine_reg_plain`` and ``engine_l1_plain``,
composed by ``engine_split_plain`` with the launch groups the card takes,
are held to the port's one-walk twin (``engine_scan_plain``) and to the
reference's engine (``repro.core.simulator._run_grid``) on the same packed
inputs: all 12 counters of the total and both measured periods.  Cases:
GOLDEN, CONF_POINTS unfolded and folded, the M = 6 machine grid (one L1
walk for all six points), the hazard lanes (capacities 1, 2, 32 x every
policy x alloc_no_fetch) and hand-made traces, and seeded random traces
whose spill, fill and MEM lines collide in one set within a row (equal
``now``, the dirty bit breaking the tie) on negative lines (floor
modulo).  The per-set bucketing K1b walks is held to the whole-stream
walk access by access.  The kernels themselves run only on the card
(``chip_smoke.py``'s ``[engine]`` phases).
"""

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import rvv as jrvv  # noqa: E402
from repro.core import policies as jpol  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import trace as jtrace  # noqa: E402
from repro_torch import rvv as trvv  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import trace as ttrace  # noqa: E402
from repro_torch.kernels import engine_scan as es  # noqa: E402
from test_golden_counters import CONF_POINTS, GOLDEN  # noqa: E402
from test_torch_engine import HAZARDS, _hazard_program  # noqa: E402

NAMES = sorted(trvv.BENCHMARKS)
POLICIES = (jpol.FIFO, jpol.LRU, jpol.LFU, jpol.OPT)
_CACHE = {}


def _program(name):
    key = ("built", name)
    if key not in _CACHE:
        bench = trvv.BENCHMARKS[name]
        _CACHE[key] = bench.build(**bench.reduced_params).program
    return _CACHE[key]


def _inputs(preps, sweep, machines):
    """The packed rows and the engine's other inputs, as simulate_grid
    gives them to K1 (periods tracked only for folded traces)."""
    arrays, spill0s = tsim._stack(preps)
    return dict(arrays=arrays, spill0s=spill0s,
                cfg=(sweep.capacity, sweep.policy, sweep.alloc_no_fetch),
                mach=(machines.l1_hit_cycles, machines.uop_hit_cycles,
                      machines.mem_latency),
                sets=machines.l1_sets, ways=machines.l1_ways,
                track_ab=any(p.num_folds for p in preps),
                lengths=[p.num_rows for p in preps])


def _reference(inp):
    """The reference's engine (its jitted ``_run_grid``) on the arrays."""
    arrays = inp["arrays"]
    slots = tuple(bool(arrays[0][:, :, s].any()) for s in range(3)) + tuple(
        bool(arrays[7][:, :, m].any()) for m in range(2))
    cap, pol, anf = inp["cfg"]
    out = jsim._run_grid(
        inp["sets"], inp["ways"], slots, inp["track_ab"],
        tuple(jnp.asarray(a) for a in arrays), jnp.asarray(inp["spill0s"]),
        (jnp.asarray(cap, jnp.int32), jnp.asarray(pol, jnp.int32),
         jnp.asarray(anf, bool)),
        tuple(jnp.asarray(a, jnp.int32) for a in inp["mach"]))
    return tuple(np.asarray(o) for o in out)


def _run(fn, inp):
    return fn(es.pack(inp["arrays"]), inp["spill0s"], inp["cfg"],
              inp["mach"], l1_sets=inp["sets"], l1_ways=inp["ways"],
              track_ab=inp["track_ab"], lengths=inp["lengths"])


def _held(inp, twin=True):
    """The split's (ctr, ctr_a, ctr_b), asserted bitwise equal to the
    reference's engine and (unless ``twin`` is False) to the port's
    one-walk twin on the same inputs."""
    got = [o.numpy() for o in _run(es.engine_split_plain, inp)]
    wants = [("reference", _reference(inp))]
    if twin:
        wants.append(("twin", [o.numpy() for o in _run(
            es.engine_scan_plain, inp)]))
    for who, want in wants:
        for name, g, w in zip(("ctr", "ctr_a", "ctr_b"), got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w, err_msg=f"{who} {name}")
    return got


def _conf_sweep():
    return tsim.SweepConfig(
        np.asarray([c for c, _, _ in CONF_POINTS], np.int32),
        np.asarray([p for _, p, _ in CONF_POINTS], np.int32),
        np.zeros(len(CONF_POINTS), bool))


def _conf_machines():
    return tsim.MachineSweep.from_params(
        [tsim.MachineParams(**vars(m)) for _, _, m in CONF_POINTS])


# -- the reference's own cases -----------------------------------------------

def test_golden_counters():
    """Both GOLDEN programs x their configs in one batched call: the split
    equals the reference, the twin and the seed values."""
    names = sorted({n for n, _, _ in GOLDEN})
    cfgs = sorted({(c, p) for _, c, p in GOLDEN})
    preps = [tsim.prepare(_program(n)) for n in names]
    inp = _inputs(preps, tsim.SweepConfig.make([c for c, _ in cfgs],
                                               [p for _, p in cfgs]),
                  tsim.MachineSweep.from_params([tsim.DEFAULT_MACHINE]))
    ctr = _held(inp)[0]
    for (name, cap, policy), want in GOLDEN.items():
        got = ctr[names.index(name), cfgs.index((cap, policy)), 0]
        assert {k: int(got[jsim.COUNTER_NAMES.index(k)]) for k in want} \
            == want


@pytest.mark.parametrize("fold", [False, True])
def test_conf_points_every_program(fold):
    """Every rvv program at reduced size, batched, on CONF_POINTS' 3
    configs x 3 machines; folded with the warm-up the reduced traces
    allow, so the periods A and B are tracked."""
    preps = [tsim.prepare(_program(n), fold=fold, warm_lines=16)
             for n in NAMES]
    assert any(p.num_folds for p in preps) == fold
    _held(_inputs(preps, _conf_sweep(), _conf_machines()))


def test_machine_grid_is_one_l1_walk():
    """The M = 6 grid at capacities 3 and 8 under LRU: one walk of the L1
    serves all six machine points, each equal to its own one-point run."""
    machines = tsim.MachineSweep.product((1, 3, 10), uop_hit_cycles=(1, 2))
    sweep = tsim.SweepConfig.make([3, 8], jpol.LRU)
    prep = tsim.prepare(_program("densenet121_l105"))
    walks = []
    real = es.l1_outcomes

    def counted(*a, **kw):
        walks.append(a[0].shape[0])
        return real(*a, **kw)

    with mock.patch.object(es, "l1_outcomes", counted):
        got = _held(_inputs([prep], sweep, machines))[0]
    assert len(walks) == 1 and walks[0] > 0
    for m in range(len(machines)):
        one = _held(_inputs([prep], sweep, tsim.MachineSweep.from_params(
            [machines.point(m)])), twin=False)[0]
        np.testing.assert_array_equal(one[:, :, 0], got[:, :, m])


HAZARD_SWEEP = tsim.SweepConfig.product((1, 2, 32), POLICIES, (False, True))


def test_hazard_lanes_on_the_smallest_programs():
    """Capacities 1 and 2 (no evictable slot under the vd check's locks),
    the full VRF, every policy, with and without alloc_no_fetch."""
    preps = [tsim.prepare(_program(n))
             for n in ("pathfinder", "gemv", "densenet121_l105")]
    _held(_inputs(preps, HAZARD_SWEEP, tsim.MachineSweep.make(
        (1, 7), uop_hit_cycles=2)))


@pytest.mark.parametrize("kind", HAZARDS)
def test_hand_made_traces(kind):
    """test_torch_engine's hand-made traces (OPT ties, no evictable slot,
    lines on the last set and line -1) on the hazard lanes."""
    prog = _hazard_program(ttrace, kind)
    np.testing.assert_array_equal(prog.op, _hazard_program(jtrace, kind).op)
    _held(_inputs([tsim.prepare(prog)], HAZARD_SWEEP,
                  tsim.MachineSweep.make((1, 7), uop_hit_cycles=2)))


# -- seeded random traces: set collisions and negative lines -----------------

PADDING = (False, 0, False, False, False, -1, -1, False, -1, False, 0,
           jpol.NO_NEXT_USE, 0, 0, 0)      # simulator._stack's fill values


def _random_trace(seed, rows=160, spill0s=(-6, 9), lengths=None):
    """Programs of seeded random rows over 7 registers, MEM lines from a
    pool that shares the spill lines' sets (negative ones included), and
    random fold weights: the 15 event arrays and the spill bases.  Rows
    0 and 1 of program 0 collide: v1 is written, then v5 read, so at
    capacity 1 the dirty v1 is spilled (line spill0 + 1) and v5 filled
    (spill0 + 5) at one ``now``, and both MEM lines of row 1 (spill0 + 9,
    spill0 + 13) fall in that set at 1, 2 or 4 sets: the first evicts the
    clean fill, whose word is below the spill's.  Rows past a program's
    length are padding."""
    rng = np.random.default_rng(seed)
    P = len(spill0s)
    shape = (P, rows)
    rv = rng.random((P, rows, 3)) < 0.7
    reg = rng.integers(0, 7, (P, rows, 3)).astype(np.int8)
    mv = rng.random((P, rows, 2)) < 0.6
    pool = np.asarray([-13, -9, -7, -3, -1, 0, 3, 4, 7, 12, 15, 19],
                      np.int32)
    line = np.where(mv, rng.choice(pool, (P, rows, 2)), -1).astype(np.int32)
    next_use = np.where(rng.random((P, rows, 3)) < 0.3, jpol.NO_NEXT_USE,
                        rng.integers(0, 50, (P, rows, 3))).astype(np.int32)
    vdw = rng.random(shape) < 0.5
    vdr = rng.random(shape) < 0.5
    rv[0, :2] = ((False, False, True), (True, False, False))
    reg[0, :2] = ((0, 0, 1), (5, 0, 0))
    vdw[0, 0], vdr[0, 0] = True, False
    mv[0, 1] = True
    line[0, 1] = (spill0s[0] + 9, spill0s[0] + 13)
    lock1 = np.where(rv[..., 0], reg[..., 0], -1).astype(np.int8)
    lock2 = np.where(rv[..., 1], reg[..., 1], -1).astype(np.int8)
    arrays = [rv, reg, vdw, vdr, rng.random(shape) < 0.5, lock1, lock2, mv,
              line, rng.random((P, rows, 2)) < 0.4,
              rng.integers(1, 4, shape).astype(np.int32), next_use,
              rng.integers(0, 4, shape).astype(np.int32),
              rng.integers(0, 2, shape).astype(np.int32),
              rng.integers(0, 2, shape).astype(np.int32)]
    for p, n in enumerate(lengths or []):
        for a, fill in zip(arrays, PADDING):
            a[p, n:] = fill
    return tuple(arrays), np.asarray(spill0s, np.int32)


def _collisions(inp, stream, reg_lane):
    """Rows where a spill, the fill at the same site and a MEM access of
    the same row fall in one set; and whether an active line is
    negative."""
    x = es.pack(inp["arrays"])
    lane, row, site, line, _ = es.l1_accesses(
        x, inp["spill0s"], stream, [0], [reg_lane])
    s = torch.remainder(line, inp["sets"])
    hits = 0
    for r in torch.unique(row).tolist():
        at = row == r
        sites, sets = site[at].tolist(), s[at].tolist()
        by = dict(zip(sites, sets))
        for k in range(3):
            if 2 * k in by and 2 * k + 1 in by and by[2 * k] == by[
                    2 * k + 1] and by[2 * k] in (by.get(6), by.get(7)):
                hits += 1
    return hits, bool((line < 0).any())


@pytest.mark.parametrize("sets,ways", [(4, 2), (2, 3), (1, 1)])
@pytest.mark.parametrize("seed", range(2))
def test_random_traces_with_set_collisions_and_negative_lines(seed, sets,
                                                              ways):
    arrays, spill0s = _random_trace(seed)
    sweep = tsim.SweepConfig.product((1, 2, 3, 32), POLICIES, (False, True))
    inp = dict(arrays=arrays, spill0s=spill0s,
               cfg=(sweep.capacity, sweep.policy, sweep.alloc_no_fetch),
               mach=(np.int32([0, 1]), np.int32([1, 2]), np.int32([5, 3])),
               sets=sets, ways=ways, track_ab=True, lengths=[160, 160])
    got = _held(inp)
    assert (got[0][..., es.SPILLS] > 0).any()
    x = es.pack(arrays)
    stream, _ = es.engine_reg_plain(x, [0], ([1], [jpol.FIFO], [False]))
    hits, negative = _collisions(inp, stream, 0)
    assert negative and hits > 0


def test_groups_under_a_tight_budget_change_nothing():
    """One K1b lane a launch group (a budget of one byte) gives the same
    counters as one group."""
    arrays, spill0s = _random_trace(7, rows=60, lengths=[60, 41])
    sweep = tsim.SweepConfig.product((2, 32), (jpol.LRU, jpol.OPT))
    inp = dict(arrays=arrays, spill0s=spill0s,
               cfg=(sweep.capacity, sweep.policy, sweep.alloc_no_fetch),
               mach=(np.int32([0]), np.int32([1]), np.int32([5])),
               sets=4, ways=2, track_ab=True, lengths=[60, 41])
    one = _held(inp, twin=False)
    with mock.patch.object(es, "STREAM_BUDGET_BYTES", 1):
        plan = es.engine_scan_plan(4, 2, [60, 41], inp["cfg"])
        assert len(plan["groups"]) == 2 * 3
        tight = _run(es.engine_split_plain, inp)
    for o, t in zip(one, tight):
        np.testing.assert_array_equal(t.numpy(), o)


# -- the decomposition K1b rests on -------------------------------------------

@pytest.mark.parametrize("case", ["conf_programs", "random"])
def test_bucketing_by_set_equals_the_whole_stream_walk(case):
    """Each access's miss and write-back flags from walking each (lane,
    set) bucket on its own equal those of walking each lane's whole
    access stream through its L1, for K1b lanes with K1a's spills and
    fills and for the full VRF."""
    if case == "random":
        arrays, spill0s = _random_trace(3)
        sets, ways, lengths = 4, 2, [160, 160]
    else:
        preps = [tsim.prepare(_program(n))
                 for n in ("conv2d_batched", "gemv", "densenet121_l105")]
        arrays, spill0s = tsim._stack(preps)
        sets, ways, lengths = 64, 2, [p.num_rows for p in preps]
    x = es.pack(arrays)
    P = x.shape[0]
    stream, _ = es.engine_reg_plain(
        x, list(range(P)) * 2, ([3] * P + [6] * P, [jpol.FIFO] * P
                                + [jpol.OPT] * P, [False] * 2 * P),
        lengths=lengths)
    l1_prog = list(range(P)) * 3
    l1_reg = list(range(2 * P)) + [-1] * P
    lane, row, site, line, write = es.l1_accesses(
        x, spill0s, stream, l1_prog, l1_reg, lengths)
    assert (site < es.REG_SITES).any() and (site >= es.REG_SITES).any()
    stamp = es._stamp(row, site)
    L = len(l1_prog)
    by_set = es.l1_outcomes(lane, line, write, stamp, L, sets, ways)
    whole = es.l1_outcomes(lane, line, write, stamp, L, sets, ways,
                           by_set=False)
    for b, w in zip(by_set, whole):
        assert torch.equal(b, w)
    assert by_set[0].any() and by_set[1].any() and not by_set[0].all()


def test_simulate_grid_through_the_split_equals_the_reference():
    """simulate_grid's dict (counters, hit_rate, fold_exact) with the
    engine call routed through the split, against the reference's
    simulate_grid, folded."""
    names = ("gemv", "dropout", "flashattention2")

    def split(x, spill0s, cfg, mach, **kw):
        return es.engine_split_plain(x, spill0s, cfg, mach, **kw)

    preps = [tsim.prepare(_program(n), fold=True, warm_lines=16)
             for n in names]
    with mock.patch.object(es, "engine_scan", split):
        got = tsim.simulate_grid(preps, tsim.SweepConfig.make([3, 32]),
                                 device="cpu")
    ref = [jrvv.BENCHMARKS[n] for n in names]
    want = jsim.simulate_grid(
        [jsim.prepare(b.build(**b.reduced_params).program, fold=True,
                      warm_lines=16) for b in ref],
        jsim.SweepConfig.make([3, 32]))
    for k in list(jsim.COUNTER_NAMES) + ["fold_exact", "hit_rate"]:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
