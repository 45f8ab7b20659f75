"""The port's cycle engine (P1) against the JAX reference's, bit for bit.

``repro_torch.core.simulator`` (``prepare``, ``_stack``,
``simulate_grid``, ``simulate_one``) runs K1's plain twin
(``kernels/engine_scan.engine_scan_plain``) here on the CPU; it is held
to the reference's ``simulate_grid``/``simulate_one`` on int32 and all
12 ``COUNTER_NAMES``: every GOLDEN case, the CONF_POINTS matrix of every
``rvv`` program (and the port interpreter's DIFF_COUNTERS there), the
M = 6 machine grid, and hand-made traces that hit each decision edge of
the engine.  The policies' torch functions are held to the reference's
on states built directly.  K1 itself runs only on the card
(``chip_smoke.py``'s engine phases hold it to this twin bitwise); here
its wrappers' checks, plan and C signatures are held
(``tests/test_torch_engine_split.py`` holds the split's plain halves).
"""

import contextlib
import ctypes
import re
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import rvv as jrvv  # noqa: E402
from repro.configs import paper_machine as jpm  # noqa: E402
from repro.core import policies as jpol  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import trace as jtrace  # noqa: E402
from repro_torch import rvv as trvv  # noqa: E402
from repro_torch.configs import paper_machine as tpm  # noqa: E402
from repro_torch.core import interpreter as tint  # noqa: E402
from repro_torch.core import policies as tpol  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import trace as ttrace  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import engine_scan as es  # noqa: E402
from test_golden_counters import (CONF_POINTS, DIFF_COUNTERS,  # noqa: E402
                                  GOLDEN)

NAMES = sorted(trvv.BENCHMARKS)
COUNTERS = jsim.COUNTER_NAMES
SRC = Path(es.__file__).resolve().parent / "csrc" / "engine_scan.cu"
# tests/test_machine_grid.py's machine axis (M = 6)
M6 = ((1, 3, 10), (1, 2))

_CACHE = {}


def _built(pkg, name):
    key = ("built", pkg, name)
    if key not in _CACHE:
        bench = (jrvv if pkg == "ref" else trvv).BENCHMARKS[name]
        _CACHE[key] = bench.build(**bench.reduced_params).program
    return _CACHE[key]


def _grid(pkg, preps, sweep, machines, **kw):
    """One simulate_grid call of either package: the reference's engine,
    or the port's twin on the CPU."""
    sim = jsim if pkg == "ref" else tsim
    if pkg != "ref":
        kw["device"] = "cpu"
    return sim.simulate_grid(preps, sweep(sim), machines(sim), **kw)


def _same_counters(want, got, keys=COUNTERS):
    for k in keys:
        assert np.asarray(got[k]).dtype == np.int32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _conf_sweep(sim):
    return sim.SweepConfig(
        np.asarray([c for c, _, _ in CONF_POINTS], np.int32),
        np.asarray([p for _, p, _ in CONF_POINTS], np.int32),
        np.zeros(len(CONF_POINTS), bool))


def _conf_machines(sim):
    return sim.MachineSweep.from_params(
        [sim.MachineParams(**vars(m)) for _, _, m in CONF_POINTS])


def _conf(pkg):
    """Every rvv program at reduced size on CONF_POINTS' 3 configs x 3
    machines, in one batched call per package (the twin walks the
    longest trace once for all 99 lanes)."""
    key = ("conf", pkg)
    if key not in _CACHE:
        sim = jsim if pkg == "ref" else tsim
        preps = [sim.prepare(_built(pkg, n)) for n in NAMES]
        _CACHE[key] = _grid(pkg, preps, _conf_sweep, _conf_machines,
                            batch_programs=True)
    return _CACHE[key]


# -- the engine on the reference's own cases ---------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_conf_points_matrix_equals_reference(name):
    """The full 3 x 3 (config, machine) grid of CONF_POINTS, all 12
    counters, bitwise."""
    i = NAMES.index(name)
    want, got = _conf("ref"), _conf("port")
    _same_counters({k: want[k][i] for k in COUNTERS},
                   {k: got[k][i] for k in COUNTERS})
    np.testing.assert_array_equal(got["hit_rate"][i], want["hit_rate"][i])


@pytest.mark.parametrize("point", range(len(CONF_POINTS)))
@pytest.mark.parametrize("name", NAMES)
def test_conf_points_match_the_port_interpreter(name, point):
    """DIFF_COUNTERS of the twin at each conformance point equal the
    port's numpy interpreter (no timing model), as the reference's
    engine equals the reference's."""
    cap, policy, _ = CONF_POINTS[point]
    disp = tint.run_dispersed(_built("port", name), cap, policy)
    got = _conf("port")
    i = NAMES.index(name)
    assert {k: int(got[k][i, point, point]) for k in DIFF_COUNTERS} == {
        k: int(getattr(disp, k)) for k in DIFF_COUNTERS}


def _golden(pkg):
    """Both GOLDEN programs x their 6 (capacity, policy) configs, one
    batched call per package."""
    key = ("golden", pkg)
    if key not in _CACHE:
        sim = jsim if pkg == "ref" else tsim
        names = sorted({n for n, _, _ in GOLDEN})
        cfgs = sorted({(c, p) for _, c, p in GOLDEN})
        preps = [sim.prepare(_built(pkg, n)) for n in names]
        out = _grid(pkg, preps,
                    lambda s: s.SweepConfig.make([c for c, _ in cfgs],
                                                 [p for _, p in cfgs]),
                    lambda s: s.DEFAULT_MACHINE, batch_programs=True)
        _CACHE[key] = (names, cfgs, out)
    return _CACHE[key]


@pytest.mark.parametrize("name,cap,policy", sorted(GOLDEN))
def test_golden_counters_equal_reference_and_seed_values(name, cap, policy):
    names, cfgs, want = _golden("ref")
    _, _, got = _golden("port")
    i, c = names.index(name), cfgs.index((cap, policy))
    _same_counters({k: want[k][i, c] for k in COUNTERS},
                   {k: got[k][i, c] for k in COUNTERS})
    assert {k: int(got[k][i, c]) for k in GOLDEN[(name, cap, policy)]} == \
        GOLDEN[(name, cap, policy)]


@pytest.mark.parametrize("policy", [jpol.FIFO, jpol.OPT])
def test_simulate_one_and_full_vrf_baseline_equal_reference(policy):
    name = "densenet121_l105"
    want = jsim.simulate_one(_built("ref", name), 3, policy)
    got = tsim.simulate_one(_built("port", name), 3, policy, device="cpu")
    _same_counters(want, got)
    assert got["hit_rate"] == want["hit_rate"]
    want = jsim.full_vrf_baseline(_built("ref", name))
    got = tsim.full_vrf_baseline(_built("port", name), device="cpu")
    _same_counters(want, got)


def _m6(sim):
    return sim.MachineSweep.product(M6[0], uop_hit_cycles=M6[1])


def test_machine_grid_equals_reference_and_per_point_runs():
    """The M = 6 machine grid (tests/test_machine_grid.py's) at capacities
    3 and 8 under LRU: equal to the reference's grid, and each machine
    point equal to the port's own one-point run."""
    sweep = lambda s: s.SweepConfig.make([3, 8], jpol.LRU)  # noqa: E731
    name = "densenet121_l105"
    want = _grid("ref", [jsim.prepare(_built("ref", name))], sweep, _m6)
    prep = tsim.prepare(_built("port", name))
    got = _grid("port", [prep], sweep, _m6)
    assert got["cycles"].shape == (1, 2, 6)
    _same_counters(want, got)
    machines = _m6(tsim)
    for m in range(len(machines)):
        one = tsim.simulate_grid([prep], sweep(tsim), machines.point(m),
                                 device="cpu")
        _same_counters({k: got[k][:, :, m] for k in COUNTERS}, one)


def test_batched_and_per_program_calls_agree():
    """Padding to the longest trace changes nothing: one batched call
    equals one call per program."""
    preps = [tsim.prepare(_built("port", n))
             for n in ("pathfinder", "gemv", "dropout")]
    sweep = tsim.SweepConfig.make([3, 32], jpol.LFU)
    one = tsim.simulate_grid(preps, sweep, device="cpu")
    batched = tsim.simulate_grid(preps, sweep, batch_programs=True,
                                 device="cpu")
    _same_counters(one, batched)


# -- hand-made traces on the engine's decision edges -------------------------

def _hazard_program(trace, kind):
    """The same hand-made program from either package's trace module."""
    mm = trace.MemoryMap()
    buf = mm.alloc("buf", 65536)
    a = trace.Assembler(kind)
    if kind == "opt_tie":
        # Eight registers written once and never read: under OPT every
        # resident one holds NO_NEXT_USE, so the lowest slot is evicted.
        for r in range(1, 9):
            a.vle(r, buf + 32 * r)
        a.vadd(9, 1, 2)
        a.vmacc(9, 3, 8)
    elif kind == "no_evictable":
        # vd = op(vs1, vs2) with three live registers: at capacity 2 the
        # vd check finds both slots locked (victim slot 0), at capacity 1
        # the vs2 check finds the only slot locked.
        a.vle(1, buf)
        a.vle(2, buf + 32)
        with a.repeat(6):
            a.vadd(3, 1, 2)
            a.vmacc(3, 1, 2)
            a.vmul(1, 2, 3)
            a.vse(3, buf + 64, stride=32)
    elif kind == "last_set":
        # Aligned accesses (MEM lane 1 inactive, its line -1: set 255 by
        # floor modulo) on lines that map to the last set, straddling ones
        # (lane 1 active) and 4-byte broadcasts, read and written.
        with a.repeat(12):
            a.vle(1, buf + 32 * 255, stride=32 * 256)
            a.vle(2, buf + 32 * 511 + 16, stride=32 * 256)
            a.vbcast(3, buf + 4, stride=4)
            a.vmacc(4, 1, 2)
            a.vse(4, buf + 32 * 255, stride=32 * 256)
            a.vses(3, buf + 8, stride=4)
    return a.finalize(mm)


HAZARDS = ("opt_tie", "no_evictable", "last_set")


def _hazard_sweep(sim):
    return sim.SweepConfig.product(
        (1, 2, 3, 32, 40),
        (jpol.FIFO, jpol.LRU, jpol.LFU, jpol.OPT), (False, True))


@pytest.mark.parametrize("kind", HAZARDS)
def test_hand_made_traces_equal_reference(kind):
    """Capacities with no evictable slot (1, 2), OPT ties, the full VRF
    (32, and 40 beyond it), every policy, with and without
    alloc_no_fetch, on two machines: all counters bitwise."""
    progs = {"ref": _hazard_program(jtrace, kind),
             "port": _hazard_program(ttrace, kind)}
    np.testing.assert_array_equal(progs["port"].op, progs["ref"].op)
    machines = lambda s: s.MachineSweep.make((1, 7), uop_hit_cycles=2)  # noqa
    out = {pkg: _grid(pkg, [(jsim if pkg == "ref" else tsim).prepare(p)],
                      _hazard_sweep, machines)
           for pkg, p in progs.items()}
    _same_counters(out["ref"], out["port"])
    assert (out["port"]["vrf_misses"] > 0).any()


def test_opt_tie_and_no_evictable_victims_are_slot_zero():
    """The first of the tied slots is evicted: with OPT at capacity 3 the
    4th load evicts slot 0 (v1), with no evictable slot the victim is
    slot 0 (spilling v1 at capacity 2)."""
    st = tpol.CacheState.init(32, 2)
    st.meta[:, :3, tpol.TAG] = torch.tensor([1, 2, 3], dtype=torch.int32)
    st.meta[:, :3, tpol.NEXT_USE] = tpol.NO_NEXT_USE
    valid = torch.arange(32)[None, :] < torch.tensor([[3], [3]])
    v = tpol.select_victim(st, torch.tensor([tpol.OPT, tpol.OPT]), valid)
    assert v.tolist() == [0, 0]
    v = tpol.select_victim(st, torch.tensor([tpol.FIFO, tpol.LRU]), valid,
                           torch.tensor([1, 1]), torch.tensor([2, 3]))
    assert v.tolist() == [2, 1]
    locked = tpol.select_victim(st, torch.tensor([tpol.FIFO, tpol.OPT]),
                                valid, torch.tensor([1, 1]),
                                torch.tensor([2, 2]))
    valid2 = torch.arange(32)[None, :] < torch.tensor([[2], [2]])
    none = tpol.select_victim(st, torch.tensor([tpol.LFU, tpol.LRU]),
                              valid2, torch.tensor([1, 2]),
                              torch.tensor([2, 1]))
    assert locked.tolist() == [2, 2] and none.tolist() == [0, 0]


# -- the policies' torch functions on states built directly ------------------

def _random_states(rng, lanes=24):
    meta = np.zeros((lanes, 32, jpol.NUM_COLS), np.int32)
    meta[:, :, jpol.TAG] = rng.integers(-1, 12, (lanes, 32))
    meta[:, :, jpol.DIRTY] = rng.integers(0, 2, (lanes, 32))
    meta[:, :, jpol.INS_SEQ] = rng.integers(0, 2**24, (lanes, 32))
    meta[:, :, jpol.LAST_USE] = rng.integers(0, 50, (lanes, 32))
    meta[:, :, jpol.FREQ] = rng.integers(0, 700, (lanes, 32))
    meta[:, :, jpol.NEXT_USE] = np.where(
        rng.random((lanes, 32)) < 0.4, jpol.NO_NEXT_USE,
        rng.integers(0, 40, (lanes, 32)))
    meta[:, :, jpol.PINNED] = rng.random((lanes, 32)) < 0.1
    caps = rng.integers(1, 34, lanes)
    return meta, caps


@pytest.mark.parametrize("seed", range(3))
def test_policy_functions_equal_reference_lane_by_lane(seed):
    """lookup, free_slot, select_victim (every policy, with locks) and
    apply_access over a batch of lanes equal the reference's functions
    on each lane, duplicate tags and ties included."""
    rng = np.random.default_rng(seed)
    meta, caps = _random_states(rng)
    lanes = len(caps)
    valid = np.arange(32)[None, :] < caps[:, None]
    st = tpol.CacheState(meta=torch.from_numpy(meta.copy()))
    tvalid = torch.from_numpy(valid)
    tag = rng.integers(0, 12, lanes).astype(np.int32)
    pol = rng.integers(0, 5, lanes).astype(np.int32)
    la = rng.integers(-1, 12, lanes).astype(np.int32)
    lb = rng.integers(-1, 12, lanes).astype(np.int32)
    hit, slot = tpol.lookup(st, torch.from_numpy(tag), tvalid)
    free, fslot = tpol.free_slot(st, tvalid)
    victim = tpol.select_victim(st, torch.from_numpy(pol), tvalid,
                                torch.from_numpy(la), torch.from_numpy(lb))
    for i in range(lanes):
        js = jpol.CacheState(meta=jnp.asarray(meta[i]))
        jv = jnp.asarray(valid[i])
        h, s = jpol.lookup(js, tag[i], jv)
        assert (bool(hit[i]), int(slot[i])) == (bool(h), int(s))
        f, fs = jpol.free_slot(js, jv)
        assert (bool(free[i]), int(fslot[i])) == (bool(f), int(fs))
        assert int(victim[i]) == int(jpol.select_victim(
            js, pol[i], jv, la[i], lb[i]))
    active = rng.random(lanes) < 0.8
    wr = rng.random(lanes) < 0.5
    now, seq = 1234, rng.integers(0, 99, lanes).astype(np.int32)
    nxt = rng.integers(0, 99, lanes).astype(np.int32)
    tpol.apply_access(st, active=torch.from_numpy(active), raw_hit=hit,
                      hit_slot=slot, install_slot=victim,
                      tag=torch.from_numpy(tag), now=now,
                      seq=torch.from_numpy(seq), next_use=torch.from_numpy(
                          nxt), is_write=torch.from_numpy(wr))
    for i in range(lanes):
        want = jpol.apply_access(
            jpol.CacheState(meta=jnp.asarray(meta[i])),
            active=bool(active[i]), raw_hit=bool(hit[i]),
            hit_slot=int(slot[i]), install_slot=int(victim[i]),
            tag=int(tag[i]), now=now, seq=int(seq[i]),
            next_use=int(nxt[i]), is_write=bool(wr[i]))
        np.testing.assert_array_equal(st.meta[i].numpy(),
                                      np.asarray(want.meta))


def test_lfu_metric_wraps_insertion_order_as_the_reference():
    """Past 2^21 misses LFU's packed metric keeps the insertion order
    modulo 2^21: the engine (both packages) evicts slot 0, whose order
    2^21 + 5 wraps to 5, while the numpy oracle's (freq, order) tuple
    picks slot 1."""
    meta = np.zeros((1, 32, jpol.NUM_COLS), np.int32)
    meta[0, :, jpol.TAG] = -1
    meta[0, :2, jpol.TAG] = (4, 7)
    meta[0, :2, jpol.FREQ] = (1, 1)
    meta[0, :2, jpol.INS_SEQ] = (2**21 + 5, 10)
    valid = np.arange(32) < 8
    got = tpol.select_victim(tpol.CacheState(torch.from_numpy(meta)),
                             tpol.LFU, torch.from_numpy(valid)[None])
    want = jpol.select_victim(jpol.CacheState(jnp.asarray(meta[0])),
                              jpol.LFU, jnp.asarray(valid))
    m = meta[0]
    oracle = tpol.np_select_victim(
        m[:, 0], m[:, 2], m[:, 3], m[:, 4], m[:, 5], m[:, 6], 8, tpol.LFU)
    assert int(got[0]) == int(want) == 0 and oracle == 1


@pytest.mark.parametrize("line,active", [(-1, False), (-1, True),
                                         (255, True), (511, False),
                                         (767, True)])
def test_l1_access_equals_reference_on_the_last_set(line, active):
    """The L1's set is Python's floor modulo: line -1 maps to set 255.  An
    inactive access leaves the state as it was and costs nothing; every
    case equals the reference's _l1_access on the same dirty, full set."""
    sets, ways = 256, 2
    tags = np.full((sets, ways), -1, np.int32)
    words = np.zeros((sets, ways), np.int32)
    tags[255] = (255, 511)
    words[255] = (7 << 1 | 1, 3 << 1 | 1)
    ref = jnp.stack([jnp.asarray(tags), jnp.asarray(words)], axis=-1)
    want_l1, want_c, want_h = jsim._l1_access(
        ref, jnp.int32(line), True, jnp.int32(40), jnp.bool_(active), sets,
        jnp.int32(1), jnp.int32(5))
    l1 = (torch.from_numpy(tags)[None].clone(),
          torch.from_numpy(words)[None].clone())
    c, h = es.l1_access(l1, torch.tensor([line], dtype=torch.int32), True,
                        40, torch.tensor([active]), torch.tensor([1]),
                        torch.tensor([5]))
    assert (int(c[0]), bool(h[0])) == (int(want_c), bool(want_h))
    np.testing.assert_array_equal(l1[0][0].numpy(),
                                  np.asarray(want_l1)[..., 0])
    np.testing.assert_array_equal(l1[1][0].numpy(),
                                  np.asarray(want_l1)[..., 1])


# -- preparation, packing and the front end ----------------------------------

@pytest.mark.parametrize("fold", [False, True])
def test_prepare_and_stack_equal_reference(fold):
    names = ("gemv", "dropout", "flashattention2")
    want = [jsim.prepare(_built("ref", n), fold=fold, warm_lines=16)
            for n in names]
    got = [tsim.prepare(_built("port", n), fold=fold, warm_lines=16)
           for n in names]
    for w, g in zip(want, got):
        for f in ("weight", "wa", "wb"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        assert (g.num_folds, g.certifiable, g.spill_line0, g.event_scale) \
            == (w.num_folds, w.certifiable, w.spill_line0, w.event_scale)
    wa, ws, _ = jsim._stack(want)
    ga, gs = tsim._stack(got, pad_to=wa[0].shape[1])
    for w, g in zip(wa, ga):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(gs, ws)
    # Without pad_to the port pads to the longest trace
    longest = max(p.num_rows for p in got)
    for w, g in zip(wa, tsim._stack(got)[0]):
        np.testing.assert_array_equal(g, w[:, :longest])


def test_prepare_truncation_equals_reference():
    want = jsim.prepare(_built("ref", "mha"), max_events=5000)
    got = tsim.prepare(_built("port", "mha"), max_events=5000)
    assert got.num_rows == want.num_rows and got.event_scale == \
        want.event_scale


def test_pack_follows_the_column_layout_of_the_c_source():
    """pack() lays the 15 arrays out in COLUMNS order, and the C source's
    column offsets are the Python ones."""
    prep = tsim.prepare(_built("port", "gemv"))
    arrays, _ = tsim._stack([prep])
    x = es.pack(arrays)
    assert x.shape == (1, prep.num_rows, es.NCOL) and x.dtype == torch.int32
    col = 0
    for (name, width), a in zip(es.COLUMNS, arrays):
        a = a.reshape(1, prep.num_rows, width)
        np.testing.assert_array_equal(x[..., col:col + width].numpy(), a,
                                      err_msg=name)
        col += width
    enum = re.search(r"enum \{\s*(RV = 0[^}]*)\}", SRC.read_text()).group(1)
    c_offsets = {k.strip(): int(v) for k, v in
                 (p.split("=") for p in enum.split(","))}
    assert c_offsets == {k: getattr(es, k) for k in c_offsets}
    assert re.search(rf"NCOL = {es.NCOL};", SRC.read_text())


def test_counter_names_and_paper_machine_equal_reference():
    assert tsim.COUNTER_NAMES == jsim.COUNTER_NAMES
    assert tsim.NUM_MISS_SITES == jsim.NUM_MISS_SITES
    for n in ("CVRF_SIZES", "FULL_VRF", "PAPER_CVRF", "NUM_ARCH_VREGS",
              "VL_ELEMS", "VLEN_BITS", "VLEN_BYTES", "MASK_REG"):
        assert getattr(tpm, n) == getattr(jpm, n), n
    assert vars(tpm.L31_VPU) == vars(jpm.L31_VPU)
    for f in ("l1_hit_cycles", "uop_hit_cycles", "mem_latency"):
        np.testing.assert_array_equal(getattr(tpm.TABLE1_MEM_RANGE, f),
                                      getattr(jpm.TABLE1_MEM_RANGE, f))


def test_entry_points_default_to_the_card():
    """Without a card, the engine's entry points refuse the default
    device rather than run the twin."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    prep = tsim.prepare(_built("port", "pathfinder"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsim.simulate_grid([prep], tsim.SweepConfig.make([3]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsim.simulate_one(_built("port", "pathfinder"), 3)


# -- K1's wrapper, with the card faked ----------------------------------------

def test_engine_scan_dispatches_by_device():
    prep = tsim.prepare(_built("port", "pathfinder"))
    arrays, spill0s = tsim._stack([prep])
    cfg = (np.int32([3]), np.int32([0]), np.zeros(1, bool))
    mach = (np.int32([0]), np.int32([1]), np.int32([5]))
    kw = dict(l1_sets=256, l1_ways=2)
    out = es.engine_scan(es.pack(arrays), spill0s, cfg, mach, **kw)
    assert [o.shape for o in out] == [(1, 1, 1, 12)] * 3
    with pytest.raises(ValueError, match="cpu or cuda"):
        es.engine_scan(es.pack(arrays).to("meta"), spill0s, cfg, mach, **kw)
    with pytest.raises(ValueError, match="CUDA device"):
        es.engine_scan_cuda(es.pack(arrays), spill0s, cfg, mach, **kw)


@pytest.mark.parametrize("sets,ways,smem,slots", [(256, 2, 4096, 2),
                                                  (64, 2, 1024, 2),
                                                  (512, 4, 8192, 4)])
def test_plan_states_the_tile(sets, ways, smem, slots):
    """The tiles of both kernels (K1a's warps and staged rows, K1b's
    bucketing warps with a shared counter per set, the walker's way
    slots) and the launch groups of a mixed grid: one K1b lane per
    (program, cVRF class), the full VRF's shared by its configs, and the
    buffers' bytes."""
    plan = es.engine_scan_plan(sets, ways, [100, 40],
                               ([3, 32, 3, 40], [0, 0, 0, 0],
                                [False, False, False, False]))
    assert plan["tile"] == dict(
        reg_warps_per_cta=4, chunk_rows=32, ncol=24, reg_smem_bytes=13056,
        tile_rows=1024, hist_warps_per_cta=4, hist_smem_bytes=smem,
        way_slots=slots, walk_threads=128)
    assert tuple(plan["tile"]) == es.TILE_KEYS
    assert plan["classes"] == [0, -1, 0, -1]
    (group,) = plan["groups"]
    assert group["reg_lanes"] == [(0, 0), (1, 0)]
    assert group["l1_lanes"] == [(0, 0, 0), (0, -1, -1), (1, 0, 1),
                                 (1, -1, -1)]
    assert group["outputs"] == [(0, 0, 0), (0, 2, 0), (0, 1, 1), (0, 3, 1),
                                (1, 0, 2), (1, 2, 2), (1, 1, 3), (1, 3, 3)]
    assert group["bytes"] == dict(stream=2 * 100 * 6,
                                  records=(140 * 8 + 140 * 2) * 9,
                                  hist=4 * sets * 4)
    # Under a budget of one byte each K1b lane is a group
    with mock.patch.object(es, "STREAM_BUDGET_BYTES", 1):
        tight = es.engine_scan_plan(sets, ways, [100, 40],
                                    ([3, 32], [0, 0], [False, False]))
    assert [g["l1_lanes"] for g in tight["groups"]] == [
        [(0, 0, 0)], [(0, -1, -1)], [(1, 0, 0)], [(1, -1, -1)]]


@pytest.mark.parametrize("sets,ways", [(256, 33), (256, 0), (0, 2),
                                       (16384, 4)])
def test_plan_refuses_what_the_kernel_does_not_take(sets, ways):
    with pytest.raises(ValueError, match="engine_scan takes"):
        es.engine_scan_plan(sets, ways)


def test_plan_refuses_rows_past_the_record_packing():
    with pytest.raises(ValueError, match="engine_scan takes fewer"):
        es.engine_scan_plan(256, 2, [es.MAX_ROWS])


@pytest.mark.parametrize("py_name,c_name", [
    ("REG_WARPS_PER_CTA", "REG_WARPS"), ("CHUNK_ROWS", "CHUNK"),
    ("MAX_SMEM_BYTES", "MAX_SMEM"), ("NOW_STEP", "NOW_STEP"),
    ("NUM_COUNTERS", "NCTR"), ("TILE_ROWS", "TILE_ROWS"),
    ("HIST_WARPS_PER_CTA", "HIST_WARPS"), ("SCAN_BLOCK", "SCAN_BLOCK"),
    ("WALK_THREADS", "WALK_THREADS"), ("REG_SITES", "REG_SITES"),
    ("SITES", "SITES"), ("NUM_SETS", "NSETS"), ("L1_SUMS", "NL1"),
    ("TRACE_SUMS", "NTR")])
def test_plan_constants_match_the_c_source(py_name, c_name):
    m = re.search(rf"constexpr int {c_name} = (\d+);", SRC.read_text())
    assert int(m.group(1)) == getattr(es, py_name)


def test_max_rows_matches_the_c_source():
    m = re.search(r"constexpr long long MAX_ROWS = 1LL << (\d+);",
                  SRC.read_text())
    assert 1 << int(m.group(1)) == es.MAX_ROWS


@pytest.mark.parametrize("name", sorted(es.ARGTYPES))
def test_ctypes_argtypes_match_the_c_entry_points(name):
    decl = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)",
                     SRC.read_text())
    params = [p.strip() for p in decl.group(1).split(",")]
    argtypes = es.ARGTYPES[name]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        assert ("*" in p) == (t is ctypes.c_void_p), (name, p)
        if t is ctypes.c_int:
            assert p.startswith("int "), (name, p)
        if t is ctypes.c_longlong:
            assert p.startswith("long long "), (name, p)


class _FakeEntry:
    def __init__(self, calls, name, rc):
        self.calls, self.name, self.rc = calls, name, rc
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls.append((self.name, args))
        return self.rc[0]


class _FakeLib:
    def __init__(self, calls, rc):
        for name in es.ARGTYPES:
            setattr(self, name, _FakeEntry(calls, name, rc))


class _FakeCudaTensor:
    """A CPU tensor that answers is_cuda: the wrapper's checks, packing
    and launch arguments are all it exercises."""

    def __init__(self, t):
        self.t = t
        self.is_cuda, self.dtype, self.shape = True, t.dtype, t.shape
        self.device = torch.device("cpu")

    def dim(self):
        return self.t.dim()

    def contiguous(self):
        return self

    def data_ptr(self):
        return self.t.data_ptr()


@pytest.fixture
def fake_card(monkeypatch):
    calls, rc = [], [0]
    es._library.cache_clear()
    monkeypatch.setattr(_build, "load", lambda name: _FakeLib(calls, rc))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 7})())
    yield calls, rc
    es._library.cache_clear()


@pytest.mark.parametrize("rc,exc", [(0, None), (-1, ValueError),
                                    (700, RuntimeError)])
def test_cuda_wrapper_launches_once_and_counts_only_success(fake_card, rc,
                                                            exc):
    """K1 on a grid with a cVRF class and the full VRF: K1a once for the
    two programs' capacity-3 lanes, then K1b once for all four K1b lanes;
    each wrapper counts its launch only when it succeeded, and a failed
    K1a launch raises before K1b."""
    calls, set_rc = fake_card
    set_rc[0] = rc
    x = torch.zeros((2, 5, es.NCOL), dtype=torch.int32)
    before = (es.engine_reg_cuda.launches, es.engine_l1_cuda.launches)
    args = (_FakeCudaTensor(x), [0, 0], ([3, 32], [0, 3], [False, True]),
            ([0], [1], [5]))
    kw = dict(l1_sets=256, l1_ways=2, lengths=[5, 3])
    with contextlib.ExitStack() as stack:
        if exc:
            stack.enter_context(pytest.raises(exc))
        out = es.engine_scan_cuda(*args, **kw)
    names = [name for name, _ in calls]
    assert names == ["engine_reg_launch"] + ([] if exc else
                                             ["engine_l1_launch"])
    a = calls[0][1]
    assert a[1:3] == (2, 5) and a[8:10] == (2, 1) and a[-1] == 7
    after = (es.engine_reg_cuda.launches, es.engine_l1_cuda.launches)
    assert [n - b for n, b in zip(after, before)] == [0 if exc else 1] * 2
    assert es.engine_reg_cuda.by_route().keys() == {"warp"}
    assert es.engine_l1_cuda.by_route().keys() == {"set"}
    if not exc:
        a = calls[1][1]
        assert a[1:3] == (2, 5) and a[7] == 4 and a[10] == 4 and a[12] == 1
        assert a[16:20] == (256, 2, 1, 2) and a[-1] == 7
        assert a[21] == 5 * (8 + 2) + 3 * (8 + 2)        # access slots
        assert [o.shape for o in out] == [(2, 2, 1, 12)] * 3


def test_full_vrf_grid_launches_only_the_l1_pass(fake_card):
    calls, _ = fake_card
    x = _FakeCudaTensor(torch.zeros((1, 4, es.NCOL), dtype=torch.int32))
    es.engine_scan_cuda(x, [0], ([32, 40], [0, 1], [False, False]),
                        ([0, 1], [1, 1], [5, 3]), l1_sets=64, l1_ways=2)
    ((name, a),) = calls
    assert name == "engine_l1_launch" and a[7] == 1 and a[10] == 2


@pytest.mark.parametrize("call,match", [
    (lambda x: es.engine_reg_cuda(x, [0], ([32], [0], [False])),
     "full VRF"),
    (lambda x: es.engine_reg_cuda(x, [1], ([3], [0], [False])),
     "prog must lie"),
    (lambda x: es.engine_l1_cuda(
        x, [0], torch.zeros((0, 4, 6), dtype=torch.int8),
        torch.zeros((0, 3, 6), dtype=torch.int32), [0], [0], [0],
        ([0], [1], [5]), l1_sets=256, l1_ways=2), "out of range"),
    (lambda x: es.engine_l1_cuda(
        x, [0], torch.zeros((0, 4, 6), dtype=torch.int8),
        torch.zeros((0, 3, 6), dtype=torch.int32), [0], [-1], [0],
        ([0], [1], [5]), l1_sets=256, l1_ways=64), "engine_scan takes")])
def test_kernel_wrappers_refuse_before_launch(fake_card, call, match):
    calls, _ = fake_card
    x = _FakeCudaTensor(torch.zeros((1, 4, es.NCOL), dtype=torch.int32))
    with pytest.raises(ValueError, match=match):
        call(x)
    assert calls == []


@pytest.mark.parametrize("lengths,shape,match", [
    ([6, 3], (2, 5, es.NCOL), "lengths must lie"),
    ([-1, 3], (2, 5, es.NCOL), "lengths must lie"),
    ([5], (2, 5, es.NCOL), "must be \\(P,\\)"),
    ([5, 5], (2, 5, es.NCOL - 1), "int32"),
    ([], (0, 5, es.NCOL), "int32")])
def test_cuda_wrapper_refuses_bad_inputs_before_launch(fake_card, lengths,
                                                       shape, match):
    calls, _ = fake_card
    x = _FakeCudaTensor(torch.zeros(shape, dtype=torch.int32))
    with pytest.raises(ValueError, match=match):
        es.engine_scan_cuda(x, [0] * shape[0], ([3], [0], [False]),
                            ([0], [1], [5]), l1_sets=256, l1_ways=2,
                            lengths=lengths)
    assert calls == []
