"""The port's trace layer (``core/isa``, ``trace``, ``events``,
``interpreter``, the numpy head of ``simulator`` and ``rvv/``) against the
JAX package's: the same programs, event matrices, functional runs and
scalar-core costs, bit for bit.

Both packages are numpy here; the reference's ``repro.core`` loads JAX on
import (its ``__init__`` imports the simulator), the port's loads neither.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import rvv as jrvv  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import interpreter as jint  # noqa: E402
from repro.core import isa as jisa  # noqa: E402
from repro.core import policies as jpol  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import trace as jtrace  # noqa: E402
from repro_torch import rvv as trvv  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import interpreter as tint  # noqa: E402
from repro_torch.core import isa as tisa  # noqa: E402
from repro_torch.core import policies as tpol  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import trace as ttrace  # noqa: E402

NAMES = list(jrvv.BENCHMARKS)
POLICIES = {"fifo": jpol.FIFO, "lru": jpol.LRU, "lfu": jpol.LFU,
            "opt": jpol.OPT}
# Programs small enough to build twice at paper size in a few seconds
# (all but resnet50_l10, 9.7 M instructions, and flashattention2, 2.5 M).
PAPER_MAX_T = 1_100_000
PAPER_NAMES = [n for n in NAMES
               if n not in ("resnet50_l10", "flashattention2")]

_BUILT = {}


def _built(pkg, name, size="reduced_params"):
    """Each package's build of a registered program, built once."""
    key = (pkg, name, size)
    if key not in _BUILT:
        bench = (jrvv if pkg == "ref" else trvv).BENCHMARKS[name]
        _BUILT[key] = bench.build(**getattr(bench, size))
    return _BUILT[key]


def _same(a, b):
    """Equal arrays: same dtype, shape and bits (NaNs included)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.kind == "f":
        a, b = a.view(f"i{a.itemsize}"), b.view(f"i{b.itemsize}")
    np.testing.assert_array_equal(a, b)


def _same_program(want, got):
    for field in jtrace._FIELDS + ("memory",):
        _same(getattr(want, field), getattr(got, field))
    assert got.buffers == want.buffers
    assert got.name == want.name
    assert [tuple(r) for r in got.repeats] == [tuple(r)
                                               for r in want.repeats]


# -- the ISA and the registry ------------------------------------------------

def test_isa_constants_and_op_table_equal():
    names = [n for n in vars(jisa) if n.isupper()]
    assert names and names == [n for n in vars(tisa) if n.isupper()]
    for n in names:
        want, got = getattr(jisa, n), getattr(tisa, n)
        if isinstance(want, dict):
            assert {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                    else v for k, v in want.items()} == {
                k: dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                else v for k, v in got.items()}, n
        else:
            assert got == want, n
    want, got = jisa.op_table(), tisa.op_table()
    assert list(got) == list(want)
    for key in want:
        _same(want[key], got[key])


def test_registry_order_params_and_paper_table_equal():
    assert list(trvv.BENCHMARKS) == NAMES
    assert NAMES[:9] == list(jrvv.PAPER_TABLE3)
    for name in NAMES:
        want, got = jrvv.BENCHMARKS[name], trvv.BENCHMARKS[name]
        assert (got.name, got.domain, got.paper_params, got.reduced_params,
                got.table2) == (want.name, want.domain, want.paper_params,
                                want.reduced_params, want.table2)
    assert trvv.PAPER_TABLE3 == jrvv.PAPER_TABLE3
    assert trvv.__all__ == jrvv.__all__


def test_unknown_kernel_raises_the_same_key_error(monkeypatch):
    # Other tests in this process (docs/bridge.md's examples run by
    # tests/test_docs.py, tests/test_bridge.py) register network kernels
    # in the reference's registry; the menus are compared over the kernels
    # both packages ship.
    for name in set(jrvv.BENCHMARKS) - set(trvv.BENCHMARKS):
        monkeypatch.delitem(jrvv.BENCHMARKS, name)
    with pytest.raises(KeyError) as want:
        jrvv.get_benchmark("gemmv")
    with pytest.raises(KeyError) as got:
        trvv.get_benchmark("gemmv")
    assert str(got.value) == str(want.value)
    assert "available: conv2d_7x7, conv2d_batched" in str(got.value)


def test_registering_a_name_twice_raises_unless_exist_ok():
    build = trvv.BENCHMARKS["gemv"].build
    with pytest.raises(ValueError, match="registered twice"):
        trvv.register_benchmark("gemv", domain="x", paper_params={},
                                reduced_params={})(build)
    assert trvv.register_benchmark(
        "gemv", domain="x", paper_params={}, reduced_params={},
        exist_ok=True)(build) is build
    assert trvv.BENCHMARKS["gemv"].domain == jrvv.BENCHMARKS["gemv"].domain


# -- programs and event matrices at reduced size -----------------------------

@pytest.mark.parametrize("name", NAMES)
def test_reduced_program_and_expected_outputs_equal(name):
    want, got = _built("ref", name), _built("port", name)
    _same_program(want.program, got.program)
    assert got.program.addr.dtype == np.int64
    assert list(got.expected) == list(want.expected)
    for key in want.expected:
        _same(want.expected[key], got.expected[key])
    assert list(got.regions) == list(want.regions)
    for key, (arr, stride) in want.regions.items():
        _same(arr, got.regions[key][0])
        assert got.regions[key][1] == stride
    assert (got.rtol, got.atol) == (want.rtol, want.atol)
    _same(want.program.active_vregs(), got.program.active_vregs())


@pytest.mark.parametrize("name", NAMES)
def test_reduced_event_streams_equal(name):
    prog_w, prog_g = _built("ref", name).program, _built("port", name).program
    want, got = jev.expand(prog_w), tev.expand(prog_g)
    for field in dataclasses.fields(jev.EventStream):
        a, b = getattr(want, field.name), getattr(got, field.name)
        if isinstance(a, np.ndarray):
            _same(a, b)
        else:
            assert b == a, field.name
    assert got.num_events == want.num_events
    _same(jev.next_use_grid(prog_w), tev.next_use_grid(prog_g))
    # the one-pass next-use grid is the per-register loop's
    reg = np.stack([prog_g.vs1, prog_g.vs2, prog_g.vd], 1).astype(np.int8)
    valid = tev._reg_valid(tisa.op_table(), prog_g.op, prog_g.vd,
                           prog_g.vs1, prog_g.vs2)
    _same(tev._next_use_naive(reg, valid), tev._next_use(reg, valid))
    assert tev.NO_NEXT_USE == jev.NO_NEXT_USE
    assert tev.NO_NEXT_USE.dtype == np.int32


@pytest.mark.parametrize("name", NAMES)
def test_expand_of_selected_rows_equal(name):
    """``rows`` (the folded trace's sorted row subset) expands alike."""
    prog_w, prog_g = _built("ref", name).program, _built("port", name).program
    rows = np.arange(0, prog_w.num_instructions, 3)
    want, got = jev.expand(prog_w, rows), tev.expand(prog_g, rows)
    for field in dataclasses.fields(jev.EventStream):
        a, b = getattr(want, field.name), getattr(got, field.name)
        if isinstance(a, np.ndarray):
            _same(a, b)
        else:
            assert b == a, field.name


# -- functional runs ---------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_full_vrf_run_equal_and_correct(name):
    built = _built("port", name)
    want = jint.run(_built("ref", name).program)
    got = tint.run(built.program)
    _same(want.memory, got.memory)
    _same(want.vregs, got.vregs)
    trvv.check(built, got.memory)


@pytest.mark.parametrize("capacity", [4, 8])
@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("name", NAMES)
def test_dispersed_run_equal(name, policy, capacity):
    want = jint.run_dispersed(_built("ref", name).program, capacity,
                              POLICIES[policy])
    got = tint.run_dispersed(_built("port", name).program, capacity,
                             getattr(tpol, policy.upper()))
    _same(want.memory, got.memory)
    _same(want.vregs, got.vregs)
    assert (got.vrf_hits, got.vrf_misses, got.spills, got.fills) == (
        want.vrf_hits, want.vrf_misses, want.spills, want.fills)
    # Register Dispersion preserves the program's semantics
    _same(tint.run(_built("port", name).program).memory, got.memory)


def test_dispersed_run_refuses_fewer_than_three_registers():
    prog = _built("port", "gemv").program
    with pytest.raises(ValueError, match="at least 3"):
        tint.run_dispersed(prog, 2)


def test_vxor_goes_through_an_int32_view():
    a = np.array([1.5, -2.0, 0.0, 3.25, 7.0, -1.0, 2.0, 9.0], np.float32)
    b = np.array([0.5, 2.0, -0.0, 1.0, 7.0, 3.0, -2.0, 1.0], np.float32)
    want, _ = jint._exec_op(jisa.VXOR, None, a, b, 0.0, None)
    got, _ = tint._exec_op(tisa.VXOR, None, a, b, 0.0, None)
    _same(want, got)
    _same(got.view(np.int32), a.view(np.int32) ^ b.view(np.int32))


# -- paper size --------------------------------------------------------------

@pytest.mark.parametrize("name", PAPER_NAMES)
def test_paper_program_equal(name):
    want = _built("ref", name, "paper_params").program
    got = _built("port", name, "paper_params").program
    assert want.num_instructions <= PAPER_MAX_T
    _same_program(want, got)
    _BUILT.pop(("ref", name, "paper_params"))
    _BUILT.pop(("port", name, "paper_params"))


# -- the simulator's numpy head: machines and the scalar-core cost -----------

SWEEP = dict(mem_latency=[1, 3, 5], l1_hit_cycles=[0, 1, 0],
             uop_hit_cycles=[1, 1, 2])


@pytest.mark.parametrize("name", NAMES)
def test_scalar_cost_cycles_equal(name):
    jb, tb = jrvv.BENCHMARKS[name], trvv.BENCHMARKS[name]
    want, got = jb.scalar_cost(**jb.paper_params), tb.scalar_cost(
        **tb.paper_params)
    assert isinstance(got, tsim.ScalarCost)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.cycles() == want.cycles()
    assert got.cycles(tsim.DEFAULT_MACHINE) == want.cycles(
        jsim.DEFAULT_MACHINE)
    _same(want.cycles(jsim.MachineSweep.make(**SWEEP)),
          got.cycles(tsim.MachineSweep.make(**SWEEP)))


def test_machine_params_and_sweeps_equal():
    assert dataclasses.asdict(tsim.DEFAULT_MACHINE) == dataclasses.asdict(
        jsim.DEFAULT_MACHINE)
    pairs = [
        (jsim.MachineSweep.make(**SWEEP), tsim.MachineSweep.make(**SWEEP)),
        (jsim.MachineSweep.make(4), tsim.MachineSweep.make(4)),
        (jsim.MachineSweep.product([1, 5], (0, 1), (1, 2), l1_sets=128),
         tsim.MachineSweep.product([1, 5], (0, 1), (1, 2), l1_sets=128)),
        (jsim.MachineSweep.from_params(
            [jsim.MachineParams(mem_latency=m) for m in (2, 4)]),
         tsim.MachineSweep.from_params(
             [tsim.MachineParams(mem_latency=m) for m in (2, 4)])),
    ]
    for want, got in pairs:
        assert len(got) == len(want)
        for field in ("l1_hit_cycles", "uop_hit_cycles", "mem_latency"):
            _same(getattr(want, field), getattr(got, field))
        assert (got.l1_sets, got.l1_ways) == (want.l1_sets, want.l1_ways)
        for m in range(len(want)):
            assert dataclasses.asdict(got.point(m)) == dataclasses.asdict(
                want.point(m))
    mixed = [dict(l1_sets=256), dict(l1_sets=128)]
    with pytest.raises(ValueError) as want:
        jsim.MachineSweep.from_params([jsim.MachineParams(**k)
                                       for k in mixed])
    with pytest.raises(ValueError) as got:
        tsim.MachineSweep.from_params([tsim.MachineParams(**k)
                                       for k in mixed])
    assert str(got.value) == str(want.value)
