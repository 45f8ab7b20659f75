"""The port's periodic folding (``core/folding.py``, a numpy copy) against
the JAX reference's: the same fold plans for every ``rvv`` program, and
the same folded counters through the engine (the port's twin on the CPU
against the reference's engine).

Fault R1 of the reference (ROADMAP.md §3): at hypothesis seeds 118 and
3,694,753,632 of ``tests/test_folding.py``'s random repeat program the
fold certifies ``fold_exact`` at every grid point, yet its extrapolated
``cycles`` differ from the unfolded run's.  The port reproduces the
reference, so the gap is pinned here on both sides, as fixed cases.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import rvv as jrvv  # noqa: E402
from repro.core import folding as jfold  # noqa: E402
from repro.core import isa as jisa  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import trace as jtrace  # noqa: E402
from repro_torch import rvv as trvv  # noqa: E402
from repro_torch.core import folding as tfold  # noqa: E402
from repro_torch.core import isa as tisa  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import trace as ttrace  # noqa: E402

NAMES = sorted(trvv.BENCHMARKS)
PKG = {"ref": (jtrace, jisa, jsim, jfold), "port": (ttrace, tisa, tsim,
                                                    tfold)}
# The reduced traces are too short to fold after the default 16 KB L1's
# warm-up (2 x 512 lines); a 16-line warm-up folds ten of the eleven.
WARM_LINES = (None, 16)
# (seed, folded cycles - unfolded cycles at capacities (3, 8) x the
# seed's 3 machines): the reference's R1 gap, every point certified.
R1_GAPS = {118: [[69, 759, 69], [71, 781, 71]],
           3_694_753_632: [[-40, -55, -55], [-40, -55, -55]]}


def _plan(pkg, name, warm_lines):
    trace, _, _, fold = PKG[pkg]
    bench = (jrvv if pkg == "ref" else trvv).BENCHMARKS[name]
    program = bench.build(**bench.reduced_params).program
    kw = {} if warm_lines is None else dict(warm_lines=warm_lines)
    return fold.plan(program, **kw)


@pytest.mark.parametrize("warm_lines", WARM_LINES)
@pytest.mark.parametrize("name", NAMES)
def test_fold_plan_equals_reference(name, warm_lines):
    want = _plan("ref", name, warm_lines)
    got = _plan("port", name, warm_lines)
    if want is None:
        assert got is None
        return
    for f in ("rows", "weight", "wa", "wb"):
        w, g = getattr(want, f), getattr(got, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert (got.num_folds, got.certifiable) == (want.num_folds,
                                                want.certifiable)


def test_warm_lines_and_diagnosis_equal_reference():
    for sets, ways in ((256, 2), (64, 2), (512, 4)):
        assert tfold.warm_lines_for(sets, ways) == jfold.warm_lines_for(
            sets, ways)
    bench = trvv.BENCHMARKS["somier"]
    jbench = jrvv.BENCHMARKS["somier"]
    got = tfold.diagnose(bench.build(**bench.reduced_params).program,
                         warm_lines=16)
    want = jfold.diagnose(jbench.build(**jbench.reduced_params).program,
                          warm_lines=16)
    assert got == want and got


def _random_repeat_program(pkg, rng):
    """tests/test_folding.py's random repeat program, from either
    package's trace module (same draws, same program)."""
    trace, isa, _, _ = PKG[pkg]
    mm = trace.MemoryMap()
    n_streams = int(rng.integers(1, 4))
    iters = int(rng.integers(64, 512))
    bufs = [mm.alloc(f"s{i}", iters * isa.VL_ELEMS + 64)
            for i in range(n_streams)]
    a = trace.Assembler("rand_repeat")
    with a.repeat(iters):
        for i, buf in enumerate(bufs):
            stride = int(rng.choice([4, 32, 64]))
            reg = 1 + i
            a.vle(reg, buf, stride=stride)
            if rng.random() < 0.5:
                a.vmacc(reg + n_streams, reg, reg)
            else:
                a.vmul_sc(reg + n_streams, reg, 1.5)
        a.vse(1 + n_streams, bufs[0] + 32, stride=32)
    return a.finalize(mm)


def _random_machines(sim, rng):
    m = 3
    return sim.MachineSweep(
        l1_hit_cycles=rng.integers(0, 3, m).astype(np.int32),
        uop_hit_cycles=rng.integers(1, 4, m).astype(np.int32),
        mem_latency=rng.integers(1, 12, m).astype(np.int32))


@functools.cache
def _fold_and_full(pkg, seed):
    """(folded, unfolded) counters of the seed's program at capacities
    (3, 8) x its 3 machines, as tests/test_folding.py sweeps them."""
    _, _, sim, _ = PKG[pkg]
    rng = np.random.default_rng(seed)
    program = _random_repeat_program(pkg, rng)
    machines = _random_machines(sim, rng)
    sweep = sim.SweepConfig.make([3, 8])
    kw = {} if pkg == "ref" else dict(device="cpu")
    fold = sim.simulate_grid(
        [sim.prepare(program, fold=True, machine=machines)], sweep,
        machines, **kw)
    full = sim.simulate_grid([sim.prepare(program)], sweep, machines, **kw)
    return ({k: v[0] for k, v in fold.items()},
            {k: v[0] for k, v in full.items()})


@pytest.mark.parametrize("seed", sorted(R1_GAPS))
def test_folded_counters_equal_reference_at_the_r1_seeds(seed):
    """The port's folded and unfolded counters equal the reference's,
    bitwise, fold_exact included."""
    want_fold, want_full = _fold_and_full("ref", seed)
    got_fold, got_full = _fold_and_full("port", seed)
    for k in jsim.COUNTER_NAMES:
        np.testing.assert_array_equal(got_fold[k], want_fold[k], err_msg=k)
        np.testing.assert_array_equal(got_full[k], want_full[k], err_msg=k)
    np.testing.assert_array_equal(got_fold["fold_exact"],
                                  want_fold["fold_exact"])


@pytest.mark.parametrize("pkg", ["ref", "port"])
@pytest.mark.parametrize("seed", sorted(R1_GAPS))
def test_r1_gap_pinned_on_both_sides(seed, pkg):
    """R1: every grid point certifies fold_exact, the other 11 counters
    agree with the unfolded run, and cycles differ by the pinned gap."""
    fold, full = _fold_and_full(pkg, seed)
    assert fold["fold_exact"].all()
    for k in jsim.COUNTER_NAMES[1:]:
        np.testing.assert_array_equal(fold[k], full[k], err_msg=k)
    gap = fold["cycles"].astype(np.int64) - full["cycles"]
    assert gap.tolist() == R1_GAPS[seed]
