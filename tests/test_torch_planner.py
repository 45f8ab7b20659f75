"""The port's working-set planner (``core/planner.py``) against the JAX
reference's, at reduced size: the engine behind it is the port's twin on
the CPU, the reference's own engine on the other side."""

import dataclasses

import pytest

pytest.importorskip("torch")

from repro import rvv as jrvv  # noqa: E402
from repro.core import planner as jplan  # noqa: E402
from repro.core import policies as jpol  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro_torch import rvv as trvv  # noqa: E402
from repro_torch.core import planner as tplan  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402

CASES = [("pathfinder", jpol.FIFO, False), ("gemv", jpol.LRU, False),
         ("densenet121_l105", jpol.FIFO, False), ("dropout", jpol.OPT, True)]


def _programs(name):
    jb, tb = jrvv.BENCHMARKS[name], trvv.BENCHMARKS[name]
    return (jb.build(**jb.reduced_params).program,
            tb.build(**tb.reduced_params).program)


@pytest.mark.parametrize("name,policy,fold", CASES)
def test_min_registers_for_hit_rate_equals_reference(name, policy, fold):
    jp, tp = _programs(name)
    machine = dict(mem_latency=3, uop_hit_cycles=2)
    want = jplan.min_registers_for_hit_rate(
        jp, 0.9, policy=policy, fold=fold,
        machine=jsim.MachineParams(**machine))
    got = tplan.min_registers_for_hit_rate(
        tp, 0.9, policy=policy, fold=fold,
        machine=tsim.MachineParams(**machine), device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("name", ["pathfinder", "densenet121_l105"])
def test_policy_headroom_equals_reference(name):
    jp, tp = _programs(name)
    want = jplan.policy_headroom(jp, capacities=(2, 3, 4, 6))
    got = tplan.policy_headroom(tp, capacities=(2, 3, 4, 6), device="cpu")
    assert got == want
    assert set(got) == {"fifo", "lru", "lfu", "opt"}


@pytest.mark.parametrize("name", ["pathfinder", "gemv"])
def test_normalized_performance_equals_reference(name):
    jp, tp = _programs(name)
    want = jplan.normalized_performance(jp, (3, 4, 8), max_events=200)
    got = tplan.normalized_performance(tp, (3, 4, 8), max_events=200,
                                       device="cpu")
    assert got == want
    assert all(0 < v <= 1 for v in got.values())


def test_planner_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    _, tp = _programs("pathfinder")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tplan.min_registers_for_hit_rate(tp)
