"""CPU tests of the reader of the optimizer's fused share
(``metrics/train.opt_fused_pct.py``) on a hand-built record of the
port's spans, as ``test_portbench_spans.py`` builds it."""

import pytest

from portbench import harness, program_spans
from portbench.test_portbench_spans import STEPS, _ctx, _record

READ = "train.opt_fused_pct"
OPT = program_spans.PHASES["optimizer"]


def _counted(fused, params):
    """The record with the optimizer span of step i counting fused[i] of
    params[i] parameters (a None leaves that counter out)."""
    rec = _record()
    opt = [s for s in rec if s["name"] == OPT]
    assert len(opt) == STEPS
    for s, f, n in zip(opt, fused, params):
        if f is not None:
            s["counters"]["optim.fused_params"] = f
        if n is not None:
            s["counters"]["optim.params"] = n
    return rec


@pytest.mark.parametrize("fused, params, want", [
    ((3_821_079_552,) * STEPS, (3_821_079_552,) * STEPS, 100.0),
    ((0,) * STEPS, (10,) * STEPS, 0.0),
    ((10, 0, 10), (10, 10, 10), 200 / 3),
])
def test_share_of_parameters_updated_by_the_kernels(monkeypatch, fused,
                                                    params, want):
    monkeypatch.setattr(program_spans, "record",
                        lambda: _counted(fused, params))
    assert harness.metric_reader(READ)(_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("fused, params", [
    ((None,) * STEPS, (None,) * STEPS),     # a program without the counters
    ((10, None, 10), (10, 10, 10)),
    ((0,) * STEPS, (0,) * STEPS),
])
def test_no_reading_without_the_counters(monkeypatch, fused, params):
    monkeypatch.setattr(program_spans, "record",
                        lambda: _counted(fused, params))
    assert harness.metric_reader(READ)(_ctx()) is None


def test_no_reading_without_a_record(monkeypatch):
    monkeypatch.setattr(program_spans, "record", lambda: None)
    assert harness.metric_reader(READ)(_ctx()) is None
    monkeypatch.setattr(program_spans, "record", lambda: [])
    assert harness.metric_reader(READ)(_ctx()) is None
