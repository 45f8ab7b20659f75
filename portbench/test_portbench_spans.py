"""CPU tests of the readers of the port's own spans
(``portbench/program_spans.py`` and the metrics that use it), on a
hand-built trace and a hand-built record."""

import sys

import pytest

from portbench import harness, program_spans

T0 = 1_792_000_000_000_000_000     # the port's clock at the window's start
LAG_NS = 30_000                    # benchmark span to port span
STEPS = 3
BENCH = [(0.010 + 0.1 * i, 0.100 + 0.1 * i) for i in range(STEPS)]
# phases, relative to their step's start (s)
PHASE_AT = {"forward": (0.001, 0.030), "backward": (0.030, 0.070),
            "optimizer": (0.070, 0.085)}


class StandInTrace:
    """What the readers take of ``harness.Trace``."""

    def __init__(self, ops, spans, window_s):
        self.ops, self.spans, self.window_s = ops, spans, window_s


def _ops():
    """Device operations: a step's phases busy but for one gap ending in
    forward (2 ms), in backward (3 ms), in the optimizer (1 ms); the idle
    between steps ends before the step, at the batch's copy."""
    ops = []
    for b0, _ in BENCH:
        f0, f1 = (b0 + t for t in PHASE_AT["forward"])
        w0, w1 = (b0 + t for t in PHASE_AT["backward"])
        o0, o1 = (b0 + t for t in PHASE_AT["optimizer"])
        ops += [("copy", b0 - 0.002, f0),
                ("fwd", f0, f0 + 0.010), ("fwd", f0 + 0.012, f1),
                ("bwd", w0, w0 + 0.020), ("bwd", w0 + 0.023, w1),
                ("opt", o0, o0 + 0.005), ("opt", o0 + 0.006, o1)]
    return ops


def _record(skew_ns=(0, 0, 0), device_ms=True, allocs=(0, 0, 0)):
    rec = []
    for i, (b0, b1) in enumerate(BENCH):
        base = T0 + round(b0 * 1e9)
        root = dict(name=program_spans.STEP, parent=None, step=3 + i,
                    index=len(rec), start_ns=base + LAG_NS + skew_ns[i],
                    end_ns=T0 + round(b1 * 1e9), device_ms=None,
                    counters={} if allocs is None else
                    {program_spans.ALLOCS: allocs[i]})
        rec.append(root)
        for phase, (s, e) in PHASE_AT.items():
            rec.append(dict(
                name=program_spans.PHASES[phase], parent=root["index"],
                step=3 + i, index=len(rec),
                start_ns=base + round(s * 1e9) + skew_ns[i],
                end_ns=base + round(e * 1e9) + skew_ns[i],
                device_ms=(e - s) * 1e3 if device_ms else None, counters={}))
    return rec


def _ctx():
    spans = [("portbench.train.step", s, e) for s, e in BENCH]
    return dict(steps=STEPS, window_s=0.31,
                trace=StandInTrace(_ops(), spans, 0.31))


def test_offset_found():
    off_ns, skew = program_spans.offset(_ctx(), _record())
    assert off_ns == T0 + LAG_NS and skew == 0.0


def test_idle_partitions_into_phases_and_the_rest():
    ctx = _ctx()
    idle = program_spans.idle_ms(ctx, _record())
    assert idle["forward"] == pytest.approx(2.0)
    assert idle["backward"] == pytest.approx(3.0)
    assert idle["optimizer"] == pytest.approx(1.0)
    trace = ctx["trace"]
    whole = (trace.window_s - harness.Trace.busy_s(trace)) / STEPS * 1e3
    assert sum(idle.values()) == pytest.approx(whole, abs=1e-9)
    # between steps (the metrics read, the feed) and at the window's ends
    assert idle["rest"] == pytest.approx(whole - 6.0)
    assert idle["rest"] * STEPS == pytest.approx(8 + 2 * 13 + 15)


def test_a_skewed_step_gives_no_idle_reading(monkeypatch):
    rec = _record(skew_ns=(0, 1_000_000, 0))
    assert program_spans.offset(_ctx(), rec)[1] == pytest.approx(1e-3)
    assert program_spans.idle_ms(_ctx(), rec) is None
    monkeypatch.setattr(program_spans, "record", lambda: rec)
    for phase in program_spans.PHASES:
        read = harness.metric_reader(f"train.{phase}_idle_ms")
        assert read(_ctx()) is None
    ok = _record(skew_ns=(0, 150_000, 0))
    monkeypatch.setattr(program_spans, "record", lambda: ok)
    assert harness.metric_reader("train.forward_idle_ms")(_ctx()) \
        == pytest.approx(2.0)


def test_window_readers(monkeypatch):
    monkeypatch.setattr(program_spans, "record", lambda: _record())
    for phase, (s, e) in PHASE_AT.items():
        got = harness.metric_reader(f"train.{phase}_ms")(_ctx())
        assert got == pytest.approx((e - s) * 1e3)
    monkeypatch.setattr(program_spans, "record",
                        lambda: _record(device_ms=False))
    for phase in PHASE_AT:
        assert harness.metric_reader(f"train.{phase}_ms")(_ctx()) is None


def test_device_allocs_reads_zero_as_zero(monkeypatch):
    read = harness.metric_reader("train.device_allocs")
    monkeypatch.setattr(program_spans, "record", lambda: _record())
    assert read(_ctx()) == 0
    monkeypatch.setattr(program_spans, "record",
                        lambda: _record(allocs=(3, 0, 0)))
    assert read(_ctx()) == pytest.approx(1.0)
    monkeypatch.setattr(program_spans, "record",
                        lambda: _record(allocs=None))
    assert read(_ctx()) is None


def test_only_the_windows_steps_are_read():
    """Steps recorded before the window (an earlier profiled stretch)
    are left out: the window's are the last ``steps`` roots."""
    early = _record()
    rec = [dict(s, index=s["index"], step=s["step"] - 3) for s in early]
    n = len(rec)
    rec += [dict(s, index=s["index"] + n,
                 parent=None if s["parent"] is None else s["parent"] + n)
            for s in early]
    assert program_spans.offset(_ctx(), rec) == (T0 + LAG_NS, 0.0)
    assert program_spans.window_ms(_ctx(), "forward", rec) == pytest.approx(
        29.0)
    assert program_spans.window(dict(_ctx(), steps=7), rec) is None


def test_a_tree_without_the_tracer_reads_nothing(monkeypatch):
    pkg = sys.modules.get("repro_torch.runtime")
    if pkg is not None:
        monkeypatch.delattr(pkg, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.tracing", None)
    assert program_spans.record() is None
    for name in ("train.forward_ms", "train.backward_ms",
                 "train.optimizer_ms", "train.forward_idle_ms",
                 "train.backward_idle_ms", "train.optimizer_idle_ms",
                 "train.device_allocs"):
        assert harness.metric_reader(name)(_ctx()) is None
        assert harness.metric_reader(name)(dict(_ctx(), trace=None)) is None
