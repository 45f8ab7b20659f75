"""The port's tracer (``repro_torch.runtime.tracing``) on the CPU: off
without a profiler, and under one the training step's spans, their
nesting and step numbers, their clock against the profiler's events,
and the benchmark's trace left free of them."""

import dataclasses
import time

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from portbench import harness, program_spans  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import tracing  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

STEP, FWD, BWD, OPT = ("repro_torch.train.step", "repro_torch.train.forward",
                       "repro_torch.train.backward",
                       "repro_torch.optim.update")


@pytest.fixture(autouse=True)
def empty_record():
    tracing.clear()
    yield
    tracing.clear()


def _tiny(microbatches):
    """The CPU training tests' reduced f32 phi3-mini, its optimizer
    state, a step function and one batch of 2 x 16 tokens."""
    cfg = dataclasses.replace(get("phi3-mini-3.8b").reduced(),
                              dtype="float32")
    torch.manual_seed(0)
    model = Model(cfg, device="cpu")
    opt = adamw.init_state(dict(model.named_parameters()))
    step = make_train_step(cfg, adamw.OptConfig(), microbatches=microbatches)
    tok = torch.randint(0, cfg.vocab_size, (2, 17))
    batch = {"tokens": tok[:, :-1].int(), "targets": tok[:, 1:].int(),
             "positions": torch.arange(16, dtype=torch.int32).expand(2, 16)}
    return model, opt, step, batch


def _traced(microbatches, bench_span=False):
    """One untraced step, then one under a CPU profiler (inside the
    benchmark's own step span with ``bench_span``)."""
    model, opt, step, batch = _tiny(microbatches)
    step(model, opt, None, batch)
    prof = harness.profiler()
    prof.start()
    t0 = time.time_ns()
    t = time.perf_counter()
    with harness.span("portbench.train.step", prof if bench_span else None):
        step(model, opt, None, batch)
    window_s = time.perf_counter() - t
    prof.stop()
    return prof, t0, window_s


def test_off_without_a_profiler(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function reached with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    model, opt, step, batch = _tiny(2)
    step(model, opt, None, batch)
    with tracing.span("repro_torch.test.outer"):
        tracing.count("n", 1)
    assert tracing.recorded() == []
    assert tracing.device_allocs("cpu") is None


@pytest.mark.parametrize("microbatches", [1, 2])
def test_step_spans_nest_and_carry_the_step(microbatches):
    _traced(microbatches)
    rec = tracing.recorded()
    names = [s["name"] for s in rec]
    assert names == [STEP] + [FWD, BWD] * microbatches + [OPT]
    root = rec[0]
    assert root["parent"] is None and root["index"] == 0
    assert root["step"] == 1             # the step function's second call
    for s in rec[1:]:
        assert s["parent"] == 0 and s["step"] == 1
        assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= root["end_ns"]
    for a, b in zip(rec[1:], rec[2:]):
        assert a["end_ns"] <= b["start_ns"]
    # on the CPU: no events, no allocator counter; the optimizer counts
    # its parameters, none of them through the fused kernels
    assert all(s["device_ms"] is None for s in rec)
    assert all(s["counters"] == {} for s in rec[:-1])
    n = sum(p.numel() for p in _tiny(1)[0].parameters())
    assert rec[-1]["counters"] == {"optim.params": n,
                                   "optim.fused_params": 0}


def test_span_clock_is_the_profilers():
    prof, _, _ = _traced(2)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("repro_torch.")]
    # host events with no shadow on the device's timeline
    assert all(e.activity_type() == "cpu_op" for e in events)
    rec = tracing.recorded()
    assert [e.name() for e in sorted(events, key=lambda e: e.start_ns())] \
        == [s["name"] for s in rec]
    for e, s in zip(sorted(events, key=lambda e: e.start_ns()), rec):
        assert abs(s["start_ns"] - e.start_ns()) < 1_000_000, s["name"]


def test_counters_add_on_the_innermost_span():
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("repro_torch.test.outer", step=7):
            tracing.count("a", 2)
            with tracing.span("repro_torch.test.inner"):
                tracing.count("a", 1)
                tracing.count("a", 1)
    outer, inner = tracing.recorded()
    assert outer["counters"] == {"a": 2} and inner["counters"] == {"a": 2}
    assert outer["step"] == inner["step"] == 7 and inner["parent"] == 0


def test_benchmark_trace_holds_no_port_span():
    prof, t0, window_s = _traced(2, bench_span=True)
    trace = harness.Trace(prof, t0, window_s)
    assert [n for n, _, _ in trace.spans] == ["portbench.train.step"]
    assert not any(n.startswith("repro_torch.") for n, _, _ in trace.ops)
    # the port's step pairs with the benchmark's, microseconds later
    ctx = dict(steps=1, trace=trace, window_s=window_s)
    rec = tracing.recorded()
    off_ns, skew = program_spans.offset(ctx, rec)
    assert skew == 0.0
    assert t0 <= off_ns <= rec[0]["start_ns"]
