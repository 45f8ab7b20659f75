"""The device's idle a training step, in ms, in gaps that ended while
the host was inside the port's span ``repro_torch.optim.update``: the
device starved until the host, in that phase, issued the next operation.
Gaps from the trace's operations, the span put on the trace's clock by
the offset of ``program_spans.offset``; None where a step strays from it
by more than ``program_spans.MAX_SKEW_S``."""

from portbench import program_spans


def read(ctx):
    idle = program_spans.idle_ms(ctx)
    return None if idle is None else idle["optimizer"]
