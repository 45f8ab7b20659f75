"""K1's device time per query, in ms: the profiler's time of K1a and K1b
(their kernels by name, ``yardstick.K1_KERNELS``) over the traced window,
divided by the queries."""

from portbench import yardstick


def read(ctx):
    trace, n = ctx["trace"], len(ctx["queries"])
    if trace is None or not n:
        return None
    s = trace.device_seconds(yardstick.K1_KERNELS)
    return s / n * 1e3 if s > 0 else None
