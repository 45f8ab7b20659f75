"""The engine front end's time per query, in ms: the Session's engine
seconds (``simulate_grid``: ``_stack``, ``pack``, copies to and from the
card, waiting on K1) less K1's device time."""

from portbench import yardstick


def read(ctx):
    trace, qs = ctx["trace"], ctx["queries"]
    if trace is None or not qs:
        return None
    engine = sum(q["engine_s"] for q in qs) / len(qs)
    k1 = trace.device_seconds(yardstick.K1_KERNELS) / len(qs)
    if k1 <= 0:
        return None
    return (engine - k1) * 1e3
