"""The optimizer's device time per training step, in ms: the device
operations the host issued inside ``portbench.train.opt``, the span the
benchmark puts around ``optim.adamw.apply_updates``."""


def read(ctx):
    trace, steps = ctx["trace"], ctx["steps"]
    if trace is None or not steps:
        return None
    s = trace.device_seconds(span="portbench.train.opt")
    return s / steps * 1e3 if s > 0 else None
