"""The model step's device time per training step, in ms: every device
operation of the window that the host did not issue inside the
optimizer's span (``portbench.train.opt``): forward, backward with its
recomputation, the loss, the batch's copy."""


def read(ctx):
    trace, steps = ctx["trace"], ctx["steps"]
    if trace is None or not steps:
        return None
    s = trace.device_seconds(outside="portbench.train.opt")
    return s / steps * 1e3 if s > 0 else None
