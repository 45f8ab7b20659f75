"""The share of the traced window in which no operation ran on the card,
in %."""


def read(ctx):
    trace = ctx["trace"]
    if trace is None or trace.window_s <= 0:
        return None
    return (1.0 - trace.busy_s() / trace.window_s) * 100.0
