"""K1's share of its bytes roofline, in %: the least time one query's
engine work can take at HBM bandwidth (``yardstick.k1_bytes_bound`` of
the programs' unfolded rows and the query's grid) over K1's device time
per query."""

from portbench import yardstick


def read(ctx):
    trace, n = ctx["trace"], len(ctx["queries"])
    if trace is None or not n:
        return None
    k1 = trace.device_seconds(yardstick.K1_KERNELS) / n
    if k1 <= 0:
        return None
    least = ctx["k1_bound_bytes"] / yardstick.HBM_BYTES_PER_S
    return least / k1 * 100.0
