"""The 90th percentile of the traced window's query latencies, send to
result, in ms (the front door as the sweep's user sees it)."""

import statistics


def read(ctx):
    lat = [q["latency_s"] * 1e3 for q in ctx["queries"]]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=10)[8]
