"""The front door's own time per query, in ms: the query's wall minus the
Session's engine seconds over it (``api.Session.run``: planning, the
refine choice, assembling the result)."""


def read(ctx):
    qs = ctx["queries"]
    if not qs:
        return None
    return sum(q["latency_s"] - q["engine_s"] for q in qs) / len(qs) * 1e3
