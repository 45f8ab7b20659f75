"""The share of the optimizer's parameter updates that ran through the
port's fused AdamW kernels over the window, in %: the port counts, on
its span ``repro_torch.optim.update``, ``optim.params`` (the parameters
a step updates) and ``optim.fused_params`` (those the fused kernels
updated); 100 x the second's sum over the first's, over the window's
steps.  None where the program counts neither (no such counters, or no
tracer)."""

from portbench import program_spans

PARAMS = "optim.params"
FUSED = "optim.fused_params"


def read(ctx):
    got = program_spans.window(ctx)
    if got is None:
        return None
    spans = got[1]["optimizer"]
    counts = [(s["counters"].get(FUSED), s["counters"].get(PARAMS))
              for s in spans]
    if not counts or any(f is None or n is None for f, n in counts):
        return None
    total = sum(n for _, n in counts)
    if not total:
        return None
    return 100.0 * sum(f for f, _ in counts) / total
