"""The whole training step's share of the card's bf16 dense peak, in %:
the model FLOPs of a step from the published widths
(``yardstick.dense_lm_flops``) times the steps of the traced window,
over the window and 989 TFLOP/s."""

from portbench import yardstick


def read(ctx):
    if not ctx["steps"] or ctx["window_s"] <= 0:
        return None
    flops = ctx["flops_per_step"] * ctx["steps"]
    return flops / ctx["window_s"] / yardstick.BF16_DENSE_FLOPS * 100.0
