"""The forward's device window a training step, in ms: the port's span
``repro_torch.train.forward`` (``train_logits`` and the f32 cross-
entropy) records a CUDA event at entry and at exit; the time between
them, summed over the window's microbatches, over its steps. A window
holds the phase's device work and any idle while the device waited on
its launches. None without events (on the CPU)."""

from portbench import program_spans


def read(ctx):
    return program_spans.window_ms(ctx, "forward")
