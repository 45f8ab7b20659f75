"""The caching allocator's device allocations (``cudaMalloc``) a training
step: the port's ``alloc.device_allocs`` counter on each step span
(the change of ``torch.cuda.memory_stats()["num_device_alloc"]`` over
the step), summed over the window, over its steps.  0 when the cache
serves every step."""

from portbench import program_spans


def read(ctx):
    return program_spans.device_allocs(ctx)
