"""Loop-aware cost count of one step, per device: the counterpart of the
reference's HLO analyzer.

The reference parses the optimized HLO text of a compiled step and walks
it with loop multipliers, because XLA's ``cost_analysis`` counts each
while-loop body once.  The port has no HLO: a step is eager PyTorch,
run on ``meta`` shards over a fake process group (``launch.dryrun``).  So
this module counts the step as it runs, in one ``TorchDispatchMode``:

  * dot FLOPs by ``FlopCounterMode``'s own formulas
    (``torch.utils.flop_counter.flop_registry``: mm, bmm, addmm,
    baddbmm, convolutions, attention);
  * collectives as ``CommDebugMode`` sees them: the functional
    collectives (``_c10d_functional``) that each DTensor redistribute
    issues, with the bytes of their results, by the reference's five
    kinds;
  * bytes accessed: each op's tensor inputs and outputs, views and
    allocations skipped (the reference skips bookkeeping ops likewise).

**Per device.**  ``FlopCounterMode`` around a DTensor program counts
the *global* op (its mode sees the DTensor before DTensor splits it).
The counter here returns ``NotImplemented`` for DTensor arguments, so
DTensor's dispatch runs first and the counter sees each rank's local op
on its local shard, and each collective on the local buffers: the
counts are this device's, as the reference's per-device HLO counts are.
(DTensor also runs each new op once on global-shaped fake tensors, under
a fake mode, to infer its output's shape; the counter skips those ops.)

**Loops.**  Layers and decode steps run as real Python loops and are
counted as they run.  The recurrences' time loops (``models.common.scan``:
Mamba's and the RG-LRU's) would run 32,768 steps of DTensor dispatch at
``prefill_32k``, and the microbatch loop (``common.repeat``) repeats a
whole forward and backward pass up to 8 times; with ``scale_loops`` the
counter runs one step and multiplies its counts by the trip count: what
runs while the step runs (its forward pass, a checkpoint's recompute, a
microbatch's backward pass) by a multiplier held meanwhile, and a
recurrence step's backward pass, which runs later, by the autograd nodes
the step created.  FLOPs so scaled equal the full loop's exactly (tests
hold them on a short sequence and on two microbatches).
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.models import common

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "isend": "collective-permute",
    "batch_p2p_ops": "collective-permute",
}
# allocations and bookkeeping: no bytes moved
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "lift_fresh", "_to_copy_meta",
             "wait_tensor", "set_", "resize_"}


def shape_inference(types) -> bool:
    """Whether an op is DTensor inferring an output's shape: run on
    global-shaped fake tensors under a fake mode (a factory op such as
    ``empty_strided`` has no tensor input to tell it by)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return (torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None
        or any(issubclass(t, FakeTensor) for t in types))


def _tensors(tree):
    out = []
    for x in torch.utils._pytree.tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            out.append(x)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts what one device runs inside the mode (see the module's
    docstring); :meth:`totals` gives the reference's ``analyze`` keys."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.bytes_accessed = 0.0
        self.coll_bytes = {c: 0.0 for c in COLLECTIVES}
        self.coll_count = 0.0
        self._mult = 1
        self._node_mult: dict = {}

    # ------------------------------------------------------------- loops
    def run_loop(self, n: int, body):
        """``body()``, one step of an n-step loop, with what it runs
        counted n times: now, and in the backward pass of the autograd
        nodes it created (those between the sequence numbers before and
        after it, reached from its outputs)."""
        lo = torch._C._autograd._get_sequence_nr()
        self._mult *= n
        try:
            out = body()
        finally:
            self._mult //= n
        hi = torch._C._autograd._get_sequence_nr()
        stack = [t.grad_fn for t in _tensors(out) if t.grad_fn is not None]
        seen = set()
        while stack:
            node = stack.pop()
            if node in seen or not lo <= node._sequence_nr() < hi:
                continue
            seen.add(node)
            self._node_mult[node] = self._node_mult.get(node, 1) * n
            stack.extend(f for f, _ in node.next_functions if f is not None)
        return out

    def _multiplier(self) -> int:
        node = torch._C._current_autograd_node()
        if torch.is_grad_enabled() or node is None:
            return self._mult                    # forward, or a recompute
        # backward: inside a scaled body (a microbatch) by the body's
        # count, and a node a scaled step created by its own
        return self._mult * self._node_mult.get(node, 1)

    # ----------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # count the local ops instead
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if shape_inference(types):
            return out
        m = self._multiplier()
        packet = func._overloadpacket
        if packet in flop_registry:
            self.dot_flops += m * flop_registry[packet](*args, **kwargs,
                                                        out_val=out)
        name = packet.__name__
        if func.namespace == "_c10d_functional":
            kind = _KIND.get(name)
            if kind is not None:
                self.coll_bytes[kind] += m * sum(map(_nbytes,
                                                     _tensors(out)))
                self.coll_count += m
            return out
        if not func.is_view and name not in _NO_BYTES:
            self.bytes_accessed += m * (
                sum(map(_nbytes, _tensors((args, kwargs))))
                + sum(map(_nbytes, _tensors(out))))
        return out

    def totals(self) -> dict:
        out = dict(self.coll_bytes)
        out["dot_flops"] = self.dot_flops
        out["bytes_accessed"] = self.bytes_accessed
        out["collective_count"] = self.coll_count
        out["collective_bytes"] = sum(self.coll_bytes.values())
        return out


@contextlib.contextmanager
def counting(scale_loops: bool = True):
    """A :class:`CostCounter` active around the block, and with
    ``scale_loops`` the models' loop hook (``common.scan``) set to it."""
    counter = CostCounter()
    if scale_loops:
        common.set_loop_hook(counter.run_loop)
    try:
        with counter:
            yield counter
    finally:
        if scale_loops:
            common.set_loop_hook(None)


def analyze(fn, *args, scale_loops: bool = True, **kwargs) -> dict:
    """Per-device totals of ``fn(*args, **kwargs)``: ``dot_flops``,
    ``bytes_accessed``, the five collective kinds' bytes,
    ``collective_bytes`` and ``collective_count`` (the reference's
    ``analyze`` keys)."""
    with counting(scale_loops) as counter:
        fn(*args, **kwargs)
    return counter.totals()
