"""Multi-pod dry run: plan every (arch x shape) cell on the production
meshes, proving the distribution config is coherent without hardware.

The reference lowers and compiles each cell for 256 or 512 TPU devices
and reads XLA's memory and cost analyses.  The port has no compiler in
between: its counterpart runs the cell's step once, in this process, on
shape-only tensors over a fake process group of the mesh's world size
(``torch.testing._internal.distributed.fake_pg``; every collective is
recorded and moves nothing).  The parameters, the AdamW state, the batch
and the cache are DTensors placed by ``launch.sharding``'s rules whose
local shards are ``meta`` tensors (shape, dtype and strides, no storage,
no arithmetic), so each op runs on one rank's local shard, as it would
on each device.  ``meta`` and not ``FakeTensorMode``: DTensor's sharding
propagation reads the mesh's real coordinates, which the fake mode would
fake.

Per cell this reports:
  - whether the step ran (``status``; ``reason`` for a skipped cell),
  - the peak bytes one device holds over the step (``bytes_per_device``:
    ``torch.distributed._tools.mem_tracker.MemTracker``'s peak over the
    local shards) -> ``fits_80g`` (an H100's 80 GB),
  - per-device dot FLOPs, bytes accessed and collective bytes by kind
    (``launch.hlo_cost``: the recurrences' time loops and the microbatch
    loop run one step, scaled by their trip count),
  - ``lower_s`` (placing the specs) and ``compile_s`` (the step on
    ``meta`` shards): the plan's wall time.

The eager count has no once-per-loop-body undercount, so ``flops`` and
``bytes_accessed`` equal ``dot_flops_loop_corrected`` and
``bytes_loop_corrected``; the reference's keys are kept.  Under loop
scaling a recurrence holds one step's saved activations, not the
loop's, so ``bytes_per_device`` of an SSM or hybrid train cell is a
lower bound (``loops_scaled`` says so).

The fake group is process-wide state: :func:`run_cell` starts it and
tears it down around each cell, and refuses to run inside a process
that already has a group.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k --mesh single --out /tmp/cell.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi \
      --jobs 8 --out results/dryrun_torch/all_multi.json

``--all --shape train_4k`` plans every arch at that shape; ``--jobs``
plans that many cells at once, each in a process of its own.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time

# Per-arch microbatch counts for train_4k (the reference's, chosen for
# activation-memory fit on 16 GB; kept so the plans compare).
TRAIN_MICROBATCHES = {
    "command-r-plus-104b": 8,
    "phi3.5-moe-42b-a6.6b": 4,
    "deepseek-v2-lite-16b": 2,
    "falcon-mamba-7b": 2,
}
HBM_BYTES = 80e9                 # one H100's HBM


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks (this process is rank
    0), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already running; plan a "
                           "cell in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _nccl_all_to_all():
    """Within the plan, a shard-to-shard redistribute is the all-to-all
    NCCL runs on the cards (the shard cut into n pieces, one to each
    rank of the mesh dim, the received pieces joined), not the
    all-gather and chunk DTensor falls back to on a CPU mesh (gloo has
    no all-to-all)."""
    import torch
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import placement_types

    def all_to_all(x, gather_dim, shard_dim, mesh, mesh_dim):
        parts = torch.stack(x.chunk(mesh.size(mesh_dim), dim=shard_dim))
        recv = funcol.all_to_all_single(parts, None, None,
                                        (mesh, mesh_dim))
        if isinstance(recv, funcol.AsyncCollectiveTensor):
            recv = recv.wait()
        return torch.cat(recv.unbind(0), dim=gather_dim)

    old = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = all_to_all
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = old


def _mesh_label(shape) -> str:
    return "x".join(str(n) for n in shape)


def _tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensors(v)
        else:
            yield v


def _local_mem_tracker():
    """A MemTracker that counts each rank's local tensors only, as 2.13's
    does by itself: it leaves DTensor ops to DTensor and sees their local
    ops, and skips the global-shaped fake tensors on which DTensor infers
    an op's output shape."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.hlo_cost import shape_inference

    class LocalMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented          # see DTensor's local ops
            if shape_inference(types):
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)
    return LocalMemTracker()


def _step(cfg, shape, model, placed, microbatches):
    """The cell's step as a closure over its placed inputs."""
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import make_train_step
    if shape.kind == "train":
        step = make_train_step(cfg, adamw.OptConfig(),
                               microbatches=microbatches)
        return lambda: step(model, placed["opt"], None, placed["batch"])
    if shape.kind == "decode":
        return lambda: model.decode_step(placed["cache"], placed["batch"])
    return lambda: model.prefill(placed["batch"])


def _plan(arch_name, cfg, shape, mesh, microbatches) -> dict:
    """Place the cell's specs on ``mesh`` (``meta`` local shards) and run
    its step once, counted."""
    from repro_torch.launch import hlo_cost
    from repro_torch.launch import sharding as shr
    from repro_torch.launch import specs as specs_mod
    from repro_torch.models import common

    t0 = time.perf_counter()
    sp = specs_mod.input_specs(arch_name, shape)
    psh = shr.params_shardings(sp["params"], mesh, cfg)
    model = shr.distribute_model(specs_mod.meta_model(arch_name), psh)
    placed = {"batch": shr.place_tree(sp["batch"], shr.batch_shardings(
        sp["batch"], mesh, shape.kind))}
    if shape.kind == "train":
        placed["opt"] = shr.place_tree(
            sp["opt"], shr.opt_shardings(sp["opt"], psh, mesh))
    if shape.kind == "decode":
        placed["cache"] = shr.place_tree(
            sp["cache"], shr.cache_shardings(sp["cache"], mesh))
    step = _step(cfg, shape, model, placed, microbatches)
    t1 = time.perf_counter()
    tracker = _local_mem_tracker()
    tracker.track_external(model, *_tensors(placed))
    with common.mesh_context(mesh), _nccl_all_to_all(), tracker, \
            hlo_cost.counting(scale_loops=True) as counter:
        step()
    t2 = time.perf_counter()
    peak = tracker.get_tracker_snapshot("peak")
    top = max(peak.values(), key=lambda snap: snap.get("Total", 0),
              default={})
    per_device = int(top.get("Total", 0))
    return dict(status="ok", lower_s=round(t1 - t0, 1),
                compile_s=round(t2 - t1, 1), bytes_per_device=per_device,
                fits_80g=bool(per_device < HBM_BYTES),
                memory_breakdown={getattr(k, "value", k): int(v)
                                  for k, v in top.items()},
                totals=counter.totals())


def run_cell(arch_name: str, shape_name, multi_pod: bool = False,
             parse_collectives: bool = True, verbose: bool = True, *,
             mesh_shape=None, microbatches: int | None = None) -> dict:
    """Plan one cell: its step on ``meta`` shards over a fake group.
    ``shape_name`` is a ``SHAPES`` key or a ``ShapeConfig``;
    ``mesh_shape`` (n_data, n_model) replaces the production mesh (a
    debug mesh), and ``microbatches`` the train cell's count."""
    from repro_torch.configs import SHAPES, cell_runnable, get
    from repro_torch.launch.mesh import make_mesh, production_shape

    cfg = get(arch_name)
    shape = (SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    if mesh_shape is None:
        dims, axes = production_shape(multi_pod)
    else:
        dims, axes = tuple(mesh_shape), ("data", "model")
    result = {"arch": arch_name, "shape": shape.name,
              "mesh": _mesh_label(dims)}
    ok, why = cell_runnable(cfg, shape)
    if not ok:
        result.update(status="skip", reason=why)
        return result

    mb = 1
    if shape.kind == "train":
        mb = (microbatches if microbatches is not None
              else TRAIN_MICROBATCHES.get(arch_name, 1))
        result["microbatches"] = mb
    with fake_world(math.prod(dims)):
        mesh = make_mesh(dims, axes, "cpu")
        result.update(_plan(arch_name, cfg, shape, mesh, mb))
    hc = result.pop("totals")
    result.update(flops=hc["dot_flops"], bytes_accessed=hc["bytes_accessed"],
                  dot_flops_loop_corrected=hc["dot_flops"],
                  bytes_loop_corrected=hc["bytes_accessed"],
                  loops_scaled=bool(cfg.ssm or cfg.hybrid))
    if parse_collectives:
        result["collectives"] = {k: hc[k] for k in (
            "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute", "collective_bytes", "collective_count")}
    if verbose:
        print(json.dumps(result, indent=1), flush=True)
    return result


def _cell(arch: str, shape: str, multi_pod: bool, collectives: bool) -> dict:
    """One cell's record; a cell that raises is recorded as an error with
    the port's frames it raised through (the sweep goes on)."""
    try:
        return run_cell(arch, shape, multi_pod, collectives, verbose=False)
    except Exception as e:
        import traceback
        frames = [f"{f.filename.rsplit('src/', 1)[-1]}:{f.lineno}"
                  for f in traceback.extract_tb(e.__traceback__)
                  if "repro_torch" in f.filename]
        return {"arch": arch, "shape": shape, "status": "error",
                "error": repr(e)[:500], "where": frames[-6:]}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Plan (arch x shape) cells on the production meshes: "
                    "meta tensors over a fake process group, no card.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-collectives", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells planned at once, each in a fresh process")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCHS, SHAPES
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    # with --all, --arch and --shape (if given) narrow the sweep
    cells = ([(args.arch, args.shape)] if not args.all else
             [(a, s) for a in ARCHS for s in SHAPES
              if args.arch in (None, a) and args.shape in (None, s)])
    multi, coll = args.mesh == "multi", not args.no_collectives
    if args.jobs > 1:
        import concurrent.futures
        import multiprocessing
        with concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn"),
                max_tasks_per_child=1) as pool:
            results = list(pool.map(_cell, *zip(*cells),
                                    [multi] * len(cells),
                                    [coll] * len(cells)))
    else:
        results = [_cell(a, s, multi, coll) for a, s in cells]
    for r in results:
        print(json.dumps(r), flush=True)
        if r["status"] == "error":
            print(r, file=sys.stderr, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    bad = [r for r in results if r["status"] == "error"]
    print(f"\n{len(results) - len(bad)}/{len(results)} cells ok")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
