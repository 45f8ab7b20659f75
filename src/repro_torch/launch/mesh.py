"""Production mesh construction.

Defined as FUNCTIONS (not module constants) so importing this module
never touches a process group.  Single pod = 256 devices as (16 data x 16
model); multi-pod adds a leading pure-DP "pod" axis (2 x 16 x 16 = 512
devices).  The shapes and axis names are the reference's, so the port's
shard shapes compare with its own one for one.

On H100 systems NVLink joins 8 cards of one host; a 16-way ``model``
axis therefore crosses two NVLink domains, and its collectives run at
the inter-host network's rate, not NVLink's.  The shapes are kept
anyway: they are the plan the reference's numbers are for.

A ``DeviceMesh`` is built with ``init_device_mesh`` over the process
group already started (NCCL on cards, gloo on CPUs, or the fake group of
``launch.dryrun``); its size must be the group's world size.
``models.common.AbstractMesh(*production_shape())`` gives the same shape
with no group behind it, for reading the sharding rules.
"""

from __future__ import annotations

import math


def production_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_mesh(shape, axis_names, device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` over the current process group;
    ``device_type`` defaults to ``cuda`` under NCCL, else ``cpu``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: start one first (init_process_group, or "
            "launch.dryrun.fake_world for a plan)")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the group has {dist.get_world_size()}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    return make_mesh(*production_shape(multi_pod), device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2,
                    device_type: str | None = None):
    """Small mesh for CI-size sharding tests (n_data * n_model ranks:
    gloo processes on the CPU, or a fake group)."""
    return make_mesh((n_data, n_model), ("data", "model"), device_type)
