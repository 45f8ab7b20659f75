"""Fused multi-tensor AdamW: the CUDA kernels' wrapper and the plain twin.

No kernel of the JAX package is replaced: the reference's
``optim/adamw.py`` is plain ``jnp``, left to XLA's fusion.  The plain
twin (:func:`adamw_plain`) is that arithmetic in torch, one leaf at a
time: ~21 elementwise ops a leaf and a cast, a square and a sum a leaf
for the global norm, ~7,300 launches a step over phi3-mini's 291
leaves.  The kernels (``csrc/adamw.cu``, which says what bounds them)
take the whole step in two launches: the global norm's partial sums,
then the update of every leaf, each element's gradient, ``m``, ``v`` and
master read once and ``m``, ``v``, master and parameter written once.

Given the same clip scale the kernel's new moments, masters and
parameters equal the plain twin's bitwise (the same f32 operations in
the same order, none contracted); ``grad_norm`` differs by its order of
summation (f64 partials here, f32 leaf sums there).

The route is chosen from where the leaves are (:func:`adamw_route`), and
:func:`adamw_step` counts the steps per route (``launches_fused``: steps
that ran the two kernels, counted beside the launches; ``launches_plain``:
steps on the plain twin); :func:`adamw_cuda` counts each kernel's
launches (``launches_norm``, ``launches_update``) and the table's copies
(``uploads``):

  * ``fused``: every gradient, ``m``, ``v`` and master (and parameter)
    on one CUDA device, plain tensors or DTensors.  The kernels take
    contiguous f32 or bf16 parameters and gradients, f32 state, and
    leaves whose five tensors one scalar head aligns to 16 bytes
    together (the caching allocator aligns every tensor it hands out);
    any other CUDA leaf raises, and nothing falls back after a launch.
    A DTensor leaf is updated shard by shard (``to_local``): the norm's
    partials are summed over the mesh between the two launches, and a
    shard replicated over a mesh dimension counts in the norm on that
    dimension's first rank only.  A parameter that is no tensor (a
    stand-in that only takes ``copy_``, as the benchmark's fault
    controls pass) is written by ``copy_`` from its new master.
    ``compress_grads`` on the card raises: the compression rounds each
    leaf by its own largest value, which the kernels do not compute.
  * ``plain``: CPU and ``meta`` tensors (the CPU tests, the dry-run
    plan), DTensors whose shards are there included.

Nothing is built or loaded until the first fused step.
"""

from __future__ import annotations

import array
import ctypes
import functools

import torch
import torch.distributed as dist

from repro_torch.kernels.rmsnorm import _device_stream
from repro_torch.kernels.routes import RouteCounted

# The kernels' tiling (csrc/adamw.cu): threads a CTA, elements a 16-byte
# vector group, elements a work item at most, int64 fields a table row.
TILE = dict(threads=256, group=8, item_elems=16384, entry=11)
VEC_BYTES = 16
# A table row's fields, in order (csrc/adamw.cu `Field`).
FIELDS = ("p", "g", "m", "v", "master", "n", "head", "groups", "flags",
          "item_begin", "items")
NO_NORM = 4                    # flag: the leaf is left out of this norm
_FLOATS = (torch.float32, torch.bfloat16)
_TENSORS = (torch.Tensor, torch.nn.Parameter)   # types that are no DTensor
MIN_NORM = 1e-12               # the norm's floor before the clip's division


# ---------------------------------------------------------------------------
# The plain twin: the reference's arithmetic, one leaf at a time.
# ---------------------------------------------------------------------------


def _full(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value (reducing partial sums); a tensor as is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


@torch.no_grad()
def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(_full(torch.sum(torch.square(x.to(torch.float32))))
                          for x in tree.values()))


def clip_scale(gnorm: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """The factor that scales the gradients to a global norm of at most
    ``clip_norm``."""
    return torch.clamp(clip_norm / torch.clamp(gnorm, min=MIN_NORM),
                       max=1.0)


@torch.no_grad()
def update_plain(cfg, params: dict, grads: dict, m: dict, v: dict,
                 master: dict, scale, lr, b1c, b2c, compress=None,
                 err: dict | None = None) -> None:
    """The update of every leaf of ``params`` given the clip ``scale``,
    ``lr`` and the bias corrections ``b1c``, ``b2c`` (0-d f32 tensors),
    in place: moments, masters, and parameters cast from the masters.
    ``compress(g, e) -> (g, e')`` rounds each scaled gradient with its
    error feedback ``err[k]``."""
    for k, p in params.items():
        g = grads[k].to(torch.float32) * scale
        if compress is not None:
            g, err[k] = compress(g, err[k])
        mk, vk, wk = m[k], v[k], master[k]
        mk.copy_(cfg.b1 * mk + (1 - cfg.b1) * g)
        vk.copy_(cfg.b2 * vk + (1 - cfg.b2) * g * g)
        del g
        upd = (mk / b1c) / (torch.sqrt(vk / b2c) + cfg.eps)
        upd += cfg.weight_decay * wk
        wk.sub_(lr * upd)
        del upd
        p.copy_(wk)


@torch.no_grad()
def adamw_plain(cfg, params, grads, m, v, master, lr, b1c, b2c,
                compress=None, err=None):
    """The plain twin of a whole step: the global norm, the clip scale,
    then :func:`update_plain`.  Returns (grad_norm, scale)."""
    gnorm = global_norm(grads)
    scale = clip_scale(gnorm, cfg.clip_norm)
    update_plain(cfg, params, grads, m, v, master, scale, lr, b1c, b2c,
                 compress, err)
    return gnorm, scale


# ---------------------------------------------------------------------------
# The route and the kernels' work table
# ---------------------------------------------------------------------------


def _leaves(params, grads, m, v, master):
    for k, p in params.items():
        yield k, (p, grads[k], m[k], v[k], master[k])


def _local(t):
    """A DTensor's shard on this rank; a tensor as is."""
    return t if type(t) in _TENSORS or not hasattr(t, "placements") \
        else t.to_local()


def adamw_route(cfg, params, grads, m, v, master) -> str:
    """``fused`` or ``plain`` for these leaves (module docstring).  Raises
    ``ValueError`` for CUDA leaves beside leaves elsewhere or on another
    card, for a gradient or state that is no tensor, and for
    ``compress_grads`` on the card; :func:`adamw_cuda` raises for CUDA
    leaves it does not take."""
    devices = set()                     # CUDA indices; -1 off the card
    for k, ts in _leaves(params, grads, m, v, master):
        for t in ts:
            if type(t) not in _TENSORS:
                if not torch.is_tensor(t):
                    if t is ts[0] and hasattr(t, "copy_"):
                        continue        # a stand-in parameter
                    raise ValueError(f"adamw: leaf {k!r} holds a "
                                     f"{type(t).__name__}, not a tensor")
                t = _local(t)
            devices.add(t.get_device())
    elsewhere = -1 in devices
    cards = devices - {-1}
    if not cards:
        return "plain"
    if elsewhere or len(cards) > 1:
        raise ValueError(f"adamw: leaves on cards {sorted(cards)} and "
                         f"{'elsewhere' if elsewhere else 'no other'}; the "
                         "fused step takes one CUDA device")
    if cfg.compress_grads:
        raise ValueError("adamw: compress_grads on the card: the fused "
                         "kernels do not round each leaf by its own largest "
                         "value; the compression runs on the CPU")
    return "fused"


def counts_in_norm(placements, coordinate) -> bool:
    """Whether this rank's shard of a leaf with ``placements`` counts in
    the global norm, at mesh ``coordinate``: on each mesh dimension the
    leaf is replicated over, only the first rank's copy counts, so that
    the sum over the mesh counts every element once."""
    if any(pl.is_partial() for pl in placements):
        raise ValueError(f"adamw: a leaf placed {tuple(placements)}; the "
                         "fused step takes sharded or replicated leaves")
    return all(c == 0 for pl, c in zip(placements, coordinate)
               if pl.is_replicate())


def _sharded(k, ts):
    """A DTensor leaf's five tensors as this rank holds them, its mesh,
    and whether its shard counts in the norm; a leaf of tensors as is
    (a DTensor beside them has no data pointer and raises)."""
    ref = ts[1]
    if type(ref) in _TENSORS or not hasattr(ref, "placements"):
        return ts, None, True
    mesh, placements = ref.device_mesh, tuple(ref.placements)
    for t in ts:
        if torch.is_tensor(t) and not (
                hasattr(t, "placements") and t.device_mesh == mesh
                and tuple(t.placements) == placements):
            raise ValueError(f"adamw: leaf {k!r}'s tensors are placed "
                             "differently")
    return (tuple(_local(t) for t in ts), mesh,
            counts_in_norm(placements, mesh.get_coordinate()))


# element sizes of (parameter, gradient, m, v, master) by (parameter bf16,
# gradient bf16)
_ELTS = {(pb, gb): (2 if pb else 4, 2 if gb else 4, 4, 4, 4)
         for pb in (False, True) for gb in (False, True)}


def _cuda_leaf(k, p, g, mk, vk, wk, in_norm=True):
    """(ptrs, elts, n, flags) of a leaf for :func:`work_table`; raises
    ``ValueError`` for what the kernels do not take.  A parameter that is
    no tensor gets a null pointer.  (Run for every leaf every step, so
    it reads each attribute once.)"""
    stand_in = not torch.is_tensor(p)
    shape, gd = wk.shape, g.dtype
    pd = torch.float32 if stand_in else p.dtype
    if not (g.shape == shape and mk.shape == shape and vk.shape == shape
            and (stand_in or p.shape == shape)):
        raise ValueError(f"adamw: leaf {k!r} has shapes "
                         f"{[tuple(t.shape) for t in (g, mk, vk, wk)]} "
                         f"(gradient, m, v, master)")
    if pd not in _FLOATS or gd not in _FLOATS or not (
            mk.dtype is vk.dtype is wk.dtype is torch.float32):
        raise ValueError(
            f"adamw: leaf {k!r} has parameter {pd}, gradient {gd}, state "
            f"{mk.dtype}/{vk.dtype}/{wk.dtype}; the kernels take f32 or "
            "bf16 parameters and gradients and f32 state")
    if not ((stand_in or p.is_contiguous()) and g.is_contiguous()
            and mk.is_contiguous() and vk.is_contiguous()
            and wk.is_contiguous()):
        raise ValueError(f"adamw: leaf {k!r} is not contiguous; the "
                         "kernels take contiguous tensors")
    pb, gb = pd is torch.bfloat16, gd is torch.bfloat16
    elts = _ELTS[pb, gb]
    if stand_in:
        elts = (0,) + elts[1:]
    flags = pb | gb << 1 | (0 if in_norm else NO_NORM)
    return ((0 if stand_in else p.data_ptr(), g.data_ptr(), mk.data_ptr(),
             vk.data_ptr(), wk.data_ptr()), elts, wk.numel(), flags)


def leaf_split(ptrs, elts, n: int) -> tuple[int, int]:
    """How a leaf of ``n`` elements whose five tensors start at ``ptrs``
    with ``elts`` bytes an element (0 for a null parameter) splits, as
    (head, groups): ``head`` scalar elements until every tensor sits on a
    16-byte boundary, ``groups`` vector groups of ``TILE["group"]``
    elements, the rest a scalar tail.  Raises ``ValueError`` where no
    head aligns all five."""
    group = TILE["group"]
    if not (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3] | ptrs[4]) % VEC_BYTES:
        return 0, n // group
    for h in range(group):
        if all((ptr + h * elt) % VEC_BYTES == 0
               for ptr, elt in zip(ptrs, elts)):
            head = min(h, n)
            return head, (n - head) // group
    raise ValueError(
        f"adamw: a leaf's tensors start at byte offsets "
        f"{[ptr % VEC_BYTES for ptr in ptrs]} mod {VEC_BYTES} with "
        f"{list(elts)} bytes an element (parameter, gradient, m, v, "
        "master); no head aligns them together")


def work_table(leaves) -> tuple[list[int], int, int]:
    """The kernels' table for ``leaves``, each (ptrs, elts, n, flags):
    the five tensors' addresses and element sizes (parameter, gradient,
    m, v, master), the element count and the flags (bit 0 the parameter,
    bit 1 the gradient is bf16, bit 2 ``NO_NORM``).  Returns the rows
    flattened (``FIELDS`` each), the number of rows and of work items.
    A leaf's work items each cover up to ``TILE["item_elems"]`` elements
    of its groups; the first also takes the head, the last the tail.
    Empty leaves get no row."""
    per = TILE["item_elems"] // TILE["group"]
    rows, nrows, begin = [], 0, 0
    for ptrs, elts, n, flags in leaves:
        if n == 0:
            continue
        head, groups = leaf_split(ptrs, elts, n)
        items = max(1, -(-groups // per))
        rows.extend(ptrs)
        rows.extend((n, head, groups, flags, begin, items))
        nrows += 1
        begin += items
    return rows, nrows, begin


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

# The C entry points' parameters (csrc/adamw.cu).
ARGTYPES = {
    "adamw_tile": [ctypes.c_void_p],
    "adamw_norm_launch": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                          ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    "adamw_update_launch": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                             ctypes.c_void_p, ctypes.c_int]
                            + [ctypes.c_void_p] * 3 + [ctypes.c_float] * 8
                            + [ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p]),
}
TILE_KEYS = ("threads", "group", "item_elems", "entry", "norm_ctas_per_sm",
             "update_ctas_per_sm", "norm_resident_per_sm",
             "update_resident_per_sm", "sms")


@functools.cache
def _library():
    """The built library, loaded once, with every entry point's ctypes
    signature set."""
    from repro_torch.kernels import _build

    lib = _build.load("adamw")
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


@functools.cache
def built_tile(device: int) -> dict:
    """The built kernels' tile on CUDA device ``device``
    (``adamw_tile``): ``TILE_KEYS``; the persistent grids are ``sms``
    times each kernel's resident CTAs a SM."""
    out = (ctypes.c_int * len(TILE_KEYS))()
    with torch.cuda.device(device):
        err = _library().adamw_tile(out)
    if err:
        raise RuntimeError(f"adamw_tile failed: cudaError {err}")
    return dict(zip(TILE_KEYS, out))


def _scalar(x, device) -> torch.Tensor:
    if not (torch.is_tensor(x) and x.device == device and x.numel() == 1
            and x.dtype == torch.float32):
        raise ValueError(f"adamw: lr and the bias corrections are 0-d f32 "
                         f"tensors on {device}, got {x!r}")
    return x


def _table_leaves(params, grads, m, v, master):
    """The leaves as :func:`work_table` takes them, the mesh of DTensor
    leaves (None without) and the stand-in parameters' keys."""
    leaves, meshes, stand_ins = [], set(), []
    for k, ts in _leaves(params, grads, m, v, master):
        local, mesh, in_norm = _sharded(k, ts)
        leaves.append(_cuda_leaf(k, *local, in_norm=in_norm))
        meshes.add(mesh)
        if not torch.is_tensor(ts[0]):
            stand_ins.append(k)
    if len(meshes) > 1:
        raise ValueError("adamw: leaves on more than one mesh, or DTensors "
                         "beside tensors")
    return leaves, meshes.pop() if meshes else None, stand_ins


@RouteCounted.over("norm", "update")
@torch.no_grad()
def adamw_cuda(cfg, params, grads, m, v, master, lr, b1c, b2c):
    """The step in two launches on CUDA leaves that :func:`adamw_route`
    sends to ``fused``.  Returns (grad_norm, scale), 0-d f32 tensors on
    the card.  Raises on a failed launch; never falls back."""
    leaves, mesh, stand_ins = _table_leaves(params, grads, m, v, master)
    rows, nrows, nitems = work_table(leaves)
    first = _local(next(iter(master.values())))
    device = first.device
    lr, b1c, b2c = (_scalar(x, device) for x in (lr, b1c, b2c))
    tile = built_tile(device.index)
    norm_grid = tile["sms"] * tile["norm_resident_per_sm"]
    update_grid = tile["sms"] * tile["update_resident_per_sm"]
    # one copy up a step, from pinned memory the caching host allocator
    # keeps until the copy is done
    table = torch.frombuffer(array.array("q", rows or [0]),
                             dtype=torch.int64).pin_memory().to(
                                 device, non_blocking=True)
    adamw_cuda.uploads += 1
    partials = torch.empty(norm_grid, dtype=torch.float64, device=device)
    stats = torch.empty(2, dtype=torch.float32, device=device)
    lib = _library()
    ctx, stream = _device_stream(first)
    with ctx:
        err = lib.adamw_norm_launch(table.data_ptr(), nrows, nitems,
                                    partials.data_ptr(), norm_grid, stream)
        if err:
            raise RuntimeError(f"adamw_norm launch failed: cudaError {err}")
        adamw_cuda.count({"route": "norm"})
        if mesh is not None:            # every shard's squares, summed
            for dim in range(mesh.ndim):
                dist.all_reduce(partials, group=mesh.get_group(dim))
        err = lib.adamw_update_launch(
            table.data_ptr(), nrows, nitems, partials.data_ptr(), norm_grid,
            lr.data_ptr(), b1c.data_ptr(), b2c.data_ptr(), cfg.b1,
            1 - cfg.b1, cfg.b2, 1 - cfg.b2, cfg.eps, cfg.weight_decay,
            cfg.clip_norm, MIN_NORM, stats.data_ptr(), update_grid, stream)
        if err:
            raise RuntimeError(f"adamw_update launch failed: cudaError "
                               f"{err}")
        adamw_cuda.count({"route": "update"})
    adamw_step.count({"route": "fused"})
    for k in stand_ins:
        params[k].copy_(master[k])
    return stats[0], stats[1]


adamw_cuda.uploads = 0


@RouteCounted.over("fused", "plain")
def adamw_step(cfg, params, grads, m, v, master, lr, b1c, b2c,
               compress=None, err=None):
    """One AdamW step over every leaf on the route :func:`adamw_route`
    names, in place.  Returns (grad_norm, route)."""
    route = adamw_route(cfg, params, grads, m, v, master)
    if route == "fused":
        gnorm, _ = adamw_cuda(cfg, params, grads, m, v, master, lr, b1c,
                              b2c)
    else:
        gnorm, _ = adamw_plain(cfg, params, grads, m, v, master, lr, b1c,
                               b2c, compress, err)
        adamw_step.count({"route": route})
    return gnorm, route
