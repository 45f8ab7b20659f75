"""Shared model components: norms, initializers, RoPE and M-RoPE,
sinusoidal positions, and the sharding helpers.

Sharding is expressed through :func:`shard`, which pins an activation
(and its gradient) to DTensor placements on the ambient mesh set by the
launcher (:func:`set_mesh`, :func:`mesh_context`); without a mesh it is a
no-op, so single-card runs and the CPU tests need no mesh plumbing, and
every path runs as it does on one card.  A mesh is a ``torch.distributed``
``DeviceMesh`` with the reference's axis names (``pod``, ``data``,
``model``), or for planning without a process group an
:class:`AbstractMesh`.  Specs are the reference's: per tensor dim an axis
name, a tuple of axis names or None, degraded until the dim divides
(:func:`spec`); :func:`placements` turns one into DTensor placements.
Work that is independent along the split dims (attention, the
recurrences' time loops, MoE routing, the embedding lookup) runs on each
rank's local shard (:func:`on_shards`, :func:`embedding`), so no kernel
and no indexing op sees a DTensor.  :func:`scan` and :func:`repeat` are
the loops a cost count may run once and scale (``launch.hlo_cost``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

class _Ambient:
    """The launcher's mesh, the decode layout and the loop hook.  Process
    wide, not per thread as the reference's: the autograd engine runs a
    checkpointed block's recompute on its own device thread, and that
    recompute must pin the same layouts as the forward pass did."""
    mesh = None
    decode = False
    loop_hook = None
    sharded_depth = 0
    ops_registered = False


_AMBIENT = _Ambient()

# Canonical logical axes, as in the reference:
#   batch  -> ("pod", "data")     sequence -> None (or "model" for long KV)
#   model-parallel (heads / ffn / vocab / experts) -> "model"
#   fsdp (param second axis) -> "data"
BATCH = ("pod", "data")
MODEL = "model"
FSDP = "data"


# ---------------------------------------------------------------------------
# Meshes and specs.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names with no devices behind it: enough
    for the sharding rules, the shard shapes and the placements, so a
    plan for 256 or 512 devices can be read on one host."""
    shape: tuple
    axis_names: tuple

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def axis_sizes(mesh) -> dict:
    """{axis name: size}, in the mesh's order, of a ``DeviceMesh`` or an
    :class:`AbstractMesh`."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    return dict(zip(names, tuple(mesh.shape)))


def set_mesh(mesh) -> None:
    _AMBIENT.mesh = mesh


def get_mesh():
    return _AMBIENT.mesh


@contextlib.contextmanager
def mesh_context(mesh):
    old = get_mesh()
    set_mesh(mesh)
    try:
        yield
    finally:
        set_mesh(old)


def set_decode_layout(flag: bool) -> None:
    """Serving layout (the reference's §Perf H2'): single-token
    activations are tiny (B,1,d); replicating them over the data axis
    lets every product against 2D-sharded weights run as a local partial
    contraction plus a small all-reduce, instead of re-gathering the
    weight shards per layer per token.  Cache tensors keep their own
    explicit shardings."""
    _AMBIENT.decode = flag


def in_decode_layout() -> bool:
    return _AMBIENT.decode


@contextlib.contextmanager
def decode_layout():
    old = in_decode_layout()
    set_decode_layout(True)
    try:
        yield
    finally:
        set_decode_layout(old)


def _filter_axes(mesh, axes, dim_size=None):
    """Drop axes not in the mesh; if ``dim_size`` is given, greedily drop
    trailing axes until the dimension divides evenly (auto-degradation
    keeps every (arch x shape) cell shardable: batch=1 long-context, odd
    vocabs like whisper's 51866, etc.)."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    present = [a for a in axes if a in sizes]
    if dim_size is not None:
        while present and dim_size % math.prod(sizes[a] for a in present):
            present.pop()
    if not present:
        return None
    return tuple(present) if len(present) > 1 else present[0]


def spec(mesh, *dims, shape=None) -> tuple:
    """The reference's PartitionSpec as a tuple: per tensor dim an axis
    name, a tuple of names, or None."""
    if shape is None:
        return tuple(_filter_axes(mesh, d) for d in dims)
    return tuple(_filter_axes(mesh, d, s) for d, s in zip(dims, shape))


def _spec_placements(mesh, spec_: tuple) -> tuple:
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for dim, axes in enumerate(spec_):
        if axes is None:
            continue
        idx = [names.index(a) for a in
               ((axes,) if isinstance(axes, str) else axes)]
        if idx != sorted(idx):
            raise ValueError(
                f"dim {dim} is split over {axes}, not in the mesh's order "
                f"{tuple(names)}: DTensor splits a dim over mesh dims "
                "major first, in the mesh's order")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``
    (a spec shorter than the tensor's rank leaves its last dims whole).
    ``placements`` are its DTensor placements (one per mesh dim); a dim
    on ``("pod", "data")`` is ``Shard(d)`` on both mesh dims, major
    first, which is JAX's row-major order."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return _spec_placements(self.mesh, self.spec)

    def shard_shape(self, shape) -> tuple:
        """Each device's shard of a tensor of ``shape``; raises, as JAX's
        does, where a dim does not divide."""
        sizes = axis_sizes(self.mesh)
        spec_ = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        out = []
        for dim, (n, axes) in enumerate(zip(shape, spec_)):
            k = 1 if axes is None else math.prod(
                sizes[a] for a in ((axes,) if isinstance(axes, str)
                                   else axes))
            if n % k:
                raise ValueError(f"dim {dim} of size {n} does not divide "
                                 f"over {axes} ({k})")
            out.append(n // k)
        return tuple(out)


def named_sharding(mesh, shape, *dims) -> NamedSharding:
    """NamedSharding with the divisibility-aware degradation."""
    return NamedSharding(mesh, spec(mesh, *dims, shape=shape))


def placements(mesh, shape, *dims) -> tuple:
    """The DTensor placements of ``spec(mesh, *dims, shape=shape)``."""
    return named_sharding(mesh, shape, *dims).placements


@contextlib.contextmanager
def sharded():
    """Inside the model's entry points under a mesh: plain tensors (the
    masks, positions and constants a step builds) take part in DTensor
    ops as replicated.  Re-entrant; a no-op without a mesh."""
    depth = _AMBIENT.sharded_depth
    if get_mesh() is None or depth:
        _AMBIENT.sharded_depth = depth + 1
        try:
            yield
        finally:
            _AMBIENT.sharded_depth = depth
        return
    from torch.distributed.tensor.experimental import implicit_replication
    _register_dtensor_ops()
    _AMBIENT.sharded_depth = 1
    try:
        with implicit_replication():
            yield
    finally:
        _AMBIENT.sharded_depth = 0


def _register_dtensor_ops() -> None:
    """Sharding strategies DTensor lacks for ops the models run: the
    backward of ``log_sigmoid`` (the RG-LRU's gate), pointwise.  Its
    buffer has x's shape on the CPU and is empty on CUDA."""
    if _AMBIENT.ops_registered:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.log_sigmoid_backward.default)
    def _log_sigmoid_backward(grad_output, x, buffer):
        out = [([Replicate()], [Replicate(), Replicate(), Replicate()])]
        for d in range(len(x.shape)):
            buf = Shard(d) if math.prod(buffer.shape) else Replicate()
            out.append(([Shard(d)], [Shard(d), Shard(d), buf]))
        return out

    _AMBIENT.ops_registered = True


def is_dtensor(x) -> bool:
    if type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def as_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh``: a plain tensor is taken as
    replicated (every rank holds the same value)."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class _Pin(torch.autograd.Function):
    """Redistribute to ``target`` in the forward pass and the gradient to
    the same placements in the backward pass: the reference's
    bidirectional ``custom_vjp`` constraint (its §Perf H4), which anchors
    the backward graph's layouts to the forward's."""

    @staticmethod
    def forward(ctx, x, target):
        ctx.target = target
        if tuple(x.placements) != target:
            x = x.redistribute(placements=target)
        # A redistribute's local result is contiguous while the DTensor
        # keeps its input's global strides; where those are permuted (an
        # einsum's output), a later reshape would view the local shard
        # by them and fail.  contiguous() realigns the two (a no-op when
        # the strides are already contiguous).
        out = x.contiguous()
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.target:
            g = g.redistribute(placements=ctx.target)
        return g.contiguous(), None


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: ``local_map`` wraps a
    local gradient as a DTensor with contiguous strides whatever the
    local tensor's are, so a strided one would break a later view."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def on_shards(fn, out_placements, args, arg_placements):
    """``fn`` on each rank's local shards of the DTensors ``args``
    (redistributed to ``arg_placements`` first), its outputs wrapped with
    ``out_placements`` (a list for one output, a tuple of lists for
    several): ``local_map`` for work that is independent along the split
    dims (attention per row and head, a recurrence per row and channel,
    MoE routing per row).  Every op of ``fn`` runs on plain tensors.  An
    output that is a partial sum over a split must be given as
    ``Partial()`` there."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    def local(*shards):
        return fn(*(_ContiguousGrad.apply(t) if t.is_floating_point()
                    else t for t in shards))
    # An input whole over a mesh dim the work is split along is used by
    # every rank's part: its gradient is a partial sum there.
    split = {m for pls in arg_placements for m, pl in enumerate(pls)
             if isinstance(pl, Shard)}
    grads = tuple([pl if isinstance(pl, Shard) or m not in split
                   else Partial() for m, pl in enumerate(pls)]
                  for pls in arg_placements)
    return local_map(local, out_placements=out_placements,
                     in_placements=tuple(arg_placements),
                     in_grad_placements=grads,
                     device_mesh=args[0].device_mesh,
                     redistribute_inputs=True)(*args)


def split_placements(x, keep: dict):
    """Per mesh dim, x's ``Shard(d)`` if ``keep`` maps d to the dim it
    takes in the target (``keep[d]``), else ``Replicate``: the placements
    of a tensor laid out like x along the kept dims."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for pl in x.placements:
        d = pl.dim if isinstance(pl, Shard) else None
        out.append(Shard(keep[d]) if d in keep else Replicate())
    return out


def replicate_axis(x, axis: str):
    """``x`` (a DTensor) with mesh axis ``axis`` replicated, partial sums
    on it reduced, the other axes as they were; its gradient pinned
    likewise.  A plain tensor, or a mesh without the axis, as is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    names = list(axis_sizes(x.device_mesh))
    if axis not in names:
        return x
    target = list(x.placements)
    target[names.index(axis)] = Replicate()
    return _Pin.apply(x, tuple(target))


def split_heads(x, heads: int, head_dim: int):
    """(B, S, H*D) -> (B, S, H, D).  Under a mesh whose model axis does
    not divide H, the feature dim's model split cannot survive the
    reshape, so it is gathered first (as XLA's partitioner must)."""
    mesh = get_mesh()
    if mesh is not None and heads % axis_sizes(mesh).get(MODEL, 1):
        x = replicate_axis(x, MODEL)
    return x.reshape(x.shape[0], x.shape[1], heads, head_dim)


class _VocabEmbedding(torch.autograd.Function):
    """The embedding lookup of a DTensor table split by vocabulary rows
    over one mesh dim (else whole), shard by shard: each rank looks up
    the tokens its rows hold and zeros the rest, a partial sum over that
    mesh dim; the backward adds each rank's rows' gradients locally.  All
    indexing runs on local tensors."""

    @staticmethod
    def forward(ctx, weight, tokens, vocab_dim):
        from torch.distributed.tensor import DTensor, Partial, Replicate, \
            Shard
        mesh = weight.device_mesh
        w = weight.to_local()
        rows = w.shape[0]
        off = 0 if vocab_dim is None else mesh.get_local_rank(
            mesh_dim=vocab_dim) * rows
        idx = tokens.to_local().long() - off
        hit = (idx >= 0) & (idx < rows)
        idx = idx.clamp(0, rows - 1)
        out = w[idx] * hit[..., None].to(w.dtype)
        batch = [pl if pl == Shard(0) else Replicate()
                 for pl in tokens.placements]
        out_pl = list(batch)
        if vocab_dim is not None:
            out_pl[vocab_dim] = Partial()
        ctx.save_for_backward(idx, hit)
        ctx.meta = (mesh, batch, weight.placements, w.shape[1], rows)
        return DTensor.from_local(out, mesh, out_pl, run_check=False)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Shard
        idx, hit = ctx.saved_tensors
        mesh, batch, w_pl, width, rows = ctx.meta
        g = g.redistribute(mesh, batch).to_local()
        gw = g.new_zeros((rows, width))
        gw.index_put_((idx,), g * hit[..., None].to(g.dtype),
                      accumulate=True)
        # rows of other batch shards add up over their mesh dims
        gw_pl = [Partial() if b == Shard(0) else w
                 for b, w in zip(batch, w_pl)]
        return (DTensor.from_local(gw, mesh, gw_pl, run_check=False),
                None, None)


def embedding(weight, tokens):
    """``weight[tokens]``; for a DTensor table, shard by shard: the
    table's fsdp split gathered, its vocab split kept (one mesh dim at
    most), each token looked up where its row lives."""
    if not is_dtensor(weight):
        return weight[tokens]
    from torch.distributed.tensor import Replicate, Shard
    tokens = as_dtensor(tokens, weight.device_mesh)
    target, vocab_dim = [], None
    for i, pl in enumerate(weight.placements):
        keep = (pl == Shard(0) and vocab_dim is None
                and tokens.placements[i] != Shard(0))
        vocab_dim = i if keep else vocab_dim
        target.append(pl if keep else Replicate())
    if tuple(target) != tuple(weight.placements):
        weight = _Pin.apply(weight, tuple(target))
    return _VocabEmbedding.apply(
        weight, as_dtensor(tokens, weight.device_mesh), vocab_dim)


def merge_heads(x):
    """(B, S, H, D) -> (B, S, H*D), and under a mesh whose model axis does
    not divide H the result pinned replicated over it, so the gradient
    reaching the reshape can be split back into H heads."""
    b, s, heads, head_dim = x.shape
    y = x.reshape(b, s, heads * head_dim)
    mesh = get_mesh()
    if mesh is not None and heads % axis_sizes(mesh).get(MODEL, 1):
        y = replicate_axis(y, MODEL)
    return y


def shard(x, *dims):
    """Pin ``x``'s placements (and its gradient's); dims are per-dimension
    axis (tuples) or None.  Axes absent from the ambient mesh are dropped
    and axes that do not divide the dimension are degraded; no mesh =>
    no-op."""
    mesh = get_mesh()
    if mesh is None:
        return x
    if len(dims) != x.ndim:
        raise ValueError(f"shard: {len(dims)} specs for rank-{x.ndim}")
    if (in_decode_layout() and x.ndim == 3 and x.shape[1] == 1
            and dims[0] == BATCH):
        # (B,1,d) activations: batch replicated; residual-stream d sharded
        # over the fsdp axis so products against (d->data, f->model)
        # weights contract locally and emit small partial-sum all-reduces
        # instead of per-layer weight all-gathers.
        last = FSDP if dims[-1] is None else dims[-1]
        dims = (None,) + tuple(dims[1:-1]) + (last,)
    return _Pin.apply(as_dtensor(x, mesh),
                      placements(mesh, x.shape, *dims))


# ---------------------------------------------------------------------------
# Recurrences: the time loop, which a cost count may run once and scale.
# ---------------------------------------------------------------------------


def set_loop_hook(hook) -> None:
    """``hook(n, body)`` -> ``body()``, or None.  With a hook set,
    :func:`scan` and :func:`repeat` hand it one step of an n-step loop,
    and the hook counts that step n times (``launch.hlo_cost``)."""
    _AMBIENT.loop_hook = hook


def repeat(fn, n: int) -> None:
    """``fn(i)`` for i in 0..n-1, for its effects (a microbatch loop).
    Under a loop hook, ``fn(0)`` alone, counted n times."""
    hook = _AMBIENT.loop_hook
    if hook is None or n < 2:
        for i in range(n):
            fn(i)
        return
    hook(n, lambda: fn(0))


def scan(fn, carry, n: int, dim: int = 1):
    """``carry, y_t = fn(carry, t)`` for t in 0..n-1; returns (carry, the
    y_t stacked along ``dim``).  Under a loop hook it runs step 0 alone
    and stacks its y with n - 1 detached copies (one ``cat`` of y and an
    expanded view: the bytes of the loop's ``stack``, and a backward
    pass that reaches the step once): the shapes and the per-step work
    are the loop's, the values are not."""
    hook = _AMBIENT.loop_hook
    if hook is None or n < 2:
        ys = []
        for t in range(n):
            carry, y = fn(carry, t)
            ys.append(y)
        return carry, torch.stack(ys, dim=dim)
    carry, y = hook(n, lambda: fn(carry, 0))
    y = y.unsqueeze(dim)
    rest = list(y.shape)
    rest[dim] = n - 1
    return carry, torch.cat([y, y.detach().expand(rest)], dim=dim)


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale`` + ``bias``) parameters,
    kept in float32 whatever the model's dtype, as in the reference."""

    def __init__(self, d: int, kind: str = "rms", device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.kind = kind
        self.scale = nn.Parameter(torch.ones(d, dtype=torch.float32,
                                             device=dev))
        if kind == "layernorm":
            self.bias = nn.Parameter(torch.zeros(d, dtype=torch.float32,
                                                 device=dev))


def rmsnorm(p, x, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p.scale
    return out.to(x.dtype)


def layernorm(p, x, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * p.scale + p.bias
    return out.to(x.dtype)


def apply_norm(p: Norm, x, eps: float):
    return layernorm(p, x, eps) if p.kind == "layernorm" \
        else rmsnorm(p, x, eps)


# ---------------------------------------------------------------------------
# Initializers: the reference's distributions, drawn from an explicit
# generator on the tensor's device.
# ---------------------------------------------------------------------------


def dense_init_(w: torch.Tensor, gen: torch.Generator, fan_in=None):
    """Fill ``w`` with N(0, 1/fan_in) (fan_in defaults to ``w.shape[0]``)."""
    fan_in = fan_in or w.shape[0]
    z = torch.randn(w.shape, generator=gen, device=w.device)
    w.copy_(z / math.sqrt(fan_in))
    return w


def embed_init_(w: torch.Tensor, gen: torch.Generator):
    """Fill ``w`` (vocab, d) with N(0, 0.02^2)."""
    z = torch.randn(w.shape, generator=gen, device=w.device)
    w.copy_(z * 0.02)
    return w


# ---------------------------------------------------------------------------
# RoPE: split-half rotation (x1 = first half of D, x2 = second half).
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 1e4):
    """x: (B, S, H, D); positions: (B, S) integer."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    ang = positions[..., None].float() * freqs             # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


MROPE_FRACS = (0.25, 0.375, 0.375)        # temporal / height / width sections


def apply_mrope(x, positions3, theta: float = 1e4):
    """Qwen2-VL multimodal RoPE. x: (B,S,H,D); positions3: (3,B,S).  The
    rotation's D/2 frequencies are split into temporal, height and width
    sections, each turned by its own row of ``positions3``."""
    d = x.shape[-1]
    half = d // 2
    sec = [int(half * f) for f in MROPE_FRACS]
    sec[-1] = half - sec[0] - sec[1]
    freqs = rope_freqs(d, theta, x.device)                 # (half,)
    parts, start = [], 0
    for i, n in enumerate(sec):
        parts.append(positions3[i][..., None].float()
                     * freqs[start:start + n])             # (B,S,n)
        start += n
    ang = torch.cat(parts, -1)[:, :, None, :]              # (B,S,1,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Sinusoidal positions (Whisper).
# ---------------------------------------------------------------------------


def sinusoidal_positions(seq: int, d: int) -> torch.Tensor:
    """The (seq, d) table of positions 0..seq-1, computed in float64 and
    returned as float32."""
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    out = np.concatenate([np.sin(ang), np.cos(ang)], -1)
    return torch.from_numpy(out).float()


def sinusoid_at(positions, d: int):
    """Sinusoidal embeddings for integer positions (B,S) -> (B,S,d) f32,
    computed in float32 as the model's embedding adds them."""
    i = torch.arange(d // 2, dtype=torch.float32, device=positions.device)
    inv = torch.pow(10000.0, -2.0 * i / d)
    ang = positions[..., None].float() * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)
