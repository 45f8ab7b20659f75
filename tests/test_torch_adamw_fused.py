"""The optimizer's fused multi-tensor AdamW (``repro_torch.kernels.adamw``).

On the CPU: the route each kind of leaf takes (CPU, ``meta``, DTensor,
``compress_grads``, stand-in parameters: all plain, no kernel built or
launched), the kernels' work table over leaves of uneven sizes, dtypes
and alignments, walked as the kernels walk it (leaves no head aligns
refused), which shards of a sharded step count in the norm (two gloo
ranks), and ``apply_updates`` bitwise as it was before the kernels.

On the card (marker ``card``; they skip without one): the kernels
against the plain twin, bitwise given the same clip scale, over bf16 and
f32 parameters and gradients, clipping on and off, steps 1 and 101;
``grad_norm`` within 1e-6 relative; reruns bit for bit; two launches and
one copy a step; stand-in parameters and DTensor leaves (a one-rank NCCL
mesh) through the kernels; ``compress_grads`` refused.  Run them there
with ``python -m pytest -q -p no:cacheprovider --noconftest -m card
tests/test_torch_adamw_fused.py`` (``--noconftest``: the tests'
conftest imports the JAX package, which that machine lacks).  This file
imports no JAX.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import adamw as fused  # noqa: E402
from repro_torch.optim import OptConfig, adamw  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GROUP = fused.TILE["group"]
ITEM = fused.TILE["item_elems"]
F32, BF16 = torch.float32, torch.bfloat16
SIZES = (1, 7, 4097, 3072 * 3072 + 5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the fused AdamW kernels run on the card")
    return torch.device("cuda")


@pytest.fixture
def no_build(monkeypatch):
    """Fail any attempt to build or load a kernel library."""
    def refuse(name):
        raise AssertionError(f"kernel library {name!r} loaded")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)


def _leaves(shapes, pdtype=BF16, gdtype=BF16, device="cpu", seed=0,
            grad_scale=1e-2):
    """Parameters, gradients and an optimizer state over ``shapes``: the
    masters and moments seeded, the parameters cast from the masters."""
    gen = torch.Generator().manual_seed(seed)
    params, grads = {}, {}
    for i, shape in enumerate(shapes):
        w = torch.randn(shape, generator=gen) * 0.1
        params[f"w{i}"] = torch.nn.Parameter(w.to(pdtype).to(device),
                                             requires_grad=False)
        grads[f"w{i}"] = (torch.randn(shape, generator=gen)
                          * grad_scale).to(gdtype).to(device)
    state = adamw.init_state(params)
    for k in params:
        shape = params[k].shape
        state["m"][k].copy_(torch.randn(shape, generator=gen) * 1e-3)
        state["v"][k].copy_(torch.rand(shape, generator=gen) * 1e-6)
    return params, grads, state


# ---------------------------------------------------------------------------
# The route (CPU)
# ---------------------------------------------------------------------------


class _StandIn:
    """A parameter that only takes ``copy_`` (as the benchmark's
    "unwritten" fault control passes)."""

    def copy_(self, _):
        return self


@pytest.mark.parametrize("kind", ["cpu", "meta", "compress", "stand_in"])
def test_route_is_plain_off_the_card(kind, no_build):
    device = "meta" if kind == "meta" else "cpu"
    params, grads, state = _leaves([(4, 8), (3,)], device=device)
    cfg = OptConfig(compress_grads=kind == "compress")
    err = adamw.init_error_feedback(params) if kind == "compress" else None
    if kind == "stand_in":
        params = {k: _StandIn() for k in params}
    before = fused.adamw_step.by_route()
    adamw.apply_updates(cfg, state, params, grads, err)
    after = fused.adamw_step.by_route()
    assert after["fused"] == before["fused"]
    assert after["plain"] == before["plain"] + 1
    assert fused.adamw_route(cfg, params, grads, state["m"], state["v"],
                             state["master"]) == "plain"


_DTENSOR_WORKER = textwrap.dedent(r"""
    import json, os, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    dist.init_process_group("gloo", init_method="file://" + sys.argv[1],
                            rank=0, world_size=1)
    from repro_torch.kernels import _build, adamw as fused
    from repro_torch.optim import OptConfig, adamw

    def refuse(*a, **kw):
        raise AssertionError("a kernel library was loaded")
    _build.load = _build.build_all = refuse
    mesh = init_device_mesh("cpu", (1,))
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.nn.Parameter(distribute_tensor(
        torch.randn(8, 4, generator=gen), mesh, [Shard(0)]))}
    grads = {"w": distribute_tensor(torch.randn(8, 4, generator=gen), mesh,
                                    [Shard(0)])}
    state = adamw.init_state(params)
    route = fused.adamw_route(OptConfig(), params, grads, state["m"],
                              state["v"], state["master"])
    _, state, _, stats = adamw.apply_updates(OptConfig(), state, params,
                                             grads)
    print(json.dumps(dict(route=route, counts=fused.adamw_step.by_route(),
                          grad_norm=float(stats["grad_norm"]))))
    dist.destroy_process_group()
""")


def test_route_is_plain_for_dtensor_leaves(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", _DTENSOR_WORKER, str(tmp_path / "store")],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["route"] == "plain"
    assert got["counts"] == {"fused": 0, "plain": 1}
    gen = torch.Generator().manual_seed(0)
    torch.randn(8, 4, generator=gen)
    want = float(torch.linalg.vector_norm(torch.randn(8, 4, generator=gen)))
    assert got["grad_norm"] == pytest.approx(want, rel=1e-6)


PLACEMENTS = {
    "shard_replicate": ("S0R", (1, 0), True),
    "replicated_off_first": ("S0R", (0, 1), False),
    "replicated_first": ("RR", (0, 0), True),
    "replicated_second": ("RR", (1, 0), False),
    "sharded": ("S0S1", (1, 1), True),
}


@pytest.mark.parametrize("case", list(PLACEMENTS))
def test_replicated_shards_count_in_one_norm(case):
    from torch.distributed.tensor import Replicate, Shard
    kinds = {"S0R": (Shard(0), Replicate()), "RR": (Replicate(),) * 2,
             "S0S1": (Shard(0), Shard(1))}
    placements, coordinate, want = PLACEMENTS[case]
    assert fused.counts_in_norm(kinds[placements], coordinate) is want


def test_partial_leaves_are_refused():
    from torch.distributed.tensor import Partial, Shard
    with pytest.raises(ValueError, match="adamw"):
        fused.counts_in_norm((Shard(0), Partial()), (0, 0))


_MESH_WORKER = textwrap.dedent(r"""
    import json, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    rank = int(sys.argv[2])
    dist.init_process_group("gloo", init_method="file://" + sys.argv[1],
                            rank=rank, world_size=4)
    from repro_torch.kernels import adamw as fused
    from repro_torch.optim import adamw

    mesh = init_device_mesh("cpu", (2, 2))
    layouts = {"a": ((8, 4), (Shard(0), Replicate())),
               "b": ((4, 6), (Replicate(), Shard(1))),
               "c": ((5,), (Replicate(), Replicate())),
               "d": ((8, 6), (Shard(0), Shard(1)))}
    gen = torch.Generator().manual_seed(0)
    params, grads = {}, {}
    for k, (shape, pl) in layouts.items():
        params[k] = torch.nn.Parameter(distribute_tensor(
            torch.randn(shape, generator=gen), mesh, pl))
        grads[k] = distribute_tensor(torch.randn(shape, generator=gen), mesh,
                                     pl)
    state = adamw.init_state(params)
    leaves, got_mesh, stand_ins = fused._table_leaves(
        params, grads, state["m"], state["v"], state["master"])
    partial = torch.zeros((), dtype=torch.float64)
    in_norm = {}
    for k, (_, _, n, flags) in zip(layouts, leaves):
        in_norm[k] = not flags & fused.NO_NORM
        if in_norm[k]:
            partial += grads[k].to_local().double().square().sum()
    for dim in range(mesh.ndim):
        dist.all_reduce(partial, group=mesh.get_group(dim))
    whole = sum(float(g.full_tensor().double().square().sum())
                for g in grads.values())
    print(json.dumps(dict(rank=rank, mesh=got_mesh is mesh,
                          stand_ins=stand_ins, in_norm=in_norm,
                          sum=float(partial), whole=whole)))
    dist.destroy_process_group()
""")


def test_sharded_norm_counts_every_element_once(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MESH_WORKER, str(tmp_path / "store"),
         str(rank)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=ROOT, env=env) for rank in range(4)]
    outs = [proc.communicate(timeout=300) for proc in procs]
    assert all(proc.returncode == 0 for proc in procs), [e for _, e in outs]
    got = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    for g in got:
        assert g["mesh"] and g["stand_ins"] == []
        assert g["sum"] == pytest.approx(g["whole"], rel=1e-12)
    # coordinates (0, 0), (0, 1), (1, 0), (1, 1): a leaf replicated over
    # a mesh dimension counts on that dimension's first rank only
    assert [g["in_norm"] for g in got] == [
        {"a": True, "b": True, "c": True, "d": True},
        {"a": False, "b": True, "c": False, "d": True},
        {"a": True, "b": False, "c": False, "d": True},
        {"a": False, "b": False, "c": False, "d": True}]


def test_nothing_is_built_at_import():
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
            "from repro_torch.kernels import _build, adamw\n"
            "import repro_torch.optim.adamw\n"
            "assert not _build._LOADED\n"
            "assert adamw._library.cache_info().currsize == 0\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# The work table (CPU), walked as csrc/adamw.cu walks it
# ---------------------------------------------------------------------------


def _walk(rows, nrows, nitems):
    """Each leaf's covered element ranges, as the kernels' CTAs visit
    them: every item's leaf found by walking the table forward, its
    chunk's groups, the head on the first chunk and the tail on the
    last; and every vector group's first element."""
    entry = len(fused.FIELDS)
    table = [dict(zip(fused.FIELDS, rows[i * entry:(i + 1) * entry]))
             for i in range(nrows)]
    covered = [[] for _ in table]
    vec_starts = [[] for _ in table]
    leaf = 0
    for item in range(nitems):
        while leaf + 1 < nrows and table[leaf + 1]["item_begin"] <= item:
            leaf += 1
        t = table[leaf]
        c = item - t["item_begin"]
        assert 0 <= c < t["items"]
        per = ITEM // GROUP
        g0, g1 = c * per, min(c * per + per, t["groups"])
        if g1 > g0:
            covered[leaf].append((t["head"] + g0 * GROUP,
                                  t["head"] + g1 * GROUP))
            vec_starts[leaf] += [t["head"] + g0 * GROUP,
                                 t["head"] + (g1 - 1) * GROUP]
        if c == 0 and t["head"]:
            covered[leaf].append((0, t["head"]))
        tail = t["head"] + t["groups"] * GROUP
        if c == t["items"] - 1 and tail < t["n"]:
            assert t["n"] - tail < GROUP
            covered[leaf].append((tail, t["n"]))
    return table, covered, vec_starts


def _ptrs(base, offsets, elts):
    """Five 256-byte-aligned bases moved by ``offsets`` elements."""
    return tuple(base + i * (1 << 32) + o * e
                 for i, (o, e) in enumerate(zip(offsets, elts)))


# offsets (elements) of the parameter, gradient, m, v and master
ALIGNMENTS = {"aligned": (0,) * 5, "head": (3,) * 5}
DTYPES = [(BF16, BF16), (F32, F32), (F32, BF16)]


def _elts(pdtype, gdtype):
    return (torch.finfo(pdtype).bits // 8, torch.finfo(gdtype).bits // 8,
            4, 4, 4)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("pdtype, gdtype", DTYPES)
@pytest.mark.parametrize("align", list(ALIGNMENTS))
def test_work_table_covers_each_leaf_once(n, pdtype, gdtype, align):
    elts = _elts(pdtype, gdtype)
    offsets = ALIGNMENTS[align]
    ptrs = _ptrs(1 << 40, offsets, elts)
    flags = (pdtype == BF16) | (gdtype == BF16) << 1
    # the leaf between two others, so the walk crosses into and out of it
    leaves = [(_ptrs(1 << 44, (0,) * 5, elts), elts, 5000, flags),
              (ptrs, elts, n, flags),
              (_ptrs(1 << 45, (0,) * 5, elts), elts, 3 * ITEM + 9, flags)]
    rows, nrows, nitems = fused.work_table(leaves)
    assert nrows == 3 and len(rows) == 3 * len(fused.FIELDS)
    table, covered, vec_starts = _walk(rows, nrows, nitems)
    for t, spans, (_, _, size, _) in zip(table, covered, leaves):
        assert t["n"] == size and t["flags"] == flags
        spans.sort()
        assert spans[0][0] == 0 and spans[-1][1] == size
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    mid = table[1]
    assert [t["item_begin"] for t in table] == [
        0, table[0]["items"], table[0]["items"] + mid["items"]]
    assert nitems == sum(t["items"] for t in table)
    want_head = min(n, 0 if align == "aligned" else GROUP - offsets[0])
    if align == "head" and pdtype == F32 and gdtype == F32:
        want_head = min(n, 1)         # 4 f32 elements fill 16 bytes
    assert mid["head"] == want_head
    assert mid["groups"] == (n - want_head) // GROUP
    assert mid["items"] == max(1, -(-mid["groups"] // (ITEM // GROUP)))
    # every vector access sits on a 16-byte boundary in all five tensors
    for e in vec_starts[1]:
        assert all((p + e * s) % fused.VEC_BYTES == 0
                   for p, s in zip(ptrs, elts))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("pdtype, gdtype", DTYPES)
def test_work_table_refuses_leaves_no_head_aligns(n, pdtype, gdtype):
    # the parameter one element off the 16-byte grid, the rest on it
    elts = _elts(pdtype, gdtype)
    leaf = (_ptrs(1 << 40, (1, 0, 0, 0, 0), elts), elts, n, 0)
    with pytest.raises(ValueError, match="no head aligns"):
        fused.work_table([leaf])


def test_stand_in_parameter_gets_a_null_pointer():
    params, grads, state = _leaves([(4, 8)])
    ptrs, elts, n, flags = fused._cuda_leaf(
        "w0", _StandIn(), grads["w0"], state["m"]["w0"], state["v"]["w0"],
        state["master"]["w0"])
    assert ptrs[0] == 0 and elts[0] == 0 and n == 32
    assert flags == 2                   # bf16 gradient, f32 "parameter"
    # a null parameter never stands in the way of alignment: the rest
    # three elements off the grid take a head of 5, which a parameter on
    # the grid would refuse
    elts = (2, 2, 4, 4, 4)
    ptrs = _ptrs(1 << 40, (0, 3, 3, 3, 3), elts)
    with pytest.raises(ValueError, match="no head aligns"):
        fused.leaf_split(ptrs, elts, 100)
    assert fused.leaf_split((0,) + ptrs[1:], (0,) + elts[1:], 100) == (
        5, 95 // GROUP)


def test_work_table_skips_empty_leaves_and_may_be_empty():
    elts = (2, 2, 4, 4, 4)
    leaf = (_ptrs(1 << 40, (0,) * 5, elts), elts, 100, 3)
    empty = (_ptrs(1 << 41, (0,) * 5, elts), elts, 0, 3)
    rows, nrows, nitems = fused.work_table([empty, leaf, empty])
    assert nrows == 1 and nitems == 1
    assert dict(zip(fused.FIELDS, rows))["n"] == 100
    assert fused.work_table([]) == ([], 0, 0)


# ---------------------------------------------------------------------------
# apply_updates on the CPU, bitwise as it was before the kernels
# ---------------------------------------------------------------------------


def _as_before(cfg, state, params, grads, err=None):
    """``apply_updates`` as the port had it before the fused kernels
    (DTensor placement aside)."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                           for x in grads.values()))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    step = state["step"] + 1
    lr = adamw.schedule(cfg, step)
    b1c = 1 - torch.tensor(cfg.b1) ** step.to(torch.float32)
    b2c = 1 - torch.tensor(cfg.b2) ** step.to(torch.float32)
    for k, p in params.items():
        g = grads[k].to(torch.float32) * scale
        if cfg.compress_grads:
            g, err[k] = adamw._compress_one(g, err[k])
        m, v, master = state["m"][k], state["v"][k], state["master"][k]
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        upd += cfg.weight_decay * master
        master.sub_(lr * upd)
        p.copy_(master)
    state["step"] = step
    return gnorm, lr


def _clone(params, grads, state):
    return ({k: torch.nn.Parameter(p.detach().clone(), requires_grad=False)
             for k, p in params.items()},
            {k: g.clone() for k, g in grads.items()},
            {"step": state["step"].clone(),
             **{part: {k: t.clone() for k, t in state[part].items()}
                for part in ("m", "v", "master")}})


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("compress", [True, False])
def test_apply_updates_on_the_cpu_is_unchanged(clip, compress, no_build):
    cfg = OptConfig(compress_grads=compress, warmup_steps=2)
    params, grads, state = _leaves([(64, 48), (48,), (7,), (4097,)],
                                   grad_scale=1.0 if clip else 1e-3)
    assert (float(adamw.global_norm(grads)) > cfg.clip_norm) == clip
    old = _clone(params, grads, state)
    err = adamw.init_error_feedback(params) if compress else None
    old_err = adamw.init_error_feedback(params) if compress else None
    for _ in range(3):
        _, state, err, stats = adamw.apply_updates(cfg, state, params,
                                                   grads, err)
        gnorm, lr = _as_before(cfg, old[2], old[0], old[1], old_err)
        assert torch.equal(stats["grad_norm"], gnorm)
        assert torch.equal(stats["lr"], lr)
    assert torch.equal(state["step"], old[2]["step"])
    for k in params:
        assert torch.equal(params[k], old[0][k]), k
        for part in ("m", "v", "master"):
            assert torch.equal(state[part][k], old[2][part][k]), (part, k)
        if compress:
            assert torch.equal(err[k], old_err[k]), k


# ---------------------------------------------------------------------------
# The kernels on the card
# ---------------------------------------------------------------------------

CARD_SHAPES = [(1,), (7,), (4097,), (3072 * 3072 + 5,), (64, 96), (3072,)]


def _offset(t, k):
    """A copy of ``t`` that starts ``k`` elements into a larger buffer."""
    buf = torch.zeros(t.numel() + k, dtype=t.dtype, device=t.device)
    out = buf[k:].view(t.shape)
    out.copy_(t)
    return out


def _card_leaves(device, pdtype, gdtype, clip, seed=1):
    """Leaves on the card of uneven sizes, with gradients whose norm is
    above the clip (``clip``) or below it.  One of them, ``view_head``, is
    a view into larger buffers: all five tensors two elements in (a
    scalar head of 6, then vectors)."""
    params, grads, state = _leaves(CARD_SHAPES + [(4099,)], pdtype, gdtype,
                                   device, seed,
                                   grad_scale=1e-2 if clip else 1e-5)
    key = f"w{len(CARD_SHAPES)}"
    params["view_head"] = _offset(params.pop(key).detach(), 2)
    grads["view_head"] = _offset(grads.pop(key), 2)
    for part in ("m", "v", "master"):
        state[part]["view_head"] = _offset(state[part].pop(key), 2)
    return params, grads, state


def _fused_then_plain(cfg, params, grads, state, step, stand_ins=None):
    """One step through the kernels, and the plain twin's update of a copy
    of the same leaves given the kernels' scale.  Returns both sets of
    (params, state) and the kernels' (grad_norm, scale).  With
    ``stand_ins`` the kernels' step takes them for the parameters."""
    state["step"].fill_(step - 1)
    twin = _clone(params, grads, state)
    s = state["step"] + 1
    lr = adamw.schedule(cfg, s)
    b1c = 1 - torch.tensor(cfg.b1, device=s.device) ** s.to(torch.float32)
    b2c = 1 - torch.tensor(cfg.b2, device=s.device) ** s.to(torch.float32)
    if stand_ins is not None:
        params = stand_ins
    assert fused.adamw_route(cfg, params, grads, state["m"], state["v"],
                             state["master"]) == "fused"
    gnorm, scale = fused.adamw_cuda(cfg, params, grads, state["m"],
                                    state["v"], state["master"], lr, b1c,
                                    b2c)
    fused.update_plain(cfg, twin[0], twin[1], twin[2]["m"], twin[2]["v"],
                       twin[2]["master"], scale.clone(), lr, b1c, b2c)
    torch.cuda.synchronize()
    return (params, state), (twin[0], twin[2]), gnorm, scale


@pytest.mark.card
@pytest.mark.parametrize("step", [1, 101])
@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("gdtype", [BF16, F32])
@pytest.mark.parametrize("pdtype", [BF16, F32])
def test_kernels_equal_the_plain_twin_given_the_scale(card, pdtype, gdtype,
                                                      clip, step):
    cfg = OptConfig(warmup_steps=10)
    params, grads, state = _card_leaves(card, pdtype, gdtype, clip)
    (p1, s1), (p2, s2), gnorm, scale = _fused_then_plain(
        cfg, params, grads, state, step)
    want = float(adamw.global_norm(grads))
    assert abs(float(gnorm) - want) <= 1e-6 * want
    assert (float(scale) < 1.0) == clip
    assert torch.equal(scale, fused.clip_scale(gnorm, cfg.clip_norm))
    for k in p1:
        assert torch.equal(p1[k], p2[k]), ("param", k)
        for part in ("m", "v", "master"):
            assert torch.equal(s1[part][k], s2[part][k]), (part, k)


@pytest.mark.card
def test_kernels_rerun_bit_for_bit(card):
    cfg = OptConfig(warmup_steps=10)
    outs = []
    for _ in range(2):
        params, grads, state = _card_leaves(card, BF16, BF16, True)
        (p1, s1), _, gnorm, scale = _fused_then_plain(cfg, params, grads,
                                                      state, 5)
        outs.append((gnorm.clone(), scale.clone(), p1, s1))
    (g0, c0, pa, sa), (g1, c1, pb, sb) = outs
    assert torch.equal(g0, g1) and torch.equal(c0, c1)
    for k in pa:
        assert torch.equal(pa[k], pb[k])
        assert torch.equal(sa["master"][k], sb["master"][k])


def _zero_counts():
    fused.adamw_step.launches = 0
    fused.adamw_cuda.launches = 0
    fused.adamw_cuda.uploads = 0


def _counts():
    return dict(fused.adamw_step.by_route(), **fused.adamw_cuda.by_route(),
                uploads=fused.adamw_cuda.uploads)


@pytest.mark.card
def test_apply_updates_takes_the_kernels_on_the_card(card):
    params, grads, state = _leaves([(64, 48), (48,)], device=card)
    _zero_counts()
    for _ in range(3):
        adamw.apply_updates(OptConfig(), state, params, grads)
    # each step: two launches and the table's one copy
    assert _counts() == dict(fused=3, plain=0, norm=3, update=3, uploads=3)
    # compress_grads is refused on the card, before anything runs
    err = adamw.init_error_feedback(params)
    with pytest.raises(ValueError, match="compress_grads"):
        adamw.apply_updates(OptConfig(compress_grads=True), state, params,
                            grads, err)
    assert _counts() == dict(fused=3, plain=0, norm=3, update=3, uploads=3)


class _Recorder:
    """A stand-in parameter that keeps what it is given."""

    def copy_(self, x):
        self.got = x.clone()
        return self


@pytest.mark.card
def test_stand_in_parameters_take_the_kernels(card):
    cfg = OptConfig(warmup_steps=10)
    params, grads, state = _card_leaves(card, BF16, BF16, True)
    stand_ins = {k: _Recorder() for k in params}
    _zero_counts()
    _, (_, s2), _, _ = _fused_then_plain(cfg, params, grads, state, 3,
                                         stand_ins)
    assert _counts() == dict(fused=1, plain=0, norm=1, update=1, uploads=1)
    for k in params:
        for part in ("m", "v", "master"):
            assert torch.equal(state[part][k], s2[part][k]), (part, k)
        assert torch.equal(stand_ins[k].got, s2["master"][k]), k


_NCCL_WORKER = textwrap.dedent(r"""
    import json, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    dist.init_process_group("nccl", init_method="file://" + sys.argv[1],
                            rank=0, world_size=1)
    from repro_torch.kernels import adamw as fused
    from repro_torch.optim import OptConfig, adamw

    mesh = init_device_mesh("cuda", (1, 1))
    layouts = {"a": ((4096, 24), (Shard(0), Replicate())),
               "b": ((4099,), (Replicate(), Replicate())),
               "c": ((96, 256), (Shard(0), Shard(1)))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    plain, sharded = [], []
    for k, (shape, pl) in layouts.items():
        w = torch.randn(shape, generator=gen, device="cuda") * 0.1
        g = (torch.randn(shape, generator=gen, device="cuda")
             * 1e-2).to(torch.bfloat16)
        plain.append((k, w.to(torch.bfloat16), g))
        sharded.append((k, distribute_tensor(w.to(torch.bfloat16), mesh, pl),
                        distribute_tensor(g, mesh, pl)))
    out = {}
    for name, leaves in (("plain", plain), ("sharded", sharded)):
        params = {k: torch.nn.Parameter(w, requires_grad=False)
                  for k, w, _ in leaves}
        grads = {k: g for k, _, g in leaves}
        state = adamw.init_state(params)
        fused.adamw_step.launches = 0
        for _ in range(3):
            _, state, _, stats = adamw.apply_updates(OptConfig(), state,
                                                     params, grads)
        full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
        out[name] = dict(
            counts=fused.adamw_step.by_route(),
            grad_norm=float(stats["grad_norm"]),
            params={k: full(p).float().cpu() for k, p in params.items()},
            master={k: full(t).cpu() for k, t in state["master"].items()})
    p, s = out["plain"], out["sharded"]
    print(json.dumps(dict(
        counts=[p["counts"], s["counts"]],
        grad_norms=[p["grad_norm"], s["grad_norm"]],
        equal=all(torch.equal(p[part][k], s[part][k])
                  for part in ("params", "master") for k in layouts))))
    dist.destroy_process_group()
""")


@pytest.mark.card
def test_dtensor_leaves_take_the_kernels(card, tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", _NCCL_WORKER, str(tmp_path / "store")],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["counts"] == [{"fused": 3, "plain": 0}] * 2
    assert got["grad_norms"][0] == got["grad_norms"][1]
    assert got["equal"]


@pytest.mark.card
@pytest.mark.parametrize("fault", ["strided", "half", "two_devices",
                                   "unaligned"])
def test_leaves_the_kernels_do_not_take_raise(card, fault):
    params, grads, state = _leaves([(64, 48)], device=card)
    if fault == "strided":
        grads["w0"] = grads["w0"].t().contiguous().t()
    elif fault == "half":
        grads["w0"] = grads["w0"].to(torch.float16)
    elif fault == "two_devices":
        grads["w0"] = grads["w0"].cpu()
    else:                   # the parameter one element off the 16-byte grid
        params["w0"] = _offset(params["w0"].detach(), 1)
    with pytest.raises(ValueError, match="adamw"):
        adamw.apply_updates(OptConfig(), state, params, grads)
