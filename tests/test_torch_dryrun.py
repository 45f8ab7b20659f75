"""The dry-run plan: ``launch.hlo_cost``'s per-device, loop-aware counts,
``launch.dryrun``'s cells on a fake 2x2 mesh, ``launch.analytic`` and
the legacy dry-run roofline table, against the reference.

A fake process group is process-wide state, so every test that starts
one runs in a subprocess of its own.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import benchmarks.roofline as jroofline  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get as jget  # noqa: E402
from repro.launch import analytic as janalytic  # noqa: E402
from repro.launch import hlo_cost as jhlo_cost  # noqa: E402
from repro_torch.benchmarks import roofline  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get  # noqa: E402
from repro_torch.launch import analytic, hlo_cost  # noqa: E402
from repro_torch.models import Model, common  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V5E = {"H100_PEAK_FLOPS": 197e12, "H100_HBM_BW": 819e9,
       "H100_NVLINK_BW": 50e9}


def _run(code: str, timeout: int = 300) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


# ---------------------------------------------------------------------------
# hlo_cost: loops.
# ---------------------------------------------------------------------------


def _jax_scan_matmuls(n, m=256):
    def f(x, ws):
        def step(c, w):
            return c @ w, None
        return jax.lax.scan(step, x, ws)[0]
    x = jax.ShapeDtypeStruct((m, m), jnp.float32)
    ws = jax.ShapeDtypeStruct((n, m, m), jnp.float32)
    return jhlo_cost.analyze(jax.jit(f).lower(x, ws).compile().as_text())


def _jax_nested_scans():
    def f(x, ws):
        def outer(c, w):
            def inner(c2, _):
                return c2 @ w, None
            return jax.lax.scan(inner, c, jnp.arange(5))[0], None
        return jax.lax.scan(outer, x, ws)[0]
    x = jax.ShapeDtypeStruct((128, 128), jnp.float32)
    ws = jax.ShapeDtypeStruct((4, 128, 128), jnp.float32)
    return jhlo_cost.analyze(jax.jit(f).lower(x, ws).compile().as_text())


def test_loop_of_matmuls_counts_every_trip():
    x, w = torch.randn(256, 256), torch.randn(10, 256, 256)

    def loop():
        c = x
        for i in range(10):
            c = c @ w[i]
        return c
    got = hlo_cost.analyze(loop)
    assert got["dot_flops"] == 10 * 2 * 256 ** 3
    assert got["dot_flops"] == _jax_scan_matmuls(10)["dot_flops"]
    assert got["bytes_accessed"] > 0


def test_nested_scaled_scans_count_every_trip():
    """Outer 4 x inner 5 through ``common.scan``, each level run once and
    scaled by its trip count."""
    x, ws = torch.randn(128, 128), torch.randn(4, 128, 128)
    steps = []

    def nested():
        def outer(c, i):
            def inner(c2, _):
                steps.append(1)
                return c2 @ ws[i], c2[0]
            return common.scan(inner, c, 5, dim=0)[0], c[0]
        return common.scan(outer, x, 4, dim=0)
    got = hlo_cost.analyze(nested)
    assert len(steps) == 1                 # one step of each level ran
    assert got["dot_flops"] == 4 * 5 * 2 * 128 ** 3
    assert got["dot_flops"] == _jax_nested_scans()["dot_flops"]
    full = hlo_cost.analyze(nested, scale_loops=False)
    assert len(steps) == 1 + 20
    assert full["dot_flops"] == got["dot_flops"]


def _recurrent(arch):
    cfg = dataclasses.replace(get(arch).reduced(), dtype="float32")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 12),
                                     generator=gen),
             "positions": torch.arange(12).expand(2, 12)}
    return model, batch


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_scaled_recurrence_equals_the_full_loop(arch):
    """The time loop run once and scaled counts what the whole loop does:
    the same FLOPs forward and backward (with the per-layer recompute),
    and forward the same bytes."""
    model, batch = _recurrent(arch)

    def train():
        logits, _ = model.train_logits(batch)
        logits.float().square().mean().backward()

    def forward():
        with torch.no_grad():
            model.train_logits(batch)
    for fn in (train, forward):
        scaled = hlo_cost.analyze(fn)
        full = hlo_cost.analyze(fn, scale_loops=False)
        assert scaled["dot_flops"] == full["dot_flops"] > 0, fn.__name__
    scaled = hlo_cost.analyze(forward)
    full = hlo_cost.analyze(forward, scale_loops=False)
    assert scaled["bytes_accessed"] == full["bytes_accessed"]


@pytest.mark.parametrize("arch", ["qwen3-8b", "falcon-mamba-7b"])
def test_scaled_microbatches_equal_the_full_loop(arch):
    """A train step of two microbatches run once and scaled counts what
    both do (falcon-mamba: a scaled time loop inside a scaled
    microbatch)."""
    from repro_torch.optim import OptConfig, adamw
    from repro_torch.train.train_step import make_train_step
    model, batch = _recurrent(arch)
    batch = dict(batch, targets=batch["tokens"])
    step = make_train_step(model.cfg, OptConfig(), microbatches=2)
    opt = adamw.init_state(dict(model.named_parameters()))
    scaled = hlo_cost.analyze(step, model, opt, None, batch)
    full = hlo_cost.analyze(step, model, opt, None, batch,
                            scale_loops=False)
    assert scaled["dot_flops"] == full["dot_flops"] > 0


def test_scan_without_a_hook_is_the_plain_loop():
    """No counter, no scaling: ``common.scan`` is the torch loop the
    recurrences ran before (every step's value)."""
    h0 = torch.randn(3, 4)
    a = torch.rand(6, 3, 4)
    carry, ys = common.scan(lambda h, t: (h * a[t] + 1, h * a[t] + 1),
                            h0, 6)
    want, h = [], h0
    for t in range(6):
        h = h * a[t] + 1
        want.append(h)
    assert torch.equal(ys, torch.stack(want, 1)) and torch.equal(carry, h)


# ---------------------------------------------------------------------------
# hlo_cost: per device, on a fake world.
# ---------------------------------------------------------------------------


def test_counts_are_per_device_on_a_fake_world_of_4():
    out = _run("""
        import json, torch, torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=4)
        from torch.distributed.tensor import Replicate, Shard, \\
            distribute_tensor
        from torch.distributed.tensor.debug import CommDebugMode
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.launch import hlo_cost
        from repro_torch.launch.mesh import make_debug_mesh
        mesh = make_debug_mesh(2, 2)
        x = distribute_tensor(torch.randn(256, 512), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.randn(512, 256), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        def step():
            return (x @ w).redistribute(mesh, [Replicate(), Replicate()])
        with FlopCounterMode(display=False) as glob:
            step()
        with CommDebugMode() as comm:
            step()
        local = hlo_cost.analyze(step)
        print(json.dumps(dict(global_flops=glob.get_total_flops(),
                              comm=comm.get_total_counts(), **local)))
        dist.destroy_process_group()
    """)
    got = json.loads(out.strip().splitlines()[-1])
    assert got["global_flops"] == 2 * 256 * 512 * 256
    assert got["dot_flops"] == got["global_flops"] / 4
    assert got["collective_count"] == got["comm"] == 2
    # the (128, 64) f32 shard gathered over model, then over data
    assert got["all-gather"] == (128 * 256 + 256 * 256) * 4


def test_production_meshes_on_fake_worlds():
    """The reference's test_multipod_mesh_axes: (16, 16) ("data",
    "model") on 256 ranks, (2, 16, 16) with "pod" on 512."""
    out = _run("""
        import json
        from repro_torch.launch.dryrun import fake_world
        from repro_torch.launch.mesh import make_production_mesh
        got = {}
        for multi, n in ((False, 256), (True, 512)):
            with fake_world(n):
                m = make_production_mesh(multi_pod=multi, device_type="cpu")
                got[str(multi)] = [list(m.mesh_dim_names), list(m.shape)]
        print(json.dumps(got))
    """)
    got = json.loads(out.strip().splitlines()[-1])
    assert got["False"] == [["data", "model"], [16, 16]]
    assert got["True"] == [["pod", "data", "model"], [2, 16, 16]]


# ---------------------------------------------------------------------------
# dryrun: R2's two debug-mesh cells.
# ---------------------------------------------------------------------------


def test_debug_mesh_train_and_decode_cells_plan():
    """R2's contracts: the reduced qwen3-8b train cell (2 microbatches)
    and the reduced granite-8b decode cell plan on a fake 2x2 mesh."""
    out = _run("""
        import dataclasses, json
        import repro_torch.configs.registry as reg
        from repro_torch.configs import get
        from repro_torch.configs.registry import ShapeConfig
        from repro_torch.launch import dryrun
        reg.ARCHS["dbg"] = dataclasses.replace(get("qwen3-8b").reduced(),
                                               name="dbg")
        reg.ARCHS["dbg2"] = dataclasses.replace(
            get("granite-8b").reduced(), name="dbg2")
        train = dryrun.run_cell("dbg", ShapeConfig("t", 32, 4, "train"),
                                mesh_shape=(2, 2), microbatches=2,
                                verbose=False)
        decode = dryrun.run_cell("dbg2", ShapeConfig("d", 64, 4, "decode"),
                                 mesh_shape=(2, 2), verbose=False)
        import torch.distributed as dist
        print(json.dumps(dict(train=train, decode=decode,
                              group=dist.is_initialized())))
    """)
    got = json.loads(out.strip().splitlines()[-1])
    assert not got["group"]                  # the fake group is torn down
    for cell in (got["train"], got["decode"]):
        assert cell["status"] == "ok", cell
        assert cell["mesh"] == "2x2"
        assert cell["flops"] > 0 and cell["bytes_per_device"] > 0
        assert cell["collectives"]["collective_count"] > 0
        assert cell["fits_80g"]
    assert got["train"]["microbatches"] == 2


def test_plan_counts_the_real_steps_flops_on_a_1x1_mesh():
    """The plan of a train cell on a 1x1 mesh counts exactly the FLOPs
    FlopCounterMode counts around the real step on a 1x1 gloo mesh
    (chip_smoke's [shard] holds the same at full width on the card)."""
    out = _run("""
        import dataclasses, json, tempfile, torch
        import torch.distributed as dist
        from torch.utils.flop_counter import FlopCounterMode
        import repro_torch.configs.registry as reg
        from repro_torch.configs import get
        from repro_torch.configs.registry import ShapeConfig
        from repro_torch.launch import dryrun, sharding as shr
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.models import Model, common
        from repro_torch.optim import OptConfig, adamw
        from repro_torch.train.train_step import make_train_step
        cfg = dataclasses.replace(get("phi3-mini-3.8b").reduced(),
                                  name="dbg")
        reg.ARCHS["dbg"] = cfg
        plan = dryrun.run_cell("dbg", ShapeConfig("t", 16, 4, "train"),
                               mesh_shape=(1, 1), microbatches=1,
                               verbose=False)
        store = tempfile.mkdtemp() + "/store"
        dist.init_process_group("gloo", init_method="file://" + store,
                                rank=0, world_size=1)
        mesh = make_debug_mesh(1, 1)
        model = Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        shr.distribute_model(model, shr.params_shardings(
            dict(model.named_parameters()), mesh, cfg))
        tok = torch.randint(0, cfg.vocab_size, (4, 16))
        batch = {"tokens": tok, "targets": tok,
                 "positions": torch.arange(16).expand(4, 16)}
        batch = shr.place_tree(batch, shr.batch_shardings(batch, mesh,
                                                          "train"))
        with common.mesh_context(mesh):
            opt = adamw.init_state(dict(model.named_parameters()))
            with FlopCounterMode(display=False) as fc:
                make_train_step(cfg, OptConfig(), 1)(model, opt, None,
                                                     batch)
        print(json.dumps({"plan": plan["flops"],
                          "real": fc.get_total_flops()}))
        dist.destroy_process_group()
    """)
    got = json.loads(out.strip().splitlines()[-1])
    assert got["plan"] == got["real"] > 0


# ---------------------------------------------------------------------------
# analytic and the legacy table.
# ---------------------------------------------------------------------------


def _cell(arch, shape):
    return {"arch": arch, "shape": shape, "status": "ok", "microbatches": 2,
            "dot_flops_loop_corrected": 3.5e14,
            "bytes_loop_corrected": 2.0e12, "bytes_per_device": 12.5e9,
            "collectives": {"collective_bytes": 4.0e10}, "compile_s": 7.0}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_analytic_equals_reference_with_the_same_constants(arch,
                                                            monkeypatch):
    for name, value in V5E.items():
        monkeypatch.setattr(analytic, name, value)
    assert set(ARCHS) == set(JARCHS)
    for shape in SHAPES:
        cfg, jcfg = get(arch), jget(arch)
        sh, jsh = SHAPES[shape], JSHAPES[shape]
        assert analytic.model_flops(cfg, sh) == janalytic.model_flops(
            jcfg, jsh)
        for chips, mb in ((256, 1), (512, 4)):
            assert analytic.analytic_hbm_bytes(cfg, sh, chips, mb) == \
                janalytic.analytic_hbm_bytes(jcfg, jsh, chips, mb)
        cell = _cell(arch, shape)
        assert analytic.roofline_terms(cell, cfg, sh) == \
            janalytic.roofline_terms(cell, jcfg, jsh)


def test_analytic_constants_are_the_h100s():
    assert analytic.H100_PEAK_FLOPS == 989e12
    assert analytic.H100_HBM_BW == 3.35e12
    assert analytic.H100_NVLINK_BW == 450e9


def test_legacy_table_equals_the_reference_row(tmp_path, monkeypatch):
    cells = [_cell("qwen3-8b", "train_4k"),
             _cell("falcon-mamba-7b", "decode_32k"),
             {"arch": "qwen3-8b", "shape": "long_500k", "status": "skip"},
             {"arch": "granite-8b", "shape": "decode_32k",
              "status": "error"}]
    ours, theirs = tmp_path / "port", tmp_path / "ref"
    ours.mkdir()
    theirs.mkdir()
    (ours / "all_single.json").write_text(json.dumps(
        [dict(c, fits_80g=True) for c in cells]))
    (theirs / "all_single.json").write_text(json.dumps(
        [dict(c, fits_16g=True) for c in cells]))
    monkeypatch.setattr(roofline, "RESULTS", str(ours))
    monkeypatch.setattr(jroofline, "RESULTS", str(theirs))
    for name, value in V5E.items():
        monkeypatch.setattr(analytic, name, value)
    got, want = roofline.run("single"), jroofline.run("single")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        if "fits_16g" in w:
            w = dict(w)
            w["fits_80g"] = w.pop("fits_16g")
        assert g == w
    assert [r["status"] for r in got] == ["ok", "ok", "skip", "error"]
