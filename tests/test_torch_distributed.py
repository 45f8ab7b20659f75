"""The sharded train and decode steps, K5's mesh route and the elastic
restore, in four ``gloo`` processes on the CPU (the contracts of the
reference's ``tests/test_distributed.py``).

One run of four worker processes (a ``FileStore`` under ``tmp_path``,
so no TCP port can collide between test workers) does every sharded
piece and writes what it found; the tests compare it here with the
unsharded port and with the reference:

- a reduced f32 phi3-mini train step on a 2x2 mesh: the loss equals the
  unsharded port step's within rtol 1e-5 (the reference's test) and the
  reference's loss on the same weights likewise, and the updated f32
  masters are within 1e-5 of both;
- a reduced f32 granite-8b decode step on 2x2 equals the unsharded one
  within 1e-5;
- the ``flash`` branch under the mesh (K5's plain twin on each rank's
  shard, through ``local_map``) equals the unsharded ``sdpa`` prefill
  within ``tests/test_torch_flash.py``'s f32 tolerance;
- a checkpoint saved under (2,2) and restored under (4,1) through
  ``shard_fn`` is bitwise the saved value, with (4,1)'s placements.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.models import Model, convert  # noqa: E402
from repro_torch.optim import OptConfig, adamw  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
B, S = 4, 16
TOL_LOSS = 1e-5              # relative, the reference's test
TOL_MASTER = 1e-5
TOL_DECODE = 1e-5
TOL_FLASH = 2e-5             # tests/test_torch_flash.py, float32
# the other families' sharded train steps against their unsharded ones
FAMILIES = ("qwen3-8b", "phi3.5-moe-42b-a6.6b", "deepseek-v2-lite-16b",
            "falcon-mamba-7b", "recurrentgemma-2b", "whisper-large-v3",
            "qwen2-vl-7b")

_WORKER = r"""
import dataclasses, json, os, sys
import torch
import torch.distributed as dist

rank, work = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="file://" + os.path.join(
    work, "store"), rank=rank, world_size=4)
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get
from repro_torch.launch import mesh as mesh_mod, sharding as shr
from repro_torch.models import Model, common
from repro_torch.optim import OptConfig, adamw
from repro_torch.train.train_step import make_train_step

inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
mesh = mesh_mod.make_debug_mesh(2, 2)
out = {}

def sharded_model(cfg, state):
    model = Model(cfg, device="cpu")
    model.load_state_dict(state)
    params = dict(model.named_parameters())
    return shr.distribute_model(
        model, shr.params_shardings(params, mesh, cfg))

def whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t

def names(placements):
    return [f"{type(p).__name__}({getattr(p, 'dim', '')})"
            for p in placements]

# -- the train step
cfg = inp["train_cfg"]
model = sharded_model(cfg, inp["train_state"])
batch = shr.place_tree(inp["train_batch"], shr.batch_shardings(
    inp["train_batch"], mesh, "train"))
with common.mesh_context(mesh):
    opt = adamw.init_state(dict(model.named_parameters()))
    step = make_train_step(cfg, OptConfig(), 1)
    _, opt, _, met = step(model, opt, None, batch)
out["loss"] = float(whole(met["loss"]))
out["masters"] = {k: whole(v) for k, v in opt["master"].items()}
out["placements"] = {k: names(v.placements)
                     for k, v in model.named_parameters()}

# -- every family's train step
out["families"] = {}
for arch, (cfg, state, fb) in inp["families"].items():
    model = sharded_model(cfg, state)
    fb = shr.place_tree(fb, shr.batch_shardings(fb, mesh, "train"))
    with common.mesh_context(mesh):
        opt = adamw.init_state(dict(model.named_parameters()))
        _, opt, _, met = make_train_step(cfg, OptConfig(), 1)(
            model, opt, None, fb)
    out["families"][arch] = dict(
        loss=float(whole(met["loss"])), aux=float(whole(met["aux"])),
        grad_norm=float(met["grad_norm"]),
        masters={k: whole(v) for k, v in opt["master"].items()})

# -- the decode step
cfg = inp["decode_cfg"]
model = sharded_model(cfg, inp["decode_state"])
cache = model.init_cache(4, 8)
cache = shr.place_tree(cache, shr.cache_shardings(cache, mesh))
logits = []
with common.mesh_context(mesh):
    for t in range(3):
        db = {"tokens": inp["decode_tokens"][:, t:t + 1],
              "positions": torch.full((4, 1), t, dtype=torch.int32)}
        db = shr.place_tree(db, shr.batch_shardings(db, mesh, "decode"))
        lg, cache = model.decode_step(cache, db)
        logits.append(whole(lg))
out["decode_logits"] = torch.stack(logits)
out["decode_cache_k"] = whole(cache["k"])

# -- the flash branch under the mesh
cfg = dataclasses.replace(inp["train_cfg"], attn_impl="flash")
model = sharded_model(cfg, inp["train_state"])
pb = {k: v for k, v in inp["train_batch"].items() if k != "targets"}
pb = shr.place_tree(pb, shr.batch_shardings(pb, mesh, "prefill"))
from repro_torch.kernels import flash_attention as fa
calls = fa.flash_attention_plain.calls
with common.mesh_context(mesh):
    out["flash_logits"] = whole(model.prefill(pb))
out["flash_calls"] = fa.flash_attention_plain.calls - calls

# -- the elastic restore: save under (2,2), restore under (4,1)
from torch.distributed.tensor import distribute_tensor
x_full = torch.arange(64, dtype=torch.float32).reshape(8, 8)
sh_a = common.NamedSharding(mesh, ("data", "model"))
x = distribute_tensor(x_full, mesh, sh_a.placements, src_data_rank=None)
ck = Checkpointer(os.path.join(work, "ckpt"))
ck.save(1, {"x": x}, blocking=True)
dist.barrier()
mesh_b = mesh_mod.make_debug_mesh(4, 1)
sh_b = common.NamedSharding(mesh_b, ("data", "model"))
step_, restored = ck.restore(
    {"x": x}, shard_fn=lambda k, a: distribute_tensor(
        a, mesh_b, sh_b.placements, src_data_rank=None))
r = restored["x"]
out["restore_step"] = step_
out["restore_local"] = r.to_local().clone()
out["restore_placements"] = names(r.placements)
out["restore_mesh"] = list(r.device_mesh.shape)
out["restore_full"] = r.full_tensor()
torch.save(out, os.path.join(work, f"out_{rank}.pt"))
dist.destroy_process_group()
"""


def _reduced(arch):
    jcfg = dataclasses.replace(jreg.get(arch).reduced(), dtype="float32")
    return jcfg, convert.config_from_jax(jcfg)


@functools.lru_cache(maxsize=None)
def _reference_train():
    """The reference's reduced f32 phi3-mini, one train step."""
    jcfg, cfg = _reduced("phi3-mini-3.8b")
    params = get_model(jcfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    targets = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    batch = {"tokens": tokens, "targets": targets,
             "positions": np.ascontiguousarray(positions)}
    opt = jadamw.init_state(params)
    step = jax.jit(jts.make_train_step(jcfg, jadamw.OptConfig(), 1))
    _, new_opt, _, met = step(params, opt, None,
                              {k: jnp.asarray(v) for k, v in batch.items()})
    masters = convert.params_from_jax(
        cfg, jax.tree.map(np.asarray, new_opt["master"]))
    state = convert.params_from_jax(cfg, jax.tree.map(np.asarray, params))
    return dict(cfg=cfg, state=state, batch=batch, loss=float(met["loss"]),
                masters=masters)


def _family(arch):
    """A reduced f32 port model of ``arch`` (seeded), its state and a
    train batch with the family's inputs."""
    cfg = dataclasses.replace(get(arch).reduced(), dtype="float32")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    batch = {"tokens": tok, "targets": torch.roll(tok, -1, 1),
             "positions": torch.arange(S).expand(B, S).contiguous()}
    if cfg.positional == "mrope":
        batch["positions3"] = batch["positions"][None].expand(
            3, B, S).contiguous()
    if cfg.frontend == "vision":
        batch["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32))
        batch["vision_mask"] = torch.arange(S).expand(B, S) < 4
    if cfg.encoder_decoder:
        batch["audio_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return cfg, model.state_dict(), batch


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The four workers' findings (rank 0's) and the inputs they ran."""
    work = str(tmp_path_factory.mktemp("gloo"))
    ref = _reference_train()
    _, dcfg = _reduced("granite-8b")
    dmodel = Model(dcfg, device="cpu").init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, dcfg.vocab_size, (4, 3), dtype=np.int32))
    inputs = dict(
        train_cfg=ref["cfg"], train_state=ref["state"],
        train_batch={k: torch.from_numpy(v) for k, v in ref["batch"].items()},
        decode_cfg=dcfg, decode_state=dmodel.state_dict(),
        decode_tokens=tokens)
    inputs["families"] = {a: _family(a) for a in FAMILIES}
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_WORKER), str(r), work],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(WORLD)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append((p.returncode, err[-3000:]))
    assert all(rc == 0 for rc, _ in errs), errs
    outs = [torch.load(os.path.join(work, f"out_{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    return dict(inputs=inputs, ref=ref, dmodel=dmodel, outs=outs)


def _unsharded_train(inputs):
    cfg = inputs["train_cfg"]
    model = Model(cfg, device="cpu")
    model.load_state_dict(inputs["train_state"])
    opt = adamw.init_state(dict(model.named_parameters()))
    _, opt, _, met = tts.make_train_step(cfg, OptConfig(), 1)(
        model, opt, None, inputs["train_batch"])
    return float(met["loss"]), opt["master"]


def test_sharded_train_loss_matches_unsharded_and_reference(sharded):
    loss, _ = _unsharded_train(sharded["inputs"])
    for out in sharded["outs"]:
        np.testing.assert_allclose(out["loss"], loss, rtol=TOL_LOSS)
        np.testing.assert_allclose(out["loss"], sharded["ref"]["loss"],
                                   rtol=TOL_LOSS)


def test_sharded_train_masters_match_unsharded_and_reference(sharded):
    _, masters = _unsharded_train(sharded["inputs"])
    got = sharded["outs"][0]["masters"]
    ref = sharded["ref"]["masters"]
    assert set(got) == set(masters) == set(ref)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), masters[k].numpy(),
                                   atol=TOL_MASTER, rtol=0, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   atol=TOL_MASTER, rtol=0, err_msg=k)


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_familys_sharded_train_step_matches_unsharded(sharded, arch):
    """MoE (routing on each rank's rows), MLA, the recurrences (their
    time loops on each rank's shard), the encoder-decoder and M-RoPE with
    the vision stub: loss, aux loss and updated masters on 2x2 as
    unsharded."""
    cfg, state, batch = sharded["inputs"]["families"][arch]
    model = Model(cfg, device="cpu")
    model.load_state_dict(state)
    opt = adamw.init_state(dict(model.named_parameters()))
    _, opt, _, met = tts.make_train_step(cfg, OptConfig(), 1)(
        model, opt, None, batch)
    got = sharded["outs"][0]["families"][arch]
    np.testing.assert_allclose(got["loss"], float(met["loss"]),
                               rtol=TOL_LOSS)
    np.testing.assert_allclose(got["aux"], float(met["aux"]), rtol=TOL_LOSS,
                               atol=1e-6)
    np.testing.assert_allclose(got["grad_norm"], float(met["grad_norm"]),
                               rtol=1e-4)
    for k, v in opt["master"].items():
        np.testing.assert_allclose(got["masters"][k].numpy(), v.numpy(),
                                   atol=TOL_MASTER, rtol=0, err_msg=k)


def test_sharded_parameters_follow_the_rules(sharded):
    """The 2-D rules really split the step's weights: wq over (data,
    model), wo over (model, data), the embedding vocab over model."""
    pl = sharded["outs"][0]["placements"]
    assert pl["blocks.0.mixer.wq"] == ["Shard(0)", "Shard(1)"]
    assert pl["blocks.0.mixer.wo"] == ["Shard(1)", "Shard(0)"]
    assert pl["embed"] == ["Shard(1)", "Shard(0)"]


def test_sharded_decode_matches_unsharded(sharded):
    inputs = sharded["inputs"]
    model = sharded["dmodel"]
    cache = model.init_cache(4, 8)
    want = []
    with torch.no_grad():
        for t in range(3):
            lg, cache = model.decode_step(cache, {
                "tokens": inputs["decode_tokens"][:, t:t + 1],
                "positions": torch.full((4, 1), t, dtype=torch.int32)})
            want.append(lg)
    want = torch.stack(want).numpy()
    for out in sharded["outs"]:
        np.testing.assert_allclose(out["decode_logits"].numpy(), want,
                                   atol=TOL_DECODE, rtol=TOL_DECODE)
        np.testing.assert_allclose(out["decode_cache_k"].numpy(),
                                   cache["k"].numpy(), atol=TOL_DECODE,
                                   rtol=TOL_DECODE)


def test_flash_under_the_mesh_matches_sdpa(sharded):
    inputs = sharded["inputs"]
    cfg = inputs["train_cfg"]
    model = Model(cfg, device="cpu")
    model.load_state_dict(inputs["train_state"])
    batch = {k: v for k, v in inputs["train_batch"].items()
             if k != "targets"}
    want = model.prefill(batch).numpy()
    for out in sharded["outs"]:
        # one plain-twin call per layer on every rank's shard
        assert out["flash_calls"] == cfg.num_layers
        np.testing.assert_allclose(out["flash_logits"].numpy(), want,
                                   rtol=TOL_FLASH, atol=TOL_FLASH)


def test_elastic_restore_across_meshes_is_bitwise(sharded):
    want = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    for rank, out in enumerate(sharded["outs"]):
        assert out["restore_step"] == 1
        assert out["restore_mesh"] == [4, 1]
        assert out["restore_placements"] == ["Shard(0)", "Shard(1)"]
        assert torch.equal(out["restore_full"], want)
        assert torch.equal(out["restore_local"],
                           want[2 * rank:2 * rank + 2])
