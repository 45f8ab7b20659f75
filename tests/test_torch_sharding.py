"""The port's sharding rules held leaf by leaf to the reference's.

The reference side runs in one subprocess with 512 forced host devices
(JAX fixes its device count at first import), without
``common.set_mesh``, which R2 breaks: ``params_shardings``,
``batch_shardings`` and ``cache_shardings`` only read the mesh's shape.
The port side reads the same shapes off an ``AbstractMesh``, with no
process group.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

from repro_torch.configs import ARCHS, SHAPES, get  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import sharding, specs  # noqa: E402
from repro_torch.models import attention, common, convert  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": mesh_mod.production_shape(),
          "2x16x16": mesh_mod.production_shape(multi_pod=True)}
SMALL = ("4x2", "2x2")

_REFERENCE = """
import json, sys
import jax, numpy as np
from repro.configs import ARCHS, SHAPES, get
from repro.launch import sharding as shr, specs
from repro.models import attention as A
from repro.train import train_step as jts

MESHES = json.loads(sys.argv[1])
devs = jax.devices()

def dotted(path):
    return ".".join(str(getattr(p, "key", getattr(p, "idx", "")))
                    for p in path)

def norm(spec):
    return [list(a) if isinstance(a, tuple) else a for a in spec]

def specs_of(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {dotted(path): norm(s.spec) for path, s in flat}

out = {"params": {}, "batch": {}, "cache": {}, "rep": {}, "batch_fn": {}}
state = {a: specs.state_specs(a)[0] for a in ARCHS}
for name, (shape, axes) in MESHES.items():
    n = int(np.prod(shape))
    mesh = jax.make_mesh(tuple(shape), tuple(axes), devices=devs[:n])
    out["params"][name] = {a: specs_of(shr.params_shardings(state[a], mesh))
                           for a in ARCHS}
    out["batch"][name] = {a: {s: specs_of(shr.batch_shardings(
        specs.batch_specs(a, SHAPES[s]), mesh, SHAPES[s].kind))
        for s in SHAPES} for a in ARCHS}
    fn = jts.shard_batch_specs(get("qwen2-vl-7b"), mesh)
    out["batch_fn"][name] = {k: norm(fn(k).spec) for k in (
        "tokens", "targets", "positions3", "vision_embeds", "audio_embeds")}
    out["cache"][name] = {a: {s: specs_of(shr.cache_shardings(
        specs.cache_specs(a, SHAPES[s]), mesh)) for s in SHAPES}
        for a in ARCHS}

# The GQA expansion, read off the reference's own _project_qkv with the
# mesh lookup answering a 16-way model axis (set_mesh is R2's).
class _Mesh16:
    shape = {"model": 16}
A.common.get_mesh = lambda: _Mesh16
A.shard = lambda x, *dims: x
for a in ARCHS:
    cfg = get(a)
    if cfg.mla or cfg.ssm:
        continue
    p = jax.eval_shape(lambda k: A.init_attention(k, cfg, jax.numpy.bfloat16),
                       jax.random.PRNGKey(0))
    x = jax.ShapeDtypeStruct((1, 4, cfg.d_model), jax.numpy.bfloat16)
    pos = jax.ShapeDtypeStruct((3, 1, 4) if cfg.positional == "mrope"
                               else (1, 4), jax.numpy.int32)
    q, k, v = jax.eval_shape(
        lambda p, x, pos: A._project_qkv(p, cfg, x, pos, expand_kv=True),
        p, x, pos)
    out["rep"][a] = k.shape[2] // cfg.num_kv_heads
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=512")
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE),
         json.dumps(MESHES)], capture_output=True, text=True, env=env,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _mesh(name):
    return common.AbstractMesh(*MESHES[name])


def _norm(spec):
    return [list(a) if isinstance(a, tuple) else a for a in spec]


def _ref_key(cfg, name):
    """The reference's leaf key for a port parameter name, and whether
    the reference stacks it (leading layer dim)."""
    stack, *rest = name.split(".")
    for ref_stack, (port_stack, first, count) in convert._stacks(
            cfg).items():
        if stack == port_stack and rest and rest[0].isdigit() \
                and first <= int(rest[0]) < first + count:
            return ".".join([ref_stack] + rest[1:]), True
    return name, False


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_specs_equal_reference(ref, mesh_name, arch):
    cfg = get(arch)
    want = ref["params"][mesh_name][arch]
    params, _ = specs.state_specs(arch)
    got = sharding.params_shardings(params, _mesh(mesh_name), cfg)
    covered = set()
    for name, sh in got.items():
        key, stacked = _ref_key(cfg, name)
        covered.add(key)
        ref_spec = want[key]
        if stacked:
            assert ref_spec[0] is None, (name, ref_spec)
            ref_spec = ref_spec[1:]
        assert _norm(sh.spec) == ref_spec, (name, sh.spec, ref_spec)
    assert covered == set(want)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("mesh_name", SMALL)
def test_local_shards_divide(mesh_name, arch):
    """R2's contract: every parameter's shard shape divides."""
    params, _ = specs.state_specs(arch)
    for name, sh in sharding.params_shardings(
            params, _mesh(mesh_name), get(arch)).items():
        local = sh.shard_shape(params[name].shape)
        assert all(n > 0 for n in local), name


@pytest.mark.parametrize("arch", list(ARCHS))
def test_opt_specs_mirror_params(arch):
    mesh = _mesh("4x2")
    params, opt = specs.state_specs(arch)
    psh = sharding.params_shardings(params, mesh, get(arch))
    osh = sharding.opt_shardings(opt, psh, mesh)
    assert osh["step"].spec == ()
    for part in ("m", "v", "master"):
        assert set(opt[part]) == set(psh)
        for k in psh:
            assert osh[part][k] == psh[k]
            assert opt[part][k].shape == params[k].shape
            assert opt[part][k].dtype.is_floating_point


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_and_cache_specs_equal_reference(ref, mesh_name, arch):
    mesh = _mesh(mesh_name)
    for shape_name, shape in SHAPES.items():
        batch = specs.batch_specs(arch, shape)
        got = sharding.batch_shardings(batch, mesh, shape.kind)
        want = ref["batch"][mesh_name][arch][shape_name]
        assert {k: _norm(v.spec) for k, v in got.items()} == want
        cache = specs.cache_specs(arch, shape)
        got = sharding.cache_shardings(cache, mesh)
        want = ref["cache"][mesh_name][arch][shape_name]
        assert {k: _norm(v.spec) for k, v in got.items()} == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_shard_batch_specs_equal_reference(ref, mesh_name):
    from repro_torch.train.train_step import shard_batch_specs
    fn = shard_batch_specs(get("qwen2-vl-7b"), _mesh(mesh_name))
    got = {k: _norm(fn(k).spec) for k in ref["batch_fn"][mesh_name]}
    assert got == ref["batch_fn"][mesh_name]


def test_gqa_rep_equals_reference(ref):
    assert ref["rep"], "no GQA arch read"
    for arch, want in ref["rep"].items():
        assert attention.kv_repeat(get(arch), 16) == want, arch


def test_r8_blocks_of_the_hybrid_lose_their_first_dim(ref):
    """R8, pinned on both sides: the reference takes recurrentgemma's
    per-layer blocks as stacked, so ``in_x`` (2560, 2560) and the
    MLP's ``wo`` (7680, 2560) get (None, 'model'), not rule fm / mf;
    the port reproduces it, and the same leaves of a non-hybrid arch
    keep their rules."""
    want = ref["params"]["4x2"]["recurrentgemma-2b"]
    assert want["blocks.0.mixer.in_x"] == [None, "model"]
    assert want["blocks.0.ffn.wo"] == [None, "model"]
    mesh = _mesh("4x2")
    params, _ = specs.state_specs("recurrentgemma-2b")
    assert tuple(params["blocks.0.mixer.in_x"].shape) == (2560, 2560)
    assert tuple(params["blocks.0.ffn.wo"].shape) == (7680, 2560)
    got = sharding.params_shardings(params, mesh, get("recurrentgemma-2b"))
    assert got["blocks.0.mixer.in_x"].spec == (None, "model")
    assert got["blocks.0.ffn.wo"].spec == (None, "model")
    dense, _ = specs.state_specs("granite-8b")
    dense_sh = sharding.params_shardings(dense, mesh, get("granite-8b"))
    assert dense_sh["blocks.0.ffn.wo"].spec == ("model", "data")
