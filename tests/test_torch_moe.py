"""Port MoE (``models/mlp.py``) and the phi3.5-moe model against the JAX
package at reduced size.

Weights come from the JAX init (``init_moe``, ``Model.init``), converted
through numpy, so both packages compute with bit-identical weights;
inputs are made from a numpy seed.  ``attn_impl='pallas'`` runs the
Pallas kernel in interpret mode on the CPU; the port's ``'flash'`` runs
its plain twin.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch.models import (Model, attention, common, convert,  # noqa: E402
                                mlp)


@pytest.fixture(autouse=True)
def _forward_only():
    """The model's parameters are trainable; these tests hold forward
    values, so they run without autograd (as prefill and decode do)."""
    with torch.no_grad():
        yield


# moe() in f32: the same arithmetic in another order (the combine sums k
# f32 terms; the expert products run through other GEMMs).
TOL_MOE = 1e-5
TOL_AUX = 1e-6
# Reduced-model logits, as tests/test_torch_model.py: f32 O(1-10) logits,
# and in bf16 two ulps at |x| < 8.
TOL_F32 = 1e-4
TOL_BF16 = 2 * 2.0 ** -5

PHI = "phi3.5-moe-42b-a6.6b"
DEEPSEEK = "deepseek-v2-lite-16b"


def _cfgs(arch, dtype="float32", **change):
    jcfg = dataclasses.replace(jreg.get(arch).reduced(), dtype=dtype,
                               **change)
    return jcfg, convert.config_from_jax(jcfg)


def _moe_pair(arch, dtype="float32", seed=0, **change):
    """A reference MoE param dict and the port's MoE holding the same
    weights."""
    jcfg, cfg = _cfgs(arch, dtype, **change)
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = jmlp.init_moe(jax.random.PRNGKey(seed), jcfg, dt)
    p = mlp.MoE(cfg, common.DTYPES[dtype], "cpu")
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    p.load_state_dict({k: torch.from_numpy(np.array(v)).to(
        torch.float32 if k == "router" else common.DTYPES[dtype])
        for k, v in convert._flatten(tree)})
    return jcfg, cfg, jp, p


def _x(cfg, b=2, s=12, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _model_pair(arch, dtype="float32"):
    jcfg, cfg = _cfgs(arch, dtype)
    jm = get_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    model = Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(cfg, tree))
    return jcfg, jm, params, tree, cfg, model


def _tokens(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return toks, pos


def _jbatch(toks, pos):
    return {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)}


def _tbatch(toks, pos):
    return {"tokens": torch.from_numpy(toks).long(),
            "positions": torch.from_numpy(pos).long()}


# ------------------------------------------------------------- dispatch --

@pytest.mark.parametrize("t,k,e,seed", [(1, 2, 4, 0), (12, 2, 4, 1),
                                        (64, 6, 64, 2), (33, 2, 16, 3),
                                        (40, 3, 3, 4)])
def test_dispatch_ranks_exact(t, k, e, seed):
    rng = np.random.default_rng(seed)
    # distinct experts per token, as top-k gives
    ids = np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(
        np.int32)
    want = np.asarray(jmlp._dispatch_ranks(jnp.asarray(ids), e))
    got = mlp._dispatch_ranks(torch.from_numpy(ids).long(), e)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dispatch_ranks_batched_is_per_group():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 4, (3, 10, 2))
    got = mlp._dispatch_ranks(torch.from_numpy(ids), 4)
    for g in range(3):
        want = np.asarray(jmlp._dispatch_ranks(jnp.asarray(ids[g]), 4))
        np.testing.assert_array_equal(got[g].numpy(), want)


# ------------------------------------------------------------------ moe --

@pytest.mark.parametrize("arch", [PHI, DEEPSEEK])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_moe_matches_f32(arch, capacity_factor):
    """phi3.5-moe has no shared expert, deepseek two; capacity factor
    0.25 drops assignments over capacity."""
    jcfg, cfg, jp, p = _moe_pair(arch)
    assert hasattr(p, "shared") == bool(cfg.num_shared_experts)
    x = _x(cfg)
    want, waux = jmlp.moe(jp, jcfg, jnp.asarray(x), capacity_factor)
    got, aux = mlp.moe(p, cfg, torch.from_numpy(x), capacity_factor)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL_MOE, atol=TOL_MOE)
    assert abs(float(aux) - float(waux)) <= TOL_AUX
    _, _, ids = mlp.route(p, cfg, torch.from_numpy(x))
    rank = mlp._dispatch_ranks(ids, cfg.num_experts)
    cap = max(int(capacity_factor * x.shape[1] * cfg.moe_top_k
                  / cfg.num_experts), 1)
    if capacity_factor < 1:
        assert bool((rank >= cap).any()), "no assignment dropped"


def test_moe_decode_shape_is_one_group_per_slot():
    """In decode every slot is its own group with capacity 1, so no
    assignment is dropped (a token's k experts differ)."""
    jcfg, cfg, jp, p = _moe_pair(DEEPSEEK)
    x = _x(cfg, b=4, s=1, seed=3)
    want, waux = jmlp.moe(jp, jcfg, jnp.asarray(x))
    got, aux = mlp.moe(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL_MOE, atol=TOL_MOE)
    assert abs(float(aux) - float(waux)) <= TOL_AUX


@pytest.mark.parametrize("arch", [PHI, DEEPSEEK])
def test_moe_block_bf16_same_experts(arch):
    jcfg, cfg, jp, p = _moe_pair(arch, "bfloat16", seed=2)
    assert p.router.dtype == torch.float32
    assert p.wi.dtype == torch.bfloat16
    x = _x(cfg, seed=4)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want, _ = jmlp.moe(jp, jcfg, xb)
    got, _ = mlp.moe(p, cfg, xt)
    assert got.dtype == torch.bfloat16
    # TOL_BF16 is two bf16 ulps of a value below 8; the block's outputs
    # reach ~80 (the reference's expert fan-in E), so it is scaled by
    # their largest magnitude over 8
    want32 = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want32).max()) / 8)
    np.testing.assert_allclose(got.float().numpy(), want32, rtol=0,
                               atol=TOL_BF16 * scale)
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse",
                                      xb.astype(jnp.float32),
                                      jp["router"]), -1)
    _, jids = jax.lax.top_k(probs, cfg.moe_top_k)
    _, _, ids = mlp.route(p, cfg, xt)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


def test_moe_init_keeps_the_reference_fan_in():
    """dense_init takes fan_in = shape[0]: E for wi and wg (the
    reference's quirk, kept), ff for wo, d for the router."""
    _, cfg = _cfgs(DEEPSEEK)
    cfg = dataclasses.replace(cfg, num_experts=8, d_model=256, moe_d_ff=512)
    p = mlp.MoE(cfg, torch.float32, "cpu")
    p.init_(torch.Generator().manual_seed(0))
    for w, fan_in in ((p.wi, 8), (p.wg, 8), (p.wo, 512), (p.router, 256)):
        assert abs(float(w.std()) * fan_in ** 0.5 - 1) < 0.05
    assert p.shared.wi.shape == (256, 512 * cfg.num_shared_experts)


# ---------------------------------------------------------------- model --

def test_params_from_jax_keeps_router_f32_and_experts_whole():
    jcfg, _, _, tree, cfg, model = _model_pair(PHI, "bfloat16")
    sd = convert.params_from_jax(cfg, tree)
    assert sd["blocks.1.ffn.router"].dtype == torch.float32
    assert sd["blocks.1.ffn.wi"].dtype == torch.bfloat16
    assert sd["blocks.1.ffn.wi"].shape == (cfg.num_experts, cfg.d_model,
                                           cfg.moe_d_ff)
    assert sd["blocks.0.norm1.bias"].dtype == torch.float32
    for i in range(cfg.num_layers):
        np.testing.assert_array_equal(
            sd[f"blocks.{i}.ffn.wo"].float().numpy(),
            np.asarray(tree["blocks"]["ffn"]["wo"][i], np.float32))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_logits_match_f32(impl):
    jcfg, _, params, _, cfg, model = _model_pair(PHI)
    toks, pos = _tokens(cfg)
    jm = get_model(dataclasses.replace(jcfg, attn_impl=impl))
    want, waux = jm.train_logits(params, _jbatch(toks, pos))
    model.cfg = dataclasses.replace(cfg, attn_impl=convert.ATTN_IMPLS[impl])
    try:
        got, aux = model.train_logits(_tbatch(toks, pos))
    finally:
        model.cfg = cfg
    assert got.shape == (2, 16, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_F32,
                               atol=TOL_F32)
    assert abs(float(aux) - float(waux)) <= TOL_F32


def test_prefill_logits_match_bf16_pallas():
    jcfg, _, params, _, cfg, model = _model_pair(PHI, "bfloat16")
    toks, pos = _tokens(cfg, seed=1)
    jm = get_model(dataclasses.replace(jcfg, attn_impl="pallas"))
    want = np.asarray(jm.prefill(params, _jbatch(toks, pos)), np.float32)
    model.cfg = dataclasses.replace(cfg, attn_impl="flash")
    try:
        got = model.prefill(_tbatch(toks, pos))
    finally:
        model.cfg = cfg
    assert got.dtype == torch.bfloat16
    assert (got.float().numpy().argmax(-1) == want.argmax(-1)).mean() > 0.9


def test_decode_steps_match_logits_and_cache():
    """Eight decode steps into a cache of six: the last steps exercise the
    ``min(pos, smax - 1)`` clamp."""
    jcfg, jm, params, _, cfg, model = _model_pair(PHI)
    b, smax = 2, 6
    jcache, tcache = jm.init_cache(b, smax), model.init_cache(b, smax)
    toks, _ = _tokens(cfg, b=b, s=8, seed=2)
    decode = jax.jit(jm.decode_step)
    for t in range(8):
        tok, pos = toks[:, t:t + 1], np.full((b, 1), t, np.int32)
        jl, jcache = decode(params, jcache, _jbatch(tok, pos))
        tl, tcache = model.decode_step(tcache, _tbatch(tok, pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=TOL_F32, atol=TOL_F32)
        for k in ("k", "v"):
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(jcache[k]),
                                       rtol=TOL_F32, atol=TOL_F32)


def test_train_aux_is_summed_over_moe_layers():
    _, _, _, _, cfg, model = _model_pair(PHI)
    toks, pos = _tokens(cfg, seed=3)
    _, aux = model.train_logits(_tbatch(toks, pos))
    x = model.embed[torch.from_numpy(toks).long()]
    total = 0.0
    for blk in model.blocks:
        h = x + attention.attention(blk.mixer, cfg,
                                    model._norm(blk.norm1, x),
                                    torch.from_numpy(pos).long())
        out, a = mlp.moe(blk.ffn, cfg, model._norm(blk.norm2, h))
        x, total = h + out, total + float(a)
    assert abs(float(aux) - total) <= 1e-6 and float(aux) > 0
