"""Port dense models against the JAX models at reduced size.

The JAX model is initialised from a PRNG key, its parameters converted
through numpy with ``params_from_jax``, so both packages compute with
bit-identical weights.  ``attn_impl='pallas'`` runs the Pallas kernel in
interpret mode on the CPU; the port's ``'flash'`` runs the plain twin.
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
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import (Model, common, convert, mlp,  # noqa: E402
                                rglru, ssm)

# f32 logits are O(1-10); both sides compute the same f32 arithmetic in
# another order.  bf16 logits here stay below 8, where one bf16 ulp is
# 2^-5; the frameworks round activations at other places (e.g. silu in
# bf16 vs f32), so two ulps are allowed.
TOL_F32 = 1e-4
TOL_BF16 = 2 * 2.0 ** -5


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype):
    jcfg = dataclasses.replace(jreg.get(arch).reduced(), dtype=dtype)
    jm = get_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    cfg = convert.config_from_jax(jcfg)
    model = Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(cfg, tree))
    return jcfg, jm, params, tree, cfg, model


def _tokens(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return toks, pos


def _with_impl(model, cfg, impl):
    model.cfg = dataclasses.replace(cfg, attn_impl=impl)
    return model


def test_config_conversion_maps_attn_impl():
    for jname, tname in (("xla", "sdpa"), ("pallas", "flash")):
        jcfg = dataclasses.replace(jreg.get("granite-8b"), attn_impl=jname)
        cfg = convert.config_from_jax(jcfg)
        assert cfg.attn_impl == tname
        assert dataclasses.replace(cfg, attn_impl="xla") == dataclasses.replace(
            treg.get("granite-8b"), attn_impl="xla")
    assert set(treg.ARCHS) == set(jreg.ARCHS)
    assert treg.get("phi3-mini-3.8b").param_count() == \
        jreg.get("phi3-mini-3.8b").param_count()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "deepseek-v2-lite-16b"])
def test_params_from_jax_round_trip(arch, dtype):
    """deepseek-v2-lite has a leading dense layer (``dense_blocks``, the
    port's ``blocks.0``) and an f32 MoE router."""
    jcfg, _, _, tree, cfg, model = _pair(arch, dtype)
    sd = model.state_dict()
    stacks = {"dense_blocks": 0, "blocks": cfg.first_dense_layers}
    flat = dict(convert._flatten({k: v for k, v in tree.items()
                                  if k not in stacks}))
    for name, a in flat.items():
        assert sd[name].dtype == (torch.float32 if "norm" in name
                                  else common.DTYPES[dtype])
        np.testing.assert_array_equal(sd[name].float().numpy(),
                                      np.asarray(a, np.float32))
    n_stacked = 0
    for key, off in stacks.items():
        for name, a in convert._flatten(tree.get(key, {})):
            f32 = "norm" in name or name.endswith("router")
            for i in range(a.shape[0]):
                got = sd[f"blocks.{off + i}.{name}"]
                assert got.dtype == (torch.float32 if f32
                                     else common.DTYPES[dtype])
                np.testing.assert_array_equal(got.float().numpy(),
                                              np.asarray(a[i], np.float32))
                n_stacked += 1
    assert ("dense_blocks" in tree) == bool(cfg.first_dense_layers)
    assert len(sd) == len(flat) + n_stacked


def test_params_from_jax_rejects_layer_mismatch():
    _, _, _, tree, cfg, _ = _pair("phi3-mini-3.8b", "float32")
    with pytest.raises(ValueError, match="layers"):
        convert.params_from_jax(
            dataclasses.replace(cfg, num_layers=cfg.num_layers + 1), tree)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "granite-8b",
                                  "qwen3-8b"])
def test_prefill_logits_match_f32(arch, impl):
    jcfg, jm, params, _, cfg, model = _pair(arch, "float32")
    toks, pos = _tokens(cfg)
    jm = get_model(dataclasses.replace(jcfg, attn_impl=impl))
    want = np.asarray(jm.prefill(params, {"tokens": jnp.asarray(toks),
                                          "positions": jnp.asarray(pos)}))
    m = _with_impl(model, cfg, convert.ATTN_IMPLS[impl])
    got = m.prefill({"tokens": torch.from_numpy(toks).long(),
                     "positions": torch.from_numpy(pos).long()})
    assert got.shape == (2, 16, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_F32,
                               atol=TOL_F32)


def test_prefill_logits_match_bf16_pallas():
    jcfg, _, params, _, cfg, model = _pair("phi3-mini-3.8b", "bfloat16")
    toks, pos = _tokens(cfg, seed=1)
    jm = get_model(dataclasses.replace(jcfg, attn_impl="pallas"))
    want = np.asarray(jm.prefill(params, {"tokens": jnp.asarray(toks),
                                          "positions": jnp.asarray(pos)}),
                      np.float32)
    m = _with_impl(model, cfg, "flash")
    got = m.prefill({"tokens": torch.from_numpy(toks).long(),
                     "positions": torch.from_numpy(pos).long()})
    assert got.dtype == torch.bfloat16
    assert np.abs(want).max() < 8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=TOL_BF16)
    assert (got.float().numpy().argmax(-1) == want.argmax(-1)).mean() > 0.9


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "granite-8b",
                                  "qwen3-8b"])
def test_decode_steps_match_logits_and_cache(arch):
    """Three decode steps; the cache is as long as the step count minus
    one, so the last step exercises the ``min(pos, smax - 1)`` clamp."""
    jcfg, jm, params, _, cfg, model = _pair(arch, "float32")
    b, smax = 2, 2
    jcache = jm.init_cache(b, smax)
    tcache = model.init_cache(b, smax)
    toks, _ = _tokens(cfg, b=b, s=3, seed=2)
    for t in range(3):
        tok = toks[:, t:t + 1]
        pos = np.full((b, 1), t, np.int32)
        jl, jcache = jax.jit(jm.decode_step)(
            params, jcache, {"tokens": jnp.asarray(tok),
                             "positions": jnp.asarray(pos)})
        tl, tcache = model.decode_step(
            tcache, {"tokens": torch.from_numpy(tok).long(),
                     "positions": torch.from_numpy(pos).long()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=TOL_F32, atol=TOL_F32)
        for k in ("k", "v"):
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(jcache[k]),
                                       rtol=TOL_F32, atol=TOL_F32)


def test_rope_and_norms_match():
    from repro.models import common as jcommon
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 1000, (2, 8)).astype(np.int32)
    want = np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         1e4))
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos).long(),
                            1e4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    scale = rng.standard_normal(32).astype(np.float32)
    want = np.asarray(jcommon.rmsnorm({"scale": jnp.asarray(scale)},
                                      jnp.asarray(x), 1e-6))
    p = common.Norm(32, "rms", "cpu")
    p.scale.data = torch.from_numpy(scale)
    got = common.rmsnorm(p, torch.from_numpy(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    bias = rng.standard_normal(32).astype(np.float32)
    want = np.asarray(jcommon.layernorm(
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
        jnp.asarray(x), 1e-5))
    p = common.Norm(32, "layernorm", "cpu")
    p.scale.data, p.bias.data = torch.from_numpy(scale), \
        torch.from_numpy(bias)
    got = common.apply_norm(p, torch.from_numpy(x), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_matches(kind):
    from repro.models import mlp as jmlp
    jp = jmlp.init_mlp(jax.random.PRNGKey(5), 64, 96, jnp.float32, kind)
    if kind == "gelu":
        rng = np.random.default_rng(6)
        jp = dict(jp, bi=jnp.asarray(rng.standard_normal(96), jnp.float32),
                  bo=jnp.asarray(rng.standard_normal(64), jnp.float32))
    p = mlp.MLP(64, 96, torch.float32, kind, "cpu")
    p.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in jp.items()})
    x = np.random.default_rng(7).standard_normal((2, 5, 64)).astype(
        np.float32)
    want = np.asarray(jmlp.mlp(jp, jnp.asarray(x), kind))
    got = mlp.mlp(p, torch.from_numpy(x), kind)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _family_batch(cfg, b=2, s=12, seed=0):
    """A batch for any family: tokens and positions, M-RoPE's positions3
    with different rows per section, whisper's audio frames."""
    rng = np.random.default_rng(seed)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32), "positions": pos}
    if cfg.positional == "mrope":
        batch["positions3"] = np.stack([pos, pos // 2, pos % 3])
    if cfg.encoder_decoder:
        batch["audio_embeds"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch,change", [
    ("recurrentgemma-2b", {}), ("falcon-mamba-7b", {}),
    ("qwen2-vl-7b", {}), ("whisper-large-v3", {}),
    ("phi3-mini-3.8b", {"attn_bias": True}),
    ("phi3-mini-3.8b", {"sliding_window": 8})])
def test_other_families_match_reference_logits(arch, change):
    """Each family, and the dense model with the attention features only
    those use (random non-zero biases; a window of 8 under 12 tokens),
    builds and gives the reference's logits."""
    jcfg = dataclasses.replace(jreg.get(arch).reduced(), dtype="float32",
                               **change)
    jm = get_model(jcfg)
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(rng.standard_normal(a.shape), a.dtype)
        if path[-1].key in ("bq", "bk", "bv") else a,
        jm.init(jax.random.PRNGKey(0)))
    cfg = convert.config_from_jax(jcfg)
    model = Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(
        cfg, jax.tree.map(np.asarray, params)))
    batch = _family_batch(cfg)
    want, _ = jm.train_logits(params, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    got, _ = model.train_logits({
        k: torch.from_numpy(v).long() if v.dtype == np.int32
        else torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_F32,
                               atol=TOL_F32)


def _port_leaves(cfg, tree):
    """(the port's parameter name, the reference leaf) for every leaf:
    stacked layers split out, DeepSeek's dense_blocks first, the
    hybrid's list as it is."""
    off = cfg.first_dense_layers if cfg.moe else 0
    dest = {"dense_blocks": ("blocks", 0), "blocks": ("blocks", off),
            "encoder": ("encoder", 0), "decoder": ("decoder", 0)}
    for key, sub in tree.items():
        if key in dest and isinstance(sub, dict):
            name, start = dest[key]
            for leaf_name, a in convert._flatten(sub):
                for i in range(a.shape[0]):
                    yield f"{name}.{start + i}.{leaf_name}", a[i]
        elif isinstance(sub, (dict, list)):
            yield from convert._flatten(sub, f"{key}.")
        else:
            yield key, sub


@pytest.mark.parametrize("arch", sorted(jreg.ARCHS))
def test_params_from_jax_keeps_reference_dtypes(arch):
    """A bf16 tree of every family: each converted tensor, and each
    tensor of the loaded port model, has the dtype and the values of its
    reference leaf (float32 for the norms, the router and the
    recurrences' constants, bf16 for the rest)."""
    jcfg = dataclasses.replace(jreg.get(arch).reduced(), dtype="bfloat16")
    tree = jax.tree.map(np.asarray,
                        get_model(jcfg).init(jax.random.PRNGKey(0)))
    cfg = convert.config_from_jax(jcfg)
    sd = convert.params_from_jax(cfg, tree)
    model = Model(cfg, device="cpu")
    model.load_state_dict(sd)
    got = model.state_dict()
    leaves = dict(_port_leaves(cfg, tree))
    assert set(got) == set(sd) == set(leaves)
    assert {str(a.dtype) for a in leaves.values()} == {"float32", "bfloat16"}
    for name, a in leaves.items():
        want = common.DTYPES[str(a.dtype)]
        assert sd[name].dtype == got[name].dtype == want, name
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      np.asarray(a, np.float32))
    # the leaves each family keeps in f32, by name
    f32 = {name.rsplit(".", 1)[-1] for name, t in got.items()
           if t.dtype == torch.float32}
    want = {"scale"}
    for names, owner in (({"bias"}, cfg.norm_kind == "layernorm"),
                         ({"router"}, cfg.moe),
                         ({"a_log", "dt_bias", "d_skip"}, cfg.ssm),
                         ({"ba", "bx", "lam"}, cfg.hybrid)):
        if owner:
            want |= names
    assert f32 == want


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is satisfiable")
    cfg = treg.get("phi3-mini-3.8b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.Norm(8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ssm.Mamba(treg.get("falcon-mamba-7b").reduced(), torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rglru.RGLRU(treg.get("recurrentgemma-2b").reduced(), torch.float32)
