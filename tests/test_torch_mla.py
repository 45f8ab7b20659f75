"""Port MLA (``models/attention.py``), the deepseek-v2-lite model, MoE
serving and the config shims against the JAX package at reduced size.

Weights come from the JAX init, converted through numpy
(``params_from_jax``), so both packages compute with bit-identical
weights; inputs are made from a numpy seed.
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import traffic as jtraffic  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import Model, attention, convert  # noqa: E402
from repro_torch.serve import ServeEngine, traffic  # noqa: E402


@pytest.fixture(autouse=True)
def _forward_only():
    """The model's parameters are trainable; these tests hold forward
    values, so they run without autograd (as prefill and decode do)."""
    with torch.no_grad():
        yield


# mla_attention / mla_decode in f32: the same arithmetic in another order
TOL_MLA = 1e-4
# Reduced-model logits, as tests/test_torch_model.py
TOL_F32 = 1e-4

DEEPSEEK = "deepseek-v2-lite-16b"
PHI = "phi3.5-moe-42b-a6.6b"
MAX_LEN = 48
PAGE = 8
POOL_STATS = ("hits", "misses", "spills", "fills", "shrinks", "hot_pages",
              "pinned_pages", "hot_bytes", "cold_bytes")
SHIMS = {
    "command_r_plus_104b": "command-r-plus-104b",
    "deepseek_v2_lite_16b": "deepseek-v2-lite-16b",
    "falcon_mamba_7b": "falcon-mamba-7b",
    "granite_8b": "granite-8b",
    "phi3_5_moe_42b": "phi3.5-moe-42b-a6.6b",
    "phi3_mini_3_8b": "phi3-mini-3.8b",
    "qwen2_vl_7b": "qwen2-vl-7b",
    "qwen3_8b": "qwen3-8b",
    "recurrentgemma_2b": "recurrentgemma-2b",
    "whisper_large_v3": "whisper-large-v3",
}


@functools.lru_cache(maxsize=None)
def _model_pair(arch, dtype="float32", moe=True):
    jcfg = dataclasses.replace(jreg.get(arch).reduced(), dtype=dtype)
    if not moe:
        # as tests/test_models_smoke.py's consistency test: MoE off, so
        # the MLA latent-cache path is isolated
        jcfg = dataclasses.replace(jcfg, moe=False, num_experts=0,
                                   moe_top_k=0, first_dense_layers=0)
    jm = get_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0 if moe else 1))
    tree = jax.tree.map(np.asarray, params)
    cfg = convert.config_from_jax(jcfg)
    model = Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(cfg, tree))
    return jcfg, jm, params, tree, cfg, model


def _mla_pair(seed=0):
    jcfg, _, _, _, cfg, _ = _model_pair(DEEPSEEK)
    jp = jattention.init_mla(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    p = attention.MLA(cfg, torch.float32, "cpu")
    p.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                       for k, v in convert._flatten(
                           jax.tree.map(np.asarray, jp))})
    return jcfg, cfg, jp, p


def _tokens(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return toks, pos


def _jbatch(toks, pos):
    return {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)}


def _tbatch(toks, pos):
    return {"tokens": torch.tensor(toks).long(),
            "positions": torch.tensor(pos).long()}


# ------------------------------------------------------------------ MLA --

@pytest.mark.parametrize("causal", [True, False])
def test_mla_attention_matches(causal):
    jcfg, cfg, jp, p = _mla_pair()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 10)).astype(np.int32)
    want, (wc, wkr) = jattention.mla_attention(
        jp, jcfg, jnp.asarray(x), jnp.asarray(pos), causal=causal)
    got, (c, kr) = attention.mla_attention(
        p, cfg, torch.from_numpy(x), torch.from_numpy(pos).long(),
        causal=causal)
    assert c.shape == (2, 10, cfg.kv_lora_rank)
    assert kr.shape == (2, 10, cfg.qk_rope_dim)
    for g, w in ((got, want), (c, wc), (kr, wkr)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL_MLA,
                                   atol=TOL_MLA)


def test_mla_decode_matches_and_writes_in_place():
    jcfg, cfg, jp, p = _mla_pair(seed=2)
    rng = np.random.default_rng(3)
    b, smax = 3, 8
    cc = rng.standard_normal((b, smax, cfg.kv_lora_rank)).astype(np.float32)
    ckr = rng.standard_normal((b, smax, cfg.qk_rope_dim)).astype(np.float32)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    # the last slot's position runs past the cache: min(pos, smax - 1)
    pos = np.array([[2], [5], [11]], np.int32)
    want, wc, wkr = jattention.mla_decode(
        jp, jcfg, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(cc),
        jnp.asarray(ckr), None)
    tc, tkr = torch.from_numpy(cc.copy()), torch.from_numpy(ckr.copy())
    got = attention.mla_decode(p, cfg, torch.from_numpy(x),
                               torch.from_numpy(pos).long(), tc, tkr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_MLA,
                               atol=TOL_MLA)
    np.testing.assert_allclose(tc.numpy(), np.asarray(wc), rtol=TOL_MLA,
                               atol=TOL_MLA)
    np.testing.assert_allclose(tkr.numpy(), np.asarray(wkr), rtol=TOL_MLA,
                               atol=TOL_MLA)
    assert not np.array_equal(tc.numpy(), cc)


def test_mla_kv_norm_stays_f32():
    _, _, _, _, cfg, model = _model_pair(DEEPSEEK, "bfloat16")
    mixer = model.blocks[0].mixer
    assert isinstance(mixer, attention.MLA)
    assert mixer.kv_norm.scale.dtype == torch.float32
    assert mixer.wdkv.dtype == torch.bfloat16


# ---------------------------------------------------------------- model --

def test_params_from_jax_maps_dense_blocks_first():
    jcfg, _, _, tree, cfg, model = _model_pair(DEEPSEEK)
    assert cfg.first_dense_layers == 1 and cfg.num_layers == 2
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["blocks.0.ffn.wi"].numpy(),
        np.asarray(tree["dense_blocks"]["ffn"]["wi"][0], np.float32))
    np.testing.assert_array_equal(
        sd["blocks.1.ffn.wi"].numpy(),
        np.asarray(tree["blocks"]["ffn"]["wi"][0], np.float32))
    assert sd["blocks.0.ffn.wi"].shape == (cfg.d_model, cfg.d_ff)
    assert sd["blocks.1.ffn.router"].dtype == torch.float32
    n = sum(a.size for a in jax.tree.leaves(tree))
    assert sum(v.numel() for v in sd.values()) == n
    with pytest.raises(ValueError, match="layers"):
        convert.params_from_jax(
            dataclasses.replace(cfg, first_dense_layers=0), tree)
    with pytest.raises(ValueError, match="dense_blocks"):
        convert.params_from_jax(cfg, {k: v for k, v in tree.items()
                                      if k != "dense_blocks"})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_match(dtype):
    jcfg, jm, params, _, cfg, model = _model_pair(DEEPSEEK, dtype)
    toks, pos = _tokens(cfg)
    want, waux = jm.train_logits(params, _jbatch(toks, pos))
    got, aux = model.train_logits(_tbatch(toks, pos))
    want = np.asarray(want, np.float32)
    assert got.shape == (2, 16, cfg.vocab_size)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL_F32,
                                   atol=TOL_F32)
        assert abs(float(aux) - float(waux)) <= TOL_F32
    else:
        assert got.dtype == torch.bfloat16
        assert (got.float().numpy().argmax(-1) == want.argmax(-1)).mean() \
            > 0.9


def test_decode_steps_match_logits_and_latent_cache():
    jcfg, jm, params, _, cfg, model = _model_pair(DEEPSEEK)
    b, smax = 2, 6
    jcache, tcache = jm.init_cache(b, smax), model.init_cache(b, smax)
    assert set(tcache) == {"c", "kr"}
    assert tcache["c"].shape == (cfg.num_layers, b, smax, cfg.kv_lora_rank)
    toks, _ = _tokens(cfg, b=b, s=8, seed=2)
    decode = jax.jit(jm.decode_step)
    for t in range(8):
        tok, pos = toks[:, t:t + 1], np.full((b, 1), t, np.int32)
        jl, jcache = decode(params, jcache, _jbatch(tok, pos))
        tl, tcache = model.decode_step(tcache, _tbatch(tok, pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=TOL_F32, atol=TOL_F32)
        for k in ("c", "kr"):
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(jcache[k]),
                                       rtol=TOL_F32, atol=TOL_F32)


def test_mla_prefill_decode_consistency_moe_off():
    """tests/test_models_smoke.py's check: decoding token by token through
    the latent cache reproduces the full-sequence logits (MoE off, whose
    per-group capacities differ between the two)."""
    _, jm, params, _, cfg, model = _model_pair(DEEPSEEK, moe=False)
    assert not cfg.moe and cfg.mla
    s = 8
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (1, s), 0,
                                         cfg.vocab_size), np.int32)
    full, _ = model.train_logits(
        _tbatch(toks, np.arange(s, dtype=np.int32)[None]))
    cache = model.init_cache(1, s)
    outs = []
    for t in range(s):
        logits, cache = model.decode_step(cache, _tbatch(
            toks[:, t:t + 1], np.full((1, 1), t, np.int32)))
        outs.append(logits[0, 0].numpy())
    np.testing.assert_allclose(np.stack(outs), full[0].numpy(), rtol=2e-3,
                               atol=2e-3)
    want, _ = jm.train_logits(params, _jbatch(
        toks, np.arange(s, dtype=np.int32)[None]))
    np.testing.assert_allclose(full.numpy(), np.asarray(want), rtol=TOL_F32,
                               atol=TOL_F32)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b",
                                  "qwen2-vl-7b", "whisper-large-v3"])
def test_other_families_build_with_reference_caches(arch):
    """The port's own reduced config builds with the port's seeded init,
    holds as many weights as the reference's tree, lays its decode cache
    out as the reference's init_cache (names, shapes, dtypes) and takes
    a finite decode step."""
    cfg = treg.get(arch).reduced()
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    jm = get_model(jreg.get(arch).reduced())
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    assert sum(v.numel() for v in model.state_dict().values()) == \
        sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    b, smax = 2, 16
    jcache = jax.eval_shape(lambda: jm.init_cache(b, smax))
    cache = model.init_cache(b, smax)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in cache.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jcache.items()}
    batch = _tbatch(np.ones((b, 1), np.int32), np.zeros((b, 1), np.int32))
    if cfg.positional == "mrope":
        batch["positions3"] = batch["positions"].expand(3, b, 1)
    logits, _ = model.decode_step(cache, batch)
    assert logits.shape == (b, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


# -------------------------------------------------------------- serving --

def _scenario(tr, vocab, n=6, seed=1):
    cfg = dataclasses.replace(
        tr.TRAFFIC_MIXES["steady"], n_requests=n, max_len=MAX_LEN,
        vocab=vocab, deadline=400.0)
    return tr.generate(cfg, seed=seed)


@pytest.mark.parametrize("kv_mode", ["resident", "dispersed"])
@pytest.mark.parametrize("arch", [DEEPSEEK, PHI])
def test_serve_token_identical_to_reference(arch, kv_mode):
    jcfg, jm, params, _, cfg, model = _model_pair(arch)
    kw = dict(slots=2, max_len=MAX_LEN, kv_mode=kv_mode)
    if kv_mode == "dispersed":
        kw["page_size"] = PAGE
    je = JServeEngine(jcfg, params, model=jm,
                      decode_fn=jax.jit(jm.decode_step), **kw)
    te = ServeEngine(cfg, model, device="cpu", **kw)
    jreqs = je.serve(_scenario(jtraffic, cfg.vocab_size))
    treqs = te.serve(_scenario(traffic, cfg.vocab_size))
    assert all(r.status == "done" for r in treqs)
    for j, t in zip(jreqs, treqs):
        assert (t.rid, t.status, t.out, t.token_times) == \
            (j.rid, j.status, j.out, j.token_times), f"rid {t.rid}"
    jstats, tstats = je.kv_stats(), te.kv_stats()
    assert {k: tstats[k] for k in POOL_STATS if k in tstats} == \
        {k: jstats[k] for k in POOL_STATS if k in jstats}
    if kv_mode == "dispersed":
        want = ("c", "kr") if arch == DEEPSEEK else ("k", "v")
        assert te._paged == je._paged == want
        assert tstats["fills"] > 0 and tstats["hits"] > 0


@pytest.mark.parametrize("arch", [DEEPSEEK, PHI])
def test_serve_cli_runs_moe_archs_on_cpu(arch, capsys):
    from repro_torch.launch import serve as cli
    assert cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                     "--requests", "3", "--max-new", "4"]) == 0
    assert "served 3/3 requests" in capsys.readouterr().out


def test_dispersed_mode_rejects_recurrent_state():
    """The reference's refusal, with its words, on the recurrent models
    themselves; both serve resident."""
    for arch in ("falcon-mamba-7b", "recurrentgemma-2b"):
        cfg = treg.get(arch).reduced()
        model = Model(cfg, device="cpu")
        with pytest.raises(ValueError, match="recurrent state"):
            ServeEngine(cfg, model, slots=2, max_len=MAX_LEN,
                        kv_mode="dispersed", page_size=PAGE, device="cpu")
        ServeEngine(cfg, model, slots=2, max_len=MAX_LEN, device="cpu")


@pytest.mark.parametrize("shim", sorted(SHIMS))
def test_config_shims_match_reference(shim):
    got = importlib.import_module(f"repro_torch.configs.{shim}").CONFIG
    want = importlib.import_module(f"repro.configs.{shim}").CONFIG
    assert got is treg.get(SHIMS[shim])
    # the same fields, attn_impl mapped to the port's names
    assert got == convert.config_from_jax(want)
