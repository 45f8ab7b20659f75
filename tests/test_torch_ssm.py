"""Port the Mamba block (``models/ssm.py``) and falcon-mamba against the
JAX package at reduced size.

Weights come from the JAX init, converted through numpy
(``params_from_jax``), so both packages compute with bit-identical
weights; inputs are made from a numpy seed.  The reference scans the
time recurrence in chunks of 256 steps, padding the sequence; the port
loops over the steps, so the block is also held past one chunk.
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
from repro.models import ssm as jssm  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import traffic as jtraffic  # noqa: E402
from repro_torch.models import Model, convert, ssm  # noqa: E402
from repro_torch.serve import ServeEngine, traffic  # noqa: E402

# f32 logits, caches and block outputs: the same arithmetic in another
# order, as tests/test_torch_model.py
TOL_F32 = 1e-4
# bf16 logits stay below 8, where one bf16 ulp is 2^-5; the frameworks
# round activations at other places, so two ulps are allowed, as
# tests/test_torch_model.py
TOL_BF16 = 2 * 2.0 ** -5
# decoding token by token against the full-sequence forward, as
# tests/test_models_smoke.py holds the reference
TOL_CONSISTENCY = 2e-3
# one float32 ulp, relative
TOL_ULP = 2.0 ** -23

ARCH = "falcon-mamba-7b"
MAX_LEN = 48


@functools.lru_cache(maxsize=None)
def _pair(dtype="float32"):
    jcfg = dataclasses.replace(jreg.get(ARCH).reduced(), dtype=dtype)
    jm = get_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = convert.config_from_jax(jcfg)
    model = Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(
        cfg, jax.tree.map(np.asarray, params)))
    return jcfg, jm, params, cfg, model


def _tokens(cfg, b=2, s=12, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return toks, pos


def _jbatch(toks, pos):
    return {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)}


def _tbatch(toks, pos):
    return {"tokens": torch.from_numpy(toks).long(),
            "positions": torch.from_numpy(pos).long()}


def test_init_constants_match_the_reference():
    jcfg, _, params, cfg, _ = _pair()
    fresh = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    din, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    want = jax.tree.map(np.asarray, params)["blocks"]["mixer"]
    for blk in fresh.blocks:
        p = blk.mixer
        # log(1..n) on every channel, to one f32 ulp (each library
        # rounds its own log)
        log_n = np.log(np.arange(1, n + 1, dtype=np.float64))
        np.testing.assert_allclose(p.a_log.numpy(), np.tile(log_n, (din, 1)),
                                   rtol=TOL_ULP, atol=0)
        np.testing.assert_allclose(p.a_log.numpy(), want["a_log"][0],
                                   rtol=TOL_ULP, atol=0)
        np.testing.assert_array_equal(p.d_skip.numpy(), np.ones(din))
        np.testing.assert_array_equal(p.dt_bias.numpy(), np.zeros(din))
        np.testing.assert_array_equal(p.conv_b.numpy(), np.zeros(din))
        # conv_w ~ 0.1 N(0, 1)
        assert 0.05 < float(p.conv_w.std()) < 0.15
        assert p.a_log.dtype == p.d_skip.dtype == torch.float32


@pytest.mark.parametrize("s", [7, 300])
def test_mamba_block_continues_from_a_state(s):
    """The block from a carried (conv tail, h) state, at 7 steps and at
    300 (past the reference's 256-step chunk, whose padded steps must
    leave h as it is)."""
    jcfg, _, params, cfg, model = _pair()
    jp = jax.tree.map(lambda a: a[1], params["blocks"]["mixer"])
    p = model.blocks[1].mixer
    din = cfg.ssm_expand * cfg.d_model
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    tail = rng.standard_normal((2, cfg.ssm_conv - 1, din)).astype(np.float32)
    h0 = rng.standard_normal((2, din, cfg.ssm_state)).astype(np.float32)
    want, (wtail, wh) = jax.jit(
        lambda p_, x_, st: jssm.mamba(p_, jcfg, x_, st))(
        jp, jnp.asarray(x), (jnp.asarray(tail), jnp.asarray(h0)))
    got, (gtail, gh) = ssm.mamba(p, cfg, torch.from_numpy(x),
                                 (torch.from_numpy(tail),
                                  torch.from_numpy(h0)))
    for g, w in ((got, want), (gtail, wtail), (gh, wh)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL_F32,
                                   atol=TOL_F32)


def test_prefill_logits_match_f32():
    _, jm, params, cfg, model = _pair()
    toks, pos = _tokens(cfg)
    want, _ = jm.train_logits(params, _jbatch(toks, pos))
    got, aux = model.train_logits(_tbatch(toks, pos))
    assert got.shape == (2, 12, cfg.vocab_size) and aux == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_F32,
                               atol=TOL_F32)


def test_prefill_logits_match_bf16():
    """bf16 weights and activations (the recurrences' constants and the
    norms in f32, as in the reference): within two bf16 ulps of the
    reference's logits, and the same top-1 token on more than 90 %."""
    _, jm, params, cfg, model = _pair("bfloat16")
    toks, pos = _tokens(cfg, seed=1)
    want = np.asarray(jm.train_logits(params, _jbatch(toks, pos))[0],
                      np.float32)
    got = model.prefill(_tbatch(toks, pos))
    assert got.dtype == torch.bfloat16
    assert np.abs(want).max() < 8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=TOL_BF16)
    assert (got.float().numpy().argmax(-1) == want.argmax(-1)).mean() > 0.9


def test_decode_steps_match_logits_and_cache():
    _, jm, params, cfg, model = _pair()
    b = 2
    jcache, tcache = jm.init_cache(b, 16), model.init_cache(b, 16)
    din = cfg.ssm_expand * cfg.d_model
    assert tcache["conv"].shape == (cfg.num_layers, b, cfg.ssm_conv - 1,
                                    din)
    assert tcache["h"].shape == (cfg.num_layers, b, din, cfg.ssm_state)
    toks, _ = _tokens(cfg, b=b, s=8, seed=2)
    decode = jax.jit(jm.decode_step)
    for t in range(8):
        tok, pos = toks[:, t:t + 1], np.full((b, 1), t, np.int32)
        jl, jcache = decode(params, jcache, _jbatch(tok, pos))
        tl, tcache = model.decode_step(tcache, _tbatch(tok, pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=TOL_F32, atol=TOL_F32)
        for k in ("conv", "h"):
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(jcache[k]),
                                       rtol=TOL_F32, atol=TOL_F32)


def test_prefill_decode_consistency():
    """Decoding token by token through the (conv, h) state reproduces the
    full-sequence logits."""
    _, _, _, cfg, model = _pair()
    toks, pos = _tokens(cfg, b=1, s=10, seed=5)
    full = model.prefill(_tbatch(toks, pos))
    cache = model.init_cache(1, 10)
    for t in range(10):
        logits, cache = model.decode_step(cache, _tbatch(
            toks[:, t:t + 1], pos[:, t:t + 1]))
        np.testing.assert_allclose(logits[0, 0].numpy(), full[0, t].numpy(),
                                   rtol=TOL_CONSISTENCY,
                                   atol=TOL_CONSISTENCY)


def test_param_count_matches_the_reference_tree():
    _, _, params, _, model = _pair()
    assert sum(v.numel() for v in model.state_dict().values()) == \
        sum(a.size for a in jax.tree.leaves(params))


def _scenario(tr, vocab, n=6, seed=1):
    cfg = dataclasses.replace(
        tr.TRAFFIC_MIXES["steady"], n_requests=n, max_len=MAX_LEN,
        vocab=vocab, deadline=400.0)
    return tr.generate(cfg, seed=seed)


def test_serve_token_identical_to_reference_resident():
    """Slots reset on admission, so no recurrent state leaks from one
    request to the next."""
    jcfg, jm, params, cfg, model = _pair()
    kw = dict(slots=2, max_len=MAX_LEN)
    je = JServeEngine(jcfg, params, model=jm,
                      decode_fn=jax.jit(jm.decode_step), **kw)
    te = ServeEngine(cfg, model, device="cpu", **kw)
    jreqs = je.serve(_scenario(jtraffic, cfg.vocab_size))
    treqs = te.serve(_scenario(traffic, cfg.vocab_size))
    assert all(r.status == "done" for r in treqs)
    for j, t in zip(jreqs, treqs):
        assert (t.rid, t.status, t.out, t.token_times) == \
            (j.rid, j.status, j.out, j.token_times), f"rid {t.rid}"


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve as cli
    assert cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--requests", "3", "--max-new", "4"]) == 0
    assert "served 3/3 requests" in capsys.readouterr().out
