"""Port the RG-LRU block (``models/rglru.py``), local attention and
recurrentgemma against the JAX package at reduced size.

Weights come from the JAX init, converted through numpy
(``params_from_jax``), so both packages compute with bit-identical
weights; inputs are made from a numpy seed.  The reduced config has 3
layers (RG-LRU, RG-LRU, local attention) and a window of 8; sequences of
12 tokens run past it, so prefill masks by the window and the decode
cache, a ring of 8 slots, wraps.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import traffic as jtraffic  # noqa: E402
from repro_torch.models import Model, attention, convert, rglru  # noqa: E402
from repro_torch.serve import ServeEngine, traffic  # noqa: E402


@pytest.fixture(autouse=True)
def _forward_only():
    """The model's parameters are trainable; these tests hold forward
    values, so they run without autograd (as prefill and decode do)."""
    with torch.no_grad():
        yield


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

ARCH = "recurrentgemma-2b"
SEQ = 12
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


def _tokens(cfg, b=2, s=SEQ, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return toks, pos


def _jbatch(toks, pos):
    return {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)}


def _tbatch(toks, pos):
    return {"tokens": torch.from_numpy(toks).long(),
            "positions": torch.from_numpy(pos).long()}


def test_layer_pattern_and_init_constants():
    _, _, params, cfg, _ = _pair()
    assert cfg.num_layers == 3 and cfg.sliding_window == 8
    fresh = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    kinds = [type(b.mixer) for b in fresh.blocks]
    assert kinds == [rglru.RGLRU, rglru.RGLRU, attention.Attention]
    w = cfg.lru_width
    tree = jax.tree.map(np.asarray, params)
    for i in (0, 1):
        p = fresh.blocks[i].mixer
        for name, value in (("ba", 2.0), ("bx", 0.0), ("lam", 3.0)):
            got = getattr(p, name)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.full(w, value))
            np.testing.assert_array_equal(got.numpy(),
                                          tree["blocks"][i]["mixer"][name])
        assert p.conv_w.shape == (rglru.CONV_WIDTH, w)
        assert 0.05 < float(p.conv_w.std()) < 0.15


@pytest.mark.parametrize("s", [7, 300])
def test_rglru_block_continues_from_a_state(s):
    """The block from a carried (conv tail, h) state, at 7 steps and at
    300 (past the reference's 256-step chunk, whose padded steps must
    leave h as it is)."""
    jcfg, _, params, cfg, model = _pair()
    jp = params["blocks"][1]["mixer"]
    p = model.blocks[1].mixer
    w = cfg.lru_width
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    tail = rng.standard_normal((2, rglru.CONV_WIDTH - 1, w)).astype(
        np.float32)
    h0 = rng.standard_normal((2, w)).astype(np.float32)
    want, (wtail, wh) = jax.jit(
        lambda p_, x_, st: jrglru.rglru(p_, jcfg, x_, st))(
        jp, jnp.asarray(x), (jnp.asarray(tail), jnp.asarray(h0)))
    got, (gtail, gh) = rglru.rglru(p, cfg, torch.from_numpy(x),
                                   (torch.from_numpy(tail),
                                    torch.from_numpy(h0)))
    for g, w_ in ((got, want), (gtail, wtail), (gh, wh)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=TOL_F32,
                                   atol=TOL_F32)


def test_prefill_logits_match_f32():
    """12 tokens under a window of 8: the window masks the attention
    layer's early keys."""
    _, jm, params, cfg, model = _pair()
    toks, pos = _tokens(cfg)
    want, _ = jm.train_logits(params, _jbatch(toks, pos))
    got, aux = model.train_logits(_tbatch(toks, pos))
    assert got.shape == (2, SEQ, cfg.vocab_size) and aux == 0.0
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
    """12 steps into a k/v ring of min(max_len, window) = 8 slots: the
    ring wraps at step 8."""
    _, jm, params, cfg, model = _pair()
    b = 2
    jcache, tcache = jm.init_cache(b, 16), model.init_cache(b, 16)
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    assert tcache["k"].shape[2] == 8
    toks, _ = _tokens(cfg, b=b, seed=2)
    decode = jax.jit(jm.decode_step)
    for t in range(SEQ):
        tok, pos = toks[:, t:t + 1], np.full((b, 1), t, np.int32)
        jl, jcache = decode(params, jcache, _jbatch(tok, pos))
        tl, tcache = model.decode_step(tcache, _tbatch(tok, pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=TOL_F32, atol=TOL_F32)
        for k in ("conv", "h", "k", "v"):
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(jcache[k]),
                                       rtol=TOL_F32, atol=TOL_F32)


def test_prefill_decode_consistency():
    """Decoding token by token (recurrent state and the wrapping ring)
    reproduces the full-sequence logits under the window."""
    _, _, _, cfg, model = _pair()
    toks, pos = _tokens(cfg, b=1, seed=5)
    full = model.prefill(_tbatch(toks, pos))
    cache = model.init_cache(1, SEQ)
    for t in range(SEQ):
        logits, cache = model.decode_step(cache, _tbatch(
            toks[:, t:t + 1], pos[:, t:t + 1]))
        np.testing.assert_allclose(logits[0, 0].numpy(), full[0, t].numpy(),
                                   rtol=TOL_CONSISTENCY,
                                   atol=TOL_CONSISTENCY)


@pytest.mark.parametrize("smax", [8, 16])
def test_decode_attention_ring_and_window(smax):
    """decode_attention on its own: a cache of 8 slots is the ring, one
    of 16 (longer than the window) keeps the window in its mask; the
    positions run past both."""
    jcfg, _, params, cfg, model = _pair()
    jp = params["blocks"][2]["mixer"]
    p = model.blocks[2].mixer
    rng = np.random.default_rng(smax)
    hd, hkv = cfg.head_dim, cfg.num_kv_heads
    ck = rng.standard_normal((3, smax, hkv, hd)).astype(np.float32)
    cv = rng.standard_normal((3, smax, hkv, hd)).astype(np.float32)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([[3], [9], [20]], np.int32)
    want, wk, wv = jattention.decode_attention(
        jp, jcfg, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(ck),
        jnp.asarray(cv), None)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = attention.decode_attention(p, cfg, torch.from_numpy(x),
                                     torch.from_numpy(pos).long(), tk, tv)
    for g, w in ((got, want), (tk, wk), (tv, wv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL_F32,
                                   atol=TOL_F32)


def test_flash_refuses_the_window():
    """The reference asserts ``window is None`` before its kernel."""
    _, _, _, cfg, model = _pair()
    x = torch.zeros((1, 8, cfg.d_model))
    pos = torch.arange(8)[None]
    with pytest.raises(ValueError, match="sliding window"):
        attention.attention(model.blocks[2].mixer, cfg, x, pos,
                            impl="flash")


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
