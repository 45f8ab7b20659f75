"""Port whisper (LayerNorm, GELU, sinusoidal positions, the encoder and
the decoder's cross-attention) against the JAX package at reduced size.

Weights come from the JAX init, converted through numpy
(``params_from_jax``), so both packages compute with bit-identical
weights.  The reference initialises every bias to 0 (attention, MLP,
LayerNorm), which would hide a bias added at the wrong place, so both
sides get the same random non-zero biases.  The audio frames and the
decode's encoder K/V (``ek``/``ev``) are drawn from a numpy seed.
``attn_impl='pallas'`` runs the encoder through the Pallas kernel in
interpret mode on the CPU; the port's ``'flash'`` runs its plain twin.
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
from repro.models import common as jcommon  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import traffic as jtraffic  # noqa: E402
from repro_torch.models import Model, attention, common, convert  # noqa: E402
from repro_torch.serve import ServeEngine, traffic  # noqa: E402


@pytest.fixture(autouse=True)
def _forward_only():
    """The model's parameters are trainable; these tests hold forward
    values, so they run without autograd (as prefill and decode do)."""
    with torch.no_grad():
        yield


# f32 logits and caches: the same arithmetic in another order, as
# tests/test_torch_model.py
TOL_F32 = 1e-4
# bf16 logits stay below 8, where one bf16 ulp is 2^-5; the frameworks
# round activations at other places, so two ulps are allowed, as
# tests/test_torch_model.py
TOL_BF16 = 2 * 2.0 ** -5

ARCH = "whisper-large-v3"
MAX_LEN = 48
PAGE = 8
POOL_STATS = ("hits", "misses", "spills", "fills", "shrinks", "hot_pages",
              "pinned_pages", "hot_bytes", "cold_bytes")
BIASES = ("bq", "bk", "bv", "bi", "bo", "bias")


def _random_biases(params, seed):
    """The same tree with every bias drawn from N(0, 0.5^2)."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if path[-1].key in BIASES:
            return jnp.asarray(0.5 * rng.standard_normal(a.shape), a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(draw, params)


@functools.lru_cache(maxsize=None)
def _pair(dtype="float32"):
    jcfg = dataclasses.replace(jreg.get(ARCH).reduced(), dtype=dtype)
    jm = get_model(jcfg)
    params = _random_biases(jm.init(jax.random.PRNGKey(0)), seed=9)
    cfg = convert.config_from_jax(jcfg)
    model = Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(
        cfg, jax.tree.map(np.asarray, params)))
    return jcfg, jm, params, cfg, model


def _inputs(cfg, b=2, s=12, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "positions": np.broadcast_to(np.arange(s, dtype=np.int32),
                                         (b, s)).copy(),
            "audio_embeds": rng.standard_normal(
                (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def test_sinusoids_match():
    pos = np.random.default_rng(1).integers(0, 1500, (2, 7)).astype(np.int32)
    want = np.asarray(jmodel._sinusoid_at(jnp.asarray(pos), 64))
    got = common.sinusoid_at(torch.from_numpy(pos).long(), 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    want = np.asarray(jcommon.sinusoidal_positions(40, 64))
    got = common.sinusoidal_positions(40, 64)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_logits_match_f32(impl):
    """impl 'pallas' takes the encoder (non-causal, 16 frames) through
    the kernel; the decoder always takes the plain path."""
    jcfg, _, params, cfg, model = _pair()
    batch = _inputs(cfg)
    jm = get_model(dataclasses.replace(jcfg, attn_impl=impl))
    want, _ = jm.train_logits(params, _jbatch(batch))
    model.cfg = dataclasses.replace(cfg, attn_impl=convert.ATTN_IMPLS[impl])
    try:
        got, aux = model.train_logits(_tbatch(batch))
    finally:
        model.cfg = cfg
    assert got.shape == (2, 12, cfg.vocab_size) and aux == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_F32,
                               atol=TOL_F32)


def test_prefill_logits_match_bf16():
    """bf16 weights and activations (the norms in f32, as in the
    reference): within two bf16 ulps of the reference's logits, and the
    same top-1 token on more than 90 %."""
    _, jm, params, cfg, model = _pair("bfloat16")
    batch = _inputs(cfg, seed=1)
    want = np.asarray(jm.train_logits(params, _jbatch(batch))[0],
                      np.float32)
    got = model.prefill(_tbatch(batch))
    assert got.dtype == torch.bfloat16
    assert np.abs(want).max() < 8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=TOL_BF16)
    assert (got.float().numpy().argmax(-1) == want.argmax(-1)).mean() > 0.9


def test_the_audio_reaches_the_logits():
    _, _, _, cfg, model = _pair()
    a, b = _inputs(cfg, seed=0), _inputs(cfg, seed=0)
    b["audio_embeds"] = _inputs(cfg, seed=1)["audio_embeds"]
    diff = model.prefill(_tbatch(a)) - model.prefill(_tbatch(b))
    assert float(diff.abs().max()) > 1e-2


def test_decode_steps_match_logits_and_cache():
    """The cache's encoder K/V are seeded; each step writes k/v at its
    position and reads ek/ev unchanged."""
    _, jm, params, cfg, model = _pair()
    b, s, smax = 2, 10, 12
    rng = np.random.default_rng(4)
    jcache, tcache = jm.init_cache(b, smax), model.init_cache(b, smax)
    for k in ("ek", "ev"):
        a = rng.standard_normal(tuple(jcache[k].shape)).astype(np.float32)
        jcache[k], tcache[k] = jnp.asarray(a), torch.from_numpy(a)
    batch = _inputs(cfg, b=b, s=s, seed=3)
    decode = jax.jit(jm.decode_step)
    for t in range(s):
        step = {k: batch[k][:, t:t + 1] for k in ("tokens", "positions")}
        jl, jcache = decode(params, jcache, _jbatch(step))
        tl, tcache = model.decode_step(tcache, _tbatch(step))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=TOL_F32, atol=TOL_F32)
        for k in ("k", "v", "ek", "ev"):
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(jcache[k]),
                                       rtol=TOL_F32, atol=TOL_F32)


def test_decode_cross_attention_matches():
    jcfg, _, params, cfg, model = _pair()
    jp = jax.tree.map(lambda a: a[0], params["decoder"]["cross"])
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    ek, ev = (rng.standard_normal((3, cfg.encoder_seq, cfg.num_kv_heads,
                                   cfg.head_dim)).astype(np.float32)
              for _ in range(2))
    want = jattention.decode_cross_attention(jp, jcfg, jnp.asarray(x),
                                             jnp.asarray(ek), jnp.asarray(ev))
    got = attention.decode_cross_attention(
        model.decoder[0].cross, cfg, torch.from_numpy(x),
        torch.from_numpy(ek), torch.from_numpy(ev))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_F32,
                               atol=TOL_F32)


def test_flash_refuses_cross_attention():
    """The reference asserts ``kv_input is None`` before its kernel."""
    _, _, _, cfg, model = _pair()
    x = torch.zeros((1, 4, cfg.d_model))
    enc = torch.zeros((1, cfg.encoder_seq, cfg.d_model))
    with pytest.raises(ValueError, match="cross-attention"):
        attention.attention(model.decoder[0].cross, cfg, x, None,
                            causal=False, kv_input=enc, impl="flash")


def test_param_count_matches_the_reference_tree():
    _, _, params, _, model = _pair()
    sd = model.state_dict()
    assert sum(v.numel() for v in sd.values()) == \
        sum(a.size for a in jax.tree.leaves(params))
    assert "enc_norm.bias" in sd and "decoder.1.norm_x.scale" in sd


def _scenario(tr, vocab, n=6, seed=1):
    cfg = dataclasses.replace(
        tr.TRAFFIC_MIXES["steady"], n_requests=n, max_len=MAX_LEN,
        vocab=vocab, deadline=400.0)
    return tr.generate(cfg, seed=seed)


@pytest.mark.parametrize("kv_mode", ["resident", "dispersed"])
def test_serve_token_identical_to_reference(kv_mode):
    """Both engines leave ek/ev as the model's init_cache made them
    (zeros, reset on admission); dispersed mode pages k/v and keeps
    ek/ev unpaged."""
    jcfg, jm, params, cfg, model = _pair()
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
        assert te._paged == je._paged == ("k", "v")
        assert te._unpaged == ("ek", "ev")
        assert tstats["fills"] > 0 and tstats["hits"] > 0


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve as cli
    assert cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--requests", "3", "--max-new", "4"]) == 0
    assert "served 3/3 requests" in capsys.readouterr().out
