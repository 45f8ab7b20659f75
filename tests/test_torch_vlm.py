"""Port qwen2-vl (attention bias, M-RoPE, the vision-embedding stub)
against the JAX package at reduced size.

Weights come from the JAX init, converted through numpy
(``params_from_jax``), so both packages compute with bit-identical
weights.  The reference initialises the attention biases to 0, which
would hide a bias added at the wrong place, so both sides get the same
random non-zero biases.  Inputs are made from a numpy seed; the three
M-RoPE sections get different positions over the vision tokens, as a
patch grid gives them.  ``attn_impl='pallas'`` runs the Pallas kernel
in interpret mode on the CPU; the port's ``'flash'`` runs its plain twin.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import traffic as jtraffic  # noqa: E402
from repro_torch.models import Model, common, convert  # noqa: E402
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

ARCH = "qwen2-vl-7b"
MAX_LEN = 48
PAGE = 8
POOL_STATS = ("hits", "misses", "spills", "fills", "shrinks", "hot_pages",
              "pinned_pages", "hot_bytes", "cold_bytes")


def _random_biases(params, seed):
    """The same tree with every attention bias drawn from N(0, 0.5^2)."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        if path[-1].key in ("bq", "bk", "bv"):
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


def _positions3(pos, n_vision):
    """(3,B,S): the first ``n_vision`` tokens are a patch grid 4 wide
    (temporal 0, height its row, width its column); the text after it
    counts on from the grid's row count, the same on all three
    sections."""
    p3 = np.stack([pos, pos, pos]).astype(np.int32)
    grid = np.arange(n_vision)
    p3[0, :, :n_vision] = 0
    p3[1, :, :n_vision] = grid // 4
    p3[2, :, :n_vision] = grid % 4
    p3[:, :, n_vision:] = pos[:, n_vision:] - n_vision + (n_vision // 4)
    return p3


def _inputs(cfg, b=2, s=16, n_vision=8, seed=0, vision=True):
    rng = np.random.default_rng(seed)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                 np.int32),
             "positions": pos,
             "positions3": _positions3(pos, n_vision)}
    if vision:
        mask = np.zeros((b, s), bool)
        mask[:, :n_vision] = True
        batch["vision_mask"] = mask
        batch["vision_embeds"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    return batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def test_apply_mrope_matches_per_section():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 10, 4, 32)).astype(np.float32)
    p3 = rng.integers(0, 500, (3, 2, 10)).astype(np.int32)
    want = np.asarray(jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(p3),
                                          1e6))
    got = common.apply_mrope(torch.from_numpy(x),
                             torch.from_numpy(p3).long(), 1e6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    assert common.MROPE_FRACS == jcommon.MROPE_FRACS
    # each row of positions3 turns its own section of the frequencies
    # (4, 6 and 6 of the 16 at D = 32), in both halves of D
    bounds = (0, 4, 10, 16)
    for i in range(3):
        moved = p3.copy()
        moved[i] += 7
        diff = (common.apply_mrope(torch.from_numpy(x),
                                   torch.from_numpy(moved).long(), 1e6)
                - got).abs().amax(dim=(0, 1, 2))
        turned = np.flatnonzero(diff.numpy()[:16] > 1e-6)
        assert turned.tolist() == list(range(bounds[i], bounds[i + 1]))
        np.testing.assert_array_equal(diff.numpy()[16:] > 1e-6,
                                      diff.numpy()[:16] > 1e-6)


@pytest.mark.parametrize("vision", [True, False])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_logits_match_f32(impl, vision):
    """impl 'pallas' is the slice's K5 path: no window, no kv_input."""
    jcfg, _, params, cfg, model = _pair()
    batch = _inputs(cfg, vision=vision)
    jm = get_model(dataclasses.replace(jcfg, attn_impl=impl))
    want, _ = jm.train_logits(params, _jbatch(batch))
    model.cfg = dataclasses.replace(cfg, attn_impl=convert.ATTN_IMPLS[impl])
    try:
        got, aux = model.train_logits(_tbatch(batch))
    finally:
        model.cfg = cfg
    assert got.shape == (2, 16, cfg.vocab_size) and aux == 0.0
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


def test_vision_stub_and_biases_reach_the_logits():
    _, _, _, cfg, model = _pair()
    with_v = model.prefill(_tbatch(_inputs(cfg)))
    without = model.prefill(_tbatch(_inputs(cfg, vision=False)))
    assert float((with_v - without).abs().max()) > 1e-2
    bias = model.blocks[0].mixer.bk
    assert float(bias.abs().min()) > 0


def test_decode_steps_match_logits_and_cache():
    """positions3 of each step differ across the sections; the temporal
    row picks the cache slot."""
    jcfg, jm, params, cfg, model = _pair()
    b, s, smax = 2, 10, 12
    batch = _inputs(cfg, b=b, s=s, n_vision=6, seed=3, vision=False)
    jcache, tcache = jm.init_cache(b, smax), model.init_cache(b, smax)
    decode = jax.jit(jm.decode_step)
    for t in range(s):
        step = {k: v[..., t:t + 1] for k, v in batch.items()}
        jl, jcache = decode(params, jcache, _jbatch(step))
        tl, tcache = model.decode_step(tcache, _tbatch(step))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=TOL_F32, atol=TOL_F32)
        for k in ("k", "v"):
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(jcache[k]),
                                       rtol=TOL_F32, atol=TOL_F32)


def test_param_count_matches_the_reference_tree():
    _, _, params, _, model = _pair()
    assert sum(v.numel() for v in model.state_dict().values()) == \
        sum(a.size for a in jax.tree.leaves(params))


def _scenario(tr, vocab, n=6, seed=1):
    cfg = dataclasses.replace(
        tr.TRAFFIC_MIXES["steady"], n_requests=n, max_len=MAX_LEN,
        vocab=vocab, deadline=400.0)
    return tr.generate(cfg, seed=seed)


@pytest.mark.parametrize("kv_mode", ["resident", "dispersed"])
def test_serve_token_identical_to_reference(kv_mode):
    """The engines add positions3 (the slot position on all three
    sections); dispersed mode pages k/v."""
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
        assert tstats["fills"] > 0 and tstats["hits"] > 0


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve as cli
    assert cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--requests", "3", "--max-new", "4"]) == 0
    assert "served 3/3 requests" in capsys.readouterr().out
