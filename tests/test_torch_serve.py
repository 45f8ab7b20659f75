"""Port serving stack against the JAX one at reduced size.

Both engines get the same f32 weights (converted through numpy) and the
same seeded scenario; at temperature 0 they must emit the same tokens and
drive their KV pools through the same hits, misses, fills and spills.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core import policies as jpolicies  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve import slo as jslo  # noqa: E402
from repro.serve import traffic as jtraffic  # noqa: E402
from repro_torch.core import policies as tpolicies  # noqa: E402
from repro_torch.models import Model, convert  # noqa: E402
from repro_torch.serve import (DispersedKVPool, PagePoolConfig,  # noqa: E402
                               Request, ServeEngine, chaos, slo, traffic)

MAX_LEN = 48
PAGE = 8
POOL_STATS = ("hits", "misses", "spills", "fills", "shrinks", "hot_pages",
              "pinned_pages", "hot_bytes", "cold_bytes")


@functools.lru_cache(maxsize=None)
def _built():
    jcfg = dataclasses.replace(jreg.get("phi3-mini-3.8b").reduced(),
                               dtype="float32")
    jm = get_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = convert.config_from_jax(jcfg)
    model = Model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(
        cfg, jax.tree.map(np.asarray, params)))
    return jcfg, jm, params, jax.jit(jm.decode_step), cfg, model


def _engines(**kw):
    jcfg, jm, params, decode, cfg, model = _built()
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    if kw.get("kv_mode") == "dispersed":
        kw.setdefault("page_size", PAGE)
    je = JServeEngine(jcfg, params, model=jm, decode_fn=decode, **kw)
    te = ServeEngine(cfg, model, device="cpu", **kw)
    return je, te


def _scenario(tr=traffic, n=6, seed=1, deadline=400.0):
    """The same seeded steady scenario from either package's generator."""
    cfg = dataclasses.replace(
        tr.TRAFFIC_MIXES["steady"], n_requests=n, max_len=MAX_LEN,
        vocab=_built()[4].vocab_size, deadline=deadline)
    return tr.generate(cfg, seed=seed)


def test_traffic_scenarios_match_reference():
    for name in traffic.TRAFFIC_MIXES:
        t = traffic.generate(dataclasses.replace(
            traffic.TRAFFIC_MIXES[name], n_requests=24), seed=3)
        j = jtraffic.generate(dataclasses.replace(
            jtraffic.TRAFFIC_MIXES[name], n_requests=24), seed=3)
        assert [dataclasses.astuple(s) for s in t.arrivals] == \
            [dataclasses.astuple(s) for s in j.arrivals]


@pytest.mark.parametrize("kv_mode", ["resident", "dispersed"])
def test_serve_token_identical_to_reference(kv_mode):
    je, te = _engines(kv_mode=kv_mode)
    jreqs = je.serve(_scenario(jtraffic))
    treqs = te.serve(_scenario())
    assert [r.status for r in treqs] == [r.status for r in jreqs]
    assert all(r.status == "done" for r in treqs)
    for j, t in zip(jreqs, treqs):
        assert t.rid == j.rid and t.out == j.out, f"rid {t.rid} diverged"
        assert t.token_times == j.token_times
    jstats, tstats = je.kv_stats(), te.kv_stats()
    assert {k: tstats[k] for k in POOL_STATS if k in tstats} == \
        {k: jstats[k] for k in POOL_STATS if k in jstats}
    if kv_mode == "dispersed":
        assert tstats["fills"] > 0 and tstats["hits"] > 0
    assert slo.summarize(te, treqs).to_row() == \
        jslo.summarize(je, jreqs).to_row()


def test_chaos_run_bit_identical_to_fault_free():
    """The port's own chaos acceptance, after test_serving.py's."""
    scen = _scenario()
    hot = 12
    _, e0 = _engines(kv_mode="dispersed", hot_pages=hot)
    free = e0.serve(scen)
    assert all(r.status == "done" for r in free)

    profile = chaos.FAULT_PROFILES["chaos"](scen.horizon + 60, 2, hot,
                                            seed=0)
    kinds = {e.kind for e in profile.events}
    assert kinds == {"latency_spike", "slot_fail", "mem_pressure"}
    _, e1 = _engines(kv_mode="dispersed", hot_pages=hot)
    inj = chaos.FaultInjector(profile)
    hit = e1.serve(scen, chaos=inj)
    assert {e.kind for e in inj.applied} == kinds
    assert e1.pool.shrinks == 1
    assert all(r.status == "done" for r in hit)
    by_rid = {r.rid: r for r in free}
    for r in hit:
        assert r.out == by_rid[r.rid].out, (
            f"rid {r.rid} diverged under chaos (preemptions="
            f"{r.preemptions})")
    rep = slo.summarize(e1, hit)
    assert rep.n_done == len(hit)
    assert rep.degraded_ticks > 0
    assert rep.p99_decode_ticks >= rep.p50_decode_ticks > 0


@pytest.mark.parametrize("kv_mode", ["resident", "dispersed"])
def test_preempted_request_resumes_bit_identically(kv_mode):
    _, ref = _engines(slots=1)
    r_ref = Request(prompt=[5, 6, 7], max_new_tokens=8)
    ref.run([r_ref])
    assert r_ref.done
    _, eng = _engines(slots=1, kv_mode=kv_mode)
    req = Request(prompt=[5, 6, 7], max_new_tokens=8)
    assert eng.submit(req)
    for _ in range(5):
        eng.step()
    assert len(req.out) > 0 and not req.done
    eng.preempt(0)
    assert req.status == "preempted" and eng.active[0] is None
    eng._admit_from_queue(eng.clock.now)
    assert req.status == "running"
    while not req.done:
        eng.step()
    assert req.out == r_ref.out
    assert req.preemptions == 1


def test_pool_round_trip_and_shrink_preserve_pages():
    pool = DispersedKVPool(PagePoolConfig(
        num_logical_pages=12, num_hot_pages=4, page_shape=(6,)),
        device="cpu")
    want = {p: torch.full((6,), 1.0 + p * 0.125, dtype=torch.bfloat16)
            for p in range(12)}
    for p, v in want.items():
        pool.write(p, v)
    assert pool.spills > 0
    got = pool.read(3)
    got += 1                                  # a copy, not a view
    for p, v in want.items():
        assert torch.equal(pool.read(p), v), f"page {p} corrupted"
    pool = DispersedKVPool(PagePoolConfig(
        num_logical_pages=16, num_hot_pages=8, page_shape=(6,)),
        device="cpu")
    for p in range(8):
        pool.write(p, torch.full((6,), 2.0 + p))
    pool.shrink(4)
    assert pool.hot.shape[0] == 4 and pool.shrinks == 1
    for p in range(8):
        assert torch.equal(pool.read(p),
                           torch.full((6,), 2.0 + p, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        pool.shrink(2)


@pytest.mark.parametrize("policy", sorted(tpolicies.POLICY_NAMES))
def test_np_select_victim_matches_reference(policy):
    rng = np.random.default_rng(policy)
    for _ in range(200):
        n = int(rng.integers(3, 12))
        tags = rng.integers(-1, 20, n)
        tags[0] = 5                            # at least one candidate
        pinned = rng.random(n) < 0.2
        pinned[0] = False
        cols = [rng.integers(0, 50, n) for _ in range(4)]
        locked = tuple(int(t) for t in rng.choice(tags, 1) if t != 5)
        args = (tags, *cols, pinned, n, policy)
        assert tpolicies.np_select_victim(*args, locked=locked) == \
            jpolicies.np_select_victim(*args, locked=locked)
    assert tpolicies.POLICY_NAMES == jpolicies.POLICY_NAMES


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is satisfiable")
    cfg, model = _built()[4:]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DispersedKVPool(PagePoolConfig(num_logical_pages=4, num_hot_pages=3,
                                       page_shape=(2,)))


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve as cli
    assert cli.main(["--reduced", "--device", "cpu", "--requests", "3",
                     "--max-new", "4"]) == 0
    assert "served 3/3 requests" in capsys.readouterr().out
