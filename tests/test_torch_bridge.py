"""The port's bridge (``repro_torch.bridge``) and its ``network_sweep``
suite against the reference's, on the CPU.

- ``model_ops``: for all ten registry models the port's LayerOps (read
  from its block modules built on the ``meta`` device) equal the
  reference's (read through ``jax.eval_shape``): kind, label, shape and
  count, in order.
- Lowering: for every unique signature of those models the port's tile
  program equals the reference's row for row (``op, vd, vs1, vs2, addr,
  imm, cost_override``) with the same memory image, and its kernel name,
  build kwargs and macro factor are the reference's.
- The reference's own laws, on the port: the certification truth table
  of ``tests/test_bridge.py`` on the port's ``folding``, ``repeat``
  emission equal to the unrolled one (seeded, and with hypothesis where
  it is installed), lawful dedup.
- One small ``network_sweep`` (two models, two capacities, one L1
  geometry) through the port's ``Session.run`` (K1's plain twin) and the
  reference's: every row equal, the float totals bit for bit (the
  port's ``network_report`` sums in the reference's order).

Lowering registers ``net:*`` kernels in both registries; each test that
lowers removes them again (``clean_registries``), because other test
files read the registries at run time.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYP = True
except ImportError:                                   # pragma: no cover
    HAVE_HYP = False

from repro import api as japi  # noqa: E402
from repro import bridge as jbridge  # noqa: E402
from repro import rvv as jrvv  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import bridge as tbridge  # noqa: E402
from repro_torch import rvv as trvv  # noqa: E402
from repro_torch.bridge import lower as tlower  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import folding, isa  # noqa: E402

MODELS = sorted(treg.ARCHS)
ROW_FIELDS = ("op", "vd", "vs1", "vs2", "addr", "imm", "cost_override")
PIN_SETS, PIN_WAYS = 64, 2
PIN_WARM = folding.warm_lines_for(PIN_SETS, PIN_WAYS)
BUILDERS = {"gemm": "build_gemm", "attn": "build_attn", "scan": "build_scan"}

# The small sweep: a Mamba model (gemm + scan kernels) and the hybrid
# (gemm, attn and scan), 13 kernels at two capacities and the 4 KB L1.
SMALL_MODELS = ("recurrentgemma-2b", "falcon-mamba-7b")
SMALL_CAPS = (3, 8)
SMALL_L1_KB = (4,)


@pytest.fixture
def clean_registries():
    """Drop the ``net:*`` kernels a test registers from both packages'
    registries when it ends."""
    before = {id(r): set(r) for r in (trvv.BENCHMARKS, jrvv.BENCHMARKS)}
    yield
    for reg in (trvv.BENCHMARKS, jrvv.BENCHMARKS):
        for name in set(reg) - before[id(reg)]:
            del reg[name]


def _op_tuple(op):
    return (op.kind, op.label, tuple(op.shape), op.count)


def _same_program(got, want):
    for f in ROW_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    np.testing.assert_array_equal(got.memory, want.memory)


def test_registry_names_agree():
    assert MODELS == sorted(jreg.ARCHS)


@pytest.mark.parametrize("model", MODELS)
def test_model_ops_equal_reference(model):
    got = [_op_tuple(o) for o in tbridge.model_ops(model)]
    want = [_op_tuple(o) for o in jbridge.model_ops(model)]
    assert got == want
    for g, w in zip(tbridge.model_ops(model), jbridge.model_ops(model)):
        assert g.signature == w.signature and g.work == w.work


def test_shapes_need_no_parameter_memory():
    """The blocks are built on the meta device: no storage behind them;
    their weights come in jax.tree_util's order of the reference's
    dict."""
    from repro_torch.bridge import shapes
    from repro_torch.models.mlp import MoE
    cfg = treg.get("phi3.5-moe-42b-a6.6b")
    assert all(p.is_meta for p in MoE(cfg, torch.float32,
                                      "meta").parameters())
    ws = shapes._weight_shapes(MoE, cfg)
    # jax.tree_util's order of the reference's dict: router, then the
    # 3-D experts sorted by key; the label is the leaf's last key
    assert [n for n, _ in ws] == ["router", "wg", "wi", "wo"]
    assert ws[1][1] == (cfg.num_experts, cfg.d_model, cfg.moe_d_ff)
    ds = shapes._weight_shapes(MoE, treg.get("deepseek-v2-lite-16b"))
    assert [n for n, _ in ds] == ["router", "wg", "wi", "wo", "wg", "wi",
                                  "wo"]


@pytest.mark.parametrize("model", MODELS)
def test_tile_programs_equal_reference(model, clean_registries):
    """Every unique signature of the model lowers to the reference's
    kernel name, kwargs, macro factor and program, bit for bit."""
    tnet = tbridge.lower_network(model)
    jnet = jbridge.lower_network(model)
    assert len(tnet.units) == len(jnet.units)
    for tu, ju in zip(tnet.units, jnet.units):
        assert (tu.kernel, tu.kind, tu.labels, tuple(tu.shape), tu.count,
                tu.params) == (ju.kernel, ju.kind, ju.labels,
                               tuple(ju.shape), ju.count, ju.params)
        assert tu.macro_factor == ju.macro_factor
        got = getattr(tbridge, BUILDERS[tu.kind])(**tu.params).program
        want = getattr(jbridge, BUILDERS[ju.kind])(**ju.params).program
        _same_program(got, want)
        tb, jb = trvv.BENCHMARKS[tu.kernel], jrvv.BENCHMARKS[ju.kernel]
        assert (tb.domain, tb.paper_params, tb.reduced_params,
                tb.table2) == (jb.domain, jb.paper_params,
                               jb.reduced_params, jb.table2)
        assert dataclasses.astuple(tb.scalar_cost(**tb.paper_params)) == \
            dataclasses.astuple(jb.scalar_cost(**jb.paper_params))
    assert tnet.summary() == jnet.summary()


# The reference's certification truth table (tests/test_bridge.py)
CERT_TRUTH = {
    "granite-8b": {"gemm": True, "attn": True},
    "falcon-mamba-7b": {"gemm": True, "scan": True},
    "recurrentgemma-2b": {"gemm": True, "attn": True, "scan": True},
    "deepseek-v2-lite-16b": {"gemm": True, "attn": True},
}


@pytest.mark.parametrize("model", sorted(CERT_TRUTH))
def test_certification_truth_table(model, clean_registries):
    net = tbridge.lower_network(model)
    by_kind: dict = {}
    for u in net.units:
        by_kind.setdefault(u.kind, u)
    assert set(by_kind) == set(CERT_TRUTH[model]), model
    for kind, want in sorted(CERT_TRUTH[model].items()):
        p = getattr(tbridge, BUILDERS[kind])(**by_kind[kind].params).program
        plan = folding.plan(p, warm_lines=PIN_WARM)
        assert (plan is not None and plan.certifiable) == want, \
            (model, kind, by_kind[kind].kernel)


def test_lowering_is_deduplicated_and_scaled(clean_registries):
    net = tbridge.lower_network("deepseek-v2-lite-16b")
    sigs = [(u.kind,) + u.shape for u in net.units]
    assert len(sigs) == len(set(sigs))
    assert len(net.kernels) == len(net.units) < net.num_instances
    assert all(u.macro_factor > 0 for u in net.units)
    assert all(u.labels for u in net.units)


GEMM_SHAPES = [(1, 1, 1, 8), (2, 2, 16, 16), (3, 1, 7, 24), (2, 3, 5, 8),
               (4, 2, 33, 16)]
SCAN_SHAPES = [(1, 8), (3, 64), (7, 24), (12, 128)]


def _check_gemm_unroll(tiles, mt, k, n):
    rolled = tbridge.build_gemm(tiles=tiles, mt=mt, k=k, n=n)
    flat = tbridge.build_gemm(tiles=tiles, mt=mt, k=k, n=n, unroll=True)
    _same_program(rolled.program, flat.program)
    assert not flat.program.repeats
    if max(tiles, mt, k, n // isa.VL_ELEMS) > 1:
        assert rolled.program.repeats
    _same_program(rolled.program, jbridge.build_gemm(
        tiles=tiles, mt=mt, k=k, n=n).program)


def _check_scan_unroll(steps, width):
    rolled = tbridge.build_scan(steps=steps, width=width)
    flat = tbridge.build_scan(steps=steps, width=width, unroll=True)
    _same_program(rolled.program, flat.program)
    assert not flat.program.repeats
    if max(steps, width // isa.VL_ELEMS) > 1:
        assert rolled.program.repeats
    _same_program(rolled.program, jbridge.build_scan(
        steps=steps, width=width).program)


@pytest.mark.parametrize("tiles,mt,k,n", GEMM_SHAPES)
def test_gemm_repeat_equals_unrolled(tiles, mt, k, n):
    _check_gemm_unroll(tiles, mt, k, n)


@pytest.mark.parametrize("steps,width", SCAN_SHAPES)
def test_scan_repeat_equals_unrolled(steps, width):
    _check_scan_unroll(steps, width)


if HAVE_HYP:

    @settings(max_examples=20, deadline=None)
    @given(tiles=st.integers(1, 4), mt=st.integers(1, 3),
           k=st.integers(1, 40), n=st.integers(1, 4).map(lambda c: 8 * c))
    def test_gemm_repeat_equals_unrolled_hyp(tiles, mt, k, n):
        _check_gemm_unroll(tiles, mt, k, n)

    @settings(max_examples=20, deadline=None)
    @given(steps=st.integers(1, 10),
           width=st.integers(1, 24).map(lambda c: 8 * c))
    def test_scan_repeat_equals_unrolled_hyp(steps, width):
        _check_scan_unroll(steps, width)


def _random_op(g):
    kind = ("gemm", "attn", "scan")[g.integers(3)]
    if kind == "gemm":
        shape = (int(g.integers(1, 8192)), int(g.integers(1, 8192)))
    elif kind == "attn":
        shape = (int(g.integers(1, 64)), int(g.integers(8, 256)))
    else:
        shape = (int(g.integers(1, 16384)),)
    return tbridge.LayerOp(kind, f"layer{g.integers(1000)}", shape,
                           int(g.integers(1, 64)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_never_merges_different_programs(seed):
    """tile_for is a pure function of the signature, and the reference's:
    equal signatures share one name and kwargs, different ones never
    share a name."""
    from repro.bridge import LayerOp as JLayerOp
    from repro.bridge import lower as jlower
    g = np.random.default_rng(seed)
    ops = [_random_op(g) for _ in range(40)]
    by_name: dict = {}
    for op in ops:
        name, kwargs, macro = tlower.tile_for(op)
        assert macro > 0
        assert (name, kwargs, macro) == jlower.tile_for(
            JLayerOp(op.kind, op.label, op.shape, op.count))
        prev = by_name.setdefault(name, (op.signature, kwargs))
        assert prev == (op.signature, kwargs), name
    names = {op.signature: tlower.tile_for(op)[0] for op in ops}
    assert len(set(names.values())) == len(names)


def test_lowering_runs_only_when_asked(clean_registries):
    """Importing the bridge registers nothing; lowering twice registers
    once (exist_ok) and the registered build is deterministic."""
    assert not [n for n in trvv.BENCHMARKS if n.startswith("net:")]
    a = tbridge.lower_network("granite-8b")
    n = len(trvv.BENCHMARKS)
    assert tbridge.lower_network("granite-8b") == a
    assert len(trvv.BENCHMARKS) == n
    u = next(u for u in a.units if u.kind == "gemm")
    assert trvv.BENCHMARKS[u.kernel].domain == "network"
    _same_program(tbridge.build_gemm(**u.params).program,
                  tbridge.build_gemm(**u.params).program)


@functools.lru_cache(maxsize=None)
def _small_sweeps():
    """The small network_sweep through both packages (rows and extras);
    the net:* kernels it registers are removed again."""
    from benchmarks import network_sweep as jns
    from repro_torch.benchmarks import network_sweep as tns
    before = {id(r): set(r) for r in (trvv.BENCHMARKS, jrvv.BENCHMARKS)}
    try:
        kw = dict(models=SMALL_MODELS, caps=SMALL_CAPS,
                  l1_kbytes=SMALL_L1_KB)
        got = tns.run(session=tapi.Session(device="cpu"), **kw)
        got_extra = tns.json_extra()
        want = jns.run(session=japi.Session(), **kw)
        want_extra = jns.json_extra()
    finally:
        for reg in (trvv.BENCHMARKS, jrvv.BENCHMARKS):
            for name in set(reg) - before[id(reg)]:
                del reg[name]
    return got, got_extra, want, want_extra


def test_small_network_sweep_rows_bit_equal_reference():
    got, _, want, _ = _small_sweeps()
    assert len(got) == len(want) == len(SMALL_MODELS) * len(SMALL_CAPS)
    for g, w in zip(got, want):
        g, w = dict(g), dict(w)
        g.pop("us_per_call"), w.pop("us_per_call")
        assert g == w
        for key in ("cycles_total", "energy_total"):
            assert type(g[key]) is float
            assert g[key].hex() == w[key].hex(), key


def test_small_network_sweep_extra_and_plan():
    """networks, points and the fold certificate equal the reference's;
    the port's record counts one engine call for the one geometry and
    carries launches, not the reference's compiles or bucket groups."""
    _, got, _, want = _small_sweeps()
    for key in ("networks", "points", "fold_exact_fraction"):
        assert got[key] == want[key], key
    assert got["fold_exact_fraction"] == 1.0
    assert got["dispatches"] == len(SMALL_L1_KB)
    assert set(got["launches"]) == {"engine_reg", "engine_l1",
                                    "cluster_l2"}
    assert not any(got["launches"].values())          # the CPU launches none
    assert "compiles" not in got and "plan_groups" not in got
    assert set(got) == {"networks", "points", "dispatches", "launches",
                        "fold_exact_fraction", "rows"}
