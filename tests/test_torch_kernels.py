"""Port K3, K4, K6 (and K5 on int8) against the JAX Pallas kernels.

On the CPU the port's wrappers run each kernel's plain twin; the JAX side
runs the Pallas kernel in interpret mode, as tests/test_kernels_allclose.py
does.  Inputs are made with numpy from a seed and handed to both.  The
traffic counts and closed forms are integers and must be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import dispersed_gemm as jdg  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import rmsnorm as jrn  # noqa: E402
from repro.kernels import traffic as jtraffic  # noqa: E402
from repro_torch.kernels import dispersed_gemm as tdg  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.kernels import traffic as ttraffic  # noqa: E402

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "int8": torch.int8}


def _inputs(seed, shapes, dtype):
    """Seeded numpy inputs for both sides: standard normal for floats,
    integers in [-4, 4] for int8 (so products over k = 256..512 both
    saturate int8 and stay inside it)."""
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        arrs = [rng.integers(-4, 5, s).astype(np.int8) for s in shapes]
        return ([jnp.asarray(a) for a in arrs],
                [torch.from_numpy(a) for a in arrs])
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _assert_matches(got, want, dtype):
    """f32: 1e-4 abs + 1e-5 rel (another f32 summation order).  bf16: one
    bf16 ulp of the output, or 1e-4 absolute for outputs near 0, where the
    f32 summation order alone moves the value by more than an ulp.
    int8: bit-exact, saturation included."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    if dtype == "int8":
        assert g.dtype == w.dtype == np.int8
        np.testing.assert_array_equal(g, w)
    elif dtype == "bfloat16":
        err = np.abs(g.astype(np.float64) - w)
        assert (err <= np.maximum(_bf16_ulp(w), 1e-4)).all(), err.max()
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)


GEMM_SHAPES = [(256, 512, 128), (512, 256, 256)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("w", [1, 2, 4])
@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_grouped_matches_pallas(m, k, n, w, dtype):
    (ja, jb), (ta, tb) = _inputs(m + k + n, [(m, k), (k, n)], dtype)
    kw = dict(block_m=128, block_k=256, working_set=w)
    want = jdg.matmul_grouped(ja, jb, interpret=True, **kw)
    got = tdg.matmul_grouped(ta, tb, **kw)
    assert got.dtype == TDT[dtype]
    _assert_matches(got, want, dtype)
    assert torch.equal(tops.matmul(ta, tb, **kw), got)
    if dtype == "int8":        # the inputs reach both sides of the clamp
        w_np = _np(want)
        assert (np.abs(w_np) == 127).any() | (w_np == -128).any()
        assert (np.abs(w_np) < 127).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_dispersed_matches_pallas(m, k, n, dtype):
    (ja, jb), (ta, tb) = _inputs(m * 3 + n, [(m, k), (k, n)], dtype)
    want = jdg.matmul_dispersed(ja, jb, block_m=128, block_k=128,
                                interpret=True)
    got = tdg.matmul_dispersed(ta, tb, block_m=128, block_k=128)
    assert got.dtype == TDT[dtype]
    _assert_matches(got, want, dtype)
    assert torch.equal(tops.matmul_dispersed(ta, tb, block_m=128,
                                             block_k=128), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_grouped_bitwise_independent_of_working_set(dtype):
    _, (ta, tb) = _inputs(3, [(256, 512), (512, 128)], dtype)
    outs = [tdg.matmul_grouped(ta, tb, block_m=64, block_k=128,
                               working_set=w) for w in (1, 2, 4)]
    for other in outs[1:]:
        assert torch.equal(outs[0], other)


def test_cast_like_saturates_toward_zero_as_jax():
    x = np.array([-300.7, -128.9, -1.5, -0.5, 0.7, 126.99, 200.2, 1000.0],
                 np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.int8))
    got = tref.cast_like(torch.from_numpy(x), torch.int8).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[[0, 6, 7]], [-128, 127, 127])


@pytest.mark.parametrize("causal", [False, True])
def test_ref_oracles_match_jax(causal):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        9, [(1, 2, 64, 32), (1, 2, 128, 32), (1, 2, 128, 32)], "float32")
    np.testing.assert_allclose(
        _np(tref.attention_ref(tq, tk, tv, causal=causal)),
        _np(jref.attention_ref(jq, jk, jv, causal=causal)),
        rtol=2e-5, atol=2e-5)
    (ja, jb), (ta, tb) = _inputs(10, [(64, 256), (256, 32)], "int8")
    np.testing.assert_array_equal(_np(tref.matmul_ref(ta, tb)),
                                  _np(jref.matmul_ref(ja, jb)))


@pytest.mark.parametrize("rows,d,dtype", [(256, 512, "float32"),
                                          (128, 1024, "bfloat16")])
def test_rmsnorm_matches_pallas(rows, d, dtype):
    (jx,), (tx,) = _inputs(rows + d, [(2, rows // 2, d)], dtype)
    rng = np.random.default_rng(d)
    scale = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    want = jrn.rmsnorm(jx, jnp.asarray(scale), block_rows=64,
                       interpret=True)
    got = trn.rmsnorm(tx, torch.from_numpy(scale), block_rows=64)
    assert got.dtype == TDT[dtype] and got.shape == tx.shape
    if dtype == "bfloat16":    # f32 on both sides, one rounding to bf16
        err = np.abs(_np(got).astype(np.float64) - _np(want))
        assert (err <= _bf16_ulp(_np(want))).all(), err.max()
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)


def test_rmsnorm_raises_value_error_where_reference_asserts():
    (jx,), (tx,) = _inputs(0, [(96, 64)], "float32")
    scale = np.ones(64, np.float32)
    with pytest.raises(AssertionError):
        jrn.rmsnorm(jx, jnp.asarray(scale), block_rows=64, interpret=True)
    with pytest.raises(ValueError, match="rows=96 is not divisible by "
                                         "block_rows=64"):
        trn.rmsnorm(tx, torch.from_numpy(scale), block_rows=64)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_int8_bit_exact_against_pallas(causal):
    """int8 q/k/v: both sides compute in f32 and truncate the output
    toward zero with saturation, so the int8 outputs are equal."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(21, [(1, 2, 128, 64)] * 3, "int8")
    want = jfa.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                               block_k=64, interpret=True)
    got = tfa.flash_attention(tq, tk, tv, causal=causal, block_q=64,
                              block_k=64)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(_np(got), _np(want))


# -- traffic counts and closed forms: integers, equal to the reference --

GEMM_GEOMS = [(256, 128, 512, 64, 128), (512, 256, 256, 128, 256),
              (1024, 384, 768, 128, 128), (128, 64, 512, 256, 512)]


@pytest.mark.parametrize("bpe", [1, 2, 4])
@pytest.mark.parametrize("m,n,k,bm,bk", GEMM_GEOMS)
def test_gemm_traffic_equals_reference(m, n, k, bm, bk, bpe):
    nm = m // min(bm, m)
    for w in [d for d in (1, 2, 4, 8) if d <= nm and nm % d == 0]:
        kw = dict(block_m=bm, block_k=bk, working_set=w, bytes_per_el=bpe)
        assert (tdg.hbm_traffic_model(m, n, k, **kw)
                == jdg.hbm_traffic_model(m, n, k, **kw))
        assert tops.hbm_traffic_model is tdg.hbm_traffic_model
        assert (ttraffic.count(tops.grouped_schedule(m, n, k, **kw))
                == jtraffic.count(jops.grouped_schedule(m, n, k, **kw)))
        if k > bk:      # see test_grouped_model_overcounts_b_on_one_k_step
            assert (ttraffic.count(tdg.grouped_schedule(m, n, k, **kw))
                    ["total"] == tdg.hbm_traffic_model(m, n, k,
                                                       **kw)["grouped"])
    kw = dict(block_m=bm, block_k=bk, bytes_per_el=bpe)
    counted = ttraffic.count(tops.dispersed_schedule(m, n, k, **kw))
    assert counted == jtraffic.count(jops.dispersed_schedule(m, n, k, **kw))
    assert counted["total"] == tdg.hbm_traffic_model(
        m, n, k, working_set=1, **kw)["dispersed"]


@pytest.mark.parametrize("bpe", [1, 2, 4])
@pytest.mark.parametrize("b,h,sq,sk,d,bq,bk", [
    (1, 2, 256, 256, 64, 64, 64), (2, 2, 128, 256, 32, 64, 128),
    (1, 4, 512, 128, 128, 128, 64)])
def test_flash_traffic_equals_reference(b, h, sq, sk, d, bq, bk, bpe):
    kw = dict(block_q=bq, block_k=bk, bytes_per_el=bpe)
    model = tops.flash_traffic_model(b, h, sq, sk, d, **kw)
    assert model == jops.flash_traffic_model(b, h, sq, sk, d, **kw)
    counted = ttraffic.count(tops.flash_schedule(b, h, sq, sk, d, **kw))
    assert counted == jtraffic.count(jops.flash_schedule(b, h, sq, sk, d,
                                                         **kw))
    assert counted["total"] == model["flash"]


def test_grouped_model_overcounts_b_on_one_k_step():
    """A fault of the reference, kept as it is: with one k step (k ==
    block_k) the B panel's block index never changes, so the schedule
    fetches B once, but the closed form charges it once per group.  The
    port's count and model equal the reference's, fault included."""
    kw = dict(block_m=128, block_k=256, working_set=1, bytes_per_el=2)
    model = tdg.hbm_traffic_model(512, 256, 256, **kw)
    counted = ttraffic.count(tdg.grouped_schedule(512, 256, 256, **kw))
    assert model == jdg.hbm_traffic_model(512, 256, 256, **kw)
    assert counted == jtraffic.count(jdg.grouped_schedule(512, 256, 256,
                                                          **kw))
    groups = 512 // 128
    assert model["grouped"] - counted["total"] == (groups - 1) * 256 * 256 * 2


def test_traffic_part_kind_error_matches_reference():
    with pytest.raises(ValueError) as want:
        jtraffic.Part("x", 4, lambda i: (i,), "bogus")
    with pytest.raises(ValueError) as got:
        ttraffic.Part("x", 4, lambda i: (i,), "bogus")
    assert str(got.value) == str(want.value)


# -- illegal tilings and working sets raise the reference's messages --

BAD_GEMMS = [  # (a shape, b shape, block_m, block_k, working_set)
    ((200, 512), (512, 128), 128, 128, 1),      # m not divisible
    ((256, 512), (256, 128), 128, 128, 1),      # contraction mismatch
    ((256, 500), (500, 128), 128, 128, 1),      # k not divisible
    ((256, 512), (512, 128), 64, 128, 3),       # W does not divide nm
    ((256, 512), (512, 128), 64, 128, 0),       # W < 1
    ((256, 512), (512, 128), 0, 128, 1),        # block_m not positive
]


@pytest.mark.parametrize("a_shape,b_shape,bm,bk,w", BAD_GEMMS)
def test_gemm_errors_match_reference(a_shape, b_shape, bm, bk, w):
    (ja, jb), (ta, tb) = _inputs(0, [a_shape, b_shape], "float32")
    pairs = [
        (lambda: jdg.matmul_grouped(ja, jb, block_m=bm, block_k=bk,
                                    working_set=w, interpret=True),
         lambda: tdg.matmul_grouped(ta, tb, block_m=bm, block_k=bk,
                                    working_set=w)),
        (lambda: jops.matmul(ja, jb, block_m=bm, block_k=bk,
                             working_set=w, interpret=True),
         lambda: tops.matmul(ta, tb, block_m=bm, block_k=bk,
                             working_set=w)),
    ]
    m, k = a_shape
    n = b_shape[1]
    if a_shape[1] == b_shape[0]:
        pairs.append((
            lambda: jdg.hbm_traffic_model(m, n, k, block_m=bm, block_k=bk,
                                          working_set=w),
            lambda: tdg.hbm_traffic_model(m, n, k, block_m=bm, block_k=bk,
                                          working_set=w)))
        pairs.append((
            lambda: jdg.grouped_schedule(m, n, k, block_m=bm, block_k=bk,
                                         working_set=w),
            lambda: tdg.grouped_schedule(m, n, k, block_m=bm, block_k=bk,
                                         working_set=w)))
    if w >= 1:
        pairs.append((
            lambda: jdg.matmul_dispersed(ja, jb, block_m=bm, block_k=bk,
                                         interpret=True),
            lambda: tdg.matmul_dispersed(ta, tb, block_m=bm, block_k=bk)))
    raised = 0
    for ref_fn, port_fn in pairs:
        try:
            ref_fn()
        except ValueError as e:
            want = str(e)
        else:
            want = None
        if want is None:
            port_fn()                   # legal for the reference: legal here
            continue
        with pytest.raises(ValueError) as got:
            port_fn()
        assert str(got.value) == want
        raised += 1
    assert raised >= 1


# -- dispatch: CPU tensors take the plain twins, CUDA entry points refuse --

def test_cpu_tensors_take_the_plain_twins_and_launch_nothing():
    _, (ta, tb) = _inputs(4, [(128, 256), (256, 128)], "bfloat16")
    counters = (tdg.matmul_grouped_cuda, tdg.matmul_dispersed_cuda,
                trn.rmsnorm_cuda)
    before = [c.launches for c in counters]
    calls = (tdg.matmul_grouped_plain.calls,
             tdg.matmul_dispersed_plain.calls)
    got = tops.matmul(ta, tb, block_m=64, block_k=128)
    assert torch.equal(got, tdg.matmul_grouped_plain(
        ta, tb, block_m=64, block_k=128))
    tops.matmul_dispersed(ta, tb, block_m=64, block_k=128)
    x = ta.float()
    assert torch.equal(trn.rmsnorm(x, torch.ones(256)),
                       trn.rmsnorm_plain(x, torch.ones(256)))
    assert [c.launches for c in counters] == before
    assert (tdg.matmul_grouped_plain.calls,
            tdg.matmul_dispersed_plain.calls) == tuple(c + 1 for c in calls)
    for fn in (lambda: tdg.matmul_grouped_cuda(ta, tb),
               lambda: tdg.matmul_dispersed_cuda(ta, tb),
               lambda: trn.rmsnorm_cuda(x, torch.ones(256))):
        with pytest.raises(ValueError, match="CUDA device"):
            fn()
