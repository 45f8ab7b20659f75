"""Port K5 (FlashAttention) against the JAX Pallas kernel.

On the CPU the port's wrappers run the kernel's plain twin; the JAX side
runs the Pallas kernel in interpret mode, as tests/test_kernels_allclose.py
does.  Inputs are made with numpy from a seed and handed to both.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

# f32: both sides compute in f32 and sum in another order.  bf16: both
# accumulate in f32 and round the output once, so they differ by at most
# about one bf16 ulp of the output (2^-8 relative).
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(a, JDT[dtype]) for a in arrs]
    tx = [torch.from_numpy(a).to(TDT[dtype]) for a in arrs]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 96])
@pytest.mark.parametrize("s", [64, 128])
def test_flash_matches_pallas(s, d, causal, dtype):
    shape = (1, 2, s, d)
    (jq, jk, jv), (tq, tk, tv) = _inputs(s * d, [shape] * 3, dtype)
    want = jfa.flash_attention(jq, jk, jv, causal=causal, interpret=True)
    got = tfa.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == TDT[dtype] and got.shape == shape
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])
    got_ops = tops.flash_attention(tq, tk, tv, causal=causal)
    assert torch.equal(got_ops, got)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_gqa_matches_pallas_ops(causal):
    """4 query heads over 2 KV heads: the port's wrapper maps KV heads
    without a repeat copy; the reference repeats them."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        7, [(2, 4, 128, 32), (2, 2, 128, 32), (2, 2, 128, 32)], "float32")
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                block_k=64, interpret=True)
    got = tops.flash_attention(tq, tk, tv, causal=causal, block_q=64,
                               block_k=64)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL["float32"],
                               atol=TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_cross_lengths_non_causal(dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        11, [(1, 2, 64, 96), (1, 2, 128, 96), (1, 2, 128, 96)], dtype)
    want = jfa.flash_attention(jq, jk, jv, causal=False, block_q=64,
                               block_k=64, interpret=True)
    got = tfa.flash_attention(tq, tk, tv, causal=False, block_q=64,
                              block_k=64)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_flash_causal_short_query_is_top_left():
    """Causal with sq < sk: the Pallas kernel masks top-left (row i sees
    columns j <= i, ``rows >= cols`` at flash_attention.py:89-94), while
    ``ref.attention_ref`` masks bottom-right (``tril(k=sk-sq)``).  The two
    reference functions disagree here; the port follows the kernel."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        3, [(1, 2, 64, 32), (1, 2, 128, 32), (1, 2, 128, 32)], "float32")
    kernel = jfa.flash_attention(jq, jk, jv, causal=True, block_q=64,
                                 block_k=64, interpret=True)
    bottom_right = jref.attention_ref(jq, jk, jv, causal=True)
    got = tfa.flash_attention(tq, tk, tv, causal=True, block_q=64,
                              block_k=64)
    np.testing.assert_allclose(_np(got), _np(kernel), rtol=2e-5, atol=2e-5)
    assert np.abs(_np(got) - _np(bottom_right)).max() > 1e-2


@pytest.mark.parametrize("sq,sk,bq,bk", [(96, 128, 64, 64),
                                         (128, 96, 64, 64),
                                         (128, 128, 48, 128)])
def test_flash_block_errors_match_reference(sq, sk, bq, bk):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        0, [(1, 1, sq, 32), (1, 1, sk, 32), (1, 1, sk, 32)], "float32")
    with pytest.raises(ValueError) as want:
        jfa.flash_attention(jq, jk, jv, block_q=bq, block_k=bk,
                            interpret=True)
    for fn in (tfa.flash_attention, tops.flash_attention):
        with pytest.raises(ValueError) as got:
            fn(tq, tk, tv, block_q=bq, block_k=bk)
        assert str(got.value) == str(want.value)


def test_flash_head_errors_match_reference():
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        0, [(1, 4, 64, 32), (1, 3, 64, 32), (1, 3, 64, 32)], "float32")
    with pytest.raises(ValueError) as want:
        jops.flash_attention(jq, jk, jv, interpret=True)
    with pytest.raises(ValueError) as got:
        tops.flash_attention(tq, tk, tv)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jfa.flash_attention(jq, jk, jv, interpret=True)
    with pytest.raises(ValueError) as got:
        tfa.flash_attention(tq, tk, tv)
    assert str(got.value) == str(want.value)


def test_cpu_tensors_take_the_plain_twin_and_launch_nothing():
    _, (tq, tk, tv) = _inputs(5, [(1, 2, 64, 32)] * 3, "float32")
    before = tfa.flash_attention_cuda.launches
    got = tops.flash_attention(tq, tk, tv, causal=True)
    assert tfa.flash_attention_cuda.launches == before
    want = tfa.flash_attention_plain(tq, tk, tv, causal=True)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_attention_cuda(tq, tk, tv, causal=True, scale=1.0)
