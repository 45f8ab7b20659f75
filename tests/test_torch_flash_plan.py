"""K5's routes and tiling plan (``flash_attention.flash_plan``), the
wrapper's dispatch to the two routes, its launch counts and its ctypes
signatures.

The CUDA kernels run only on the card (chip_smoke.py holds them against
the plain twin there and the plan against the built ``flash_tc_tile``);
what surrounds them, the choice of route, the tile, the shared-memory
budget, the TMA's alignment rules and the launch arguments, is Python and
is held here.
"""

import contextlib
import ctypes
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import roofline as troofline  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}
ROUTE = {"float32": "fma", "bfloat16": "tc", "int8": "fma"}
SRC = Path(tfa.__file__).parent / "csrc" / "flash_attention.cu"


def _qkv(q_shape, kv_shape, dtype, *, bshd=False):
    """Zero q, k, v on the CPU; ``bshd`` makes them (B,S,H,D) tensors
    viewed as (B,H,S,D), the strided layout the model's prefill passes."""
    def one(shape):
        if bshd:
            b, h, s, d = shape
            return torch.zeros((b, s, h, d), dtype=dtype).transpose(1, 2)
        return torch.zeros(shape, dtype=dtype)
    return one(q_shape), one(kv_shape), one(kv_shape)


# Every K5 shape the card runs: chip_smoke's kernel cases, its prefill
# and timing shape, the serving prefill's layout, and the roofline's
# attention points (full and smoke grid).  (q, kv, bshd)
SHAPES = [
    ((4, 32, 512, 96), (4, 32, 512, 96), True),
    ((1, 8, 200, 96), (1, 8, 328, 96), False),
    ((2, 32, 256, 128), (2, 8, 256, 128), True),
    ((2, 32, 256, 128), (2, 8, 256, 128), False),
    ((2, 8, 384, 96), (2, 8, 384, 96), False),
    ((1, 8, 200, 64), (1, 8, 328, 64), False),
    ((1, 4, 192, 32), (1, 4, 192, 32), False),
    ((1, 2, 40, 64), (1, 2, 300, 64), False),
    ((1, 1, 128, 96), (1, 1, 128, 96), True),
] + [((b, h, s, d), (b, h, s, d), False) for b, h, s, d in
     list(troofline.FLASH_CASES.values())
     + list(troofline.SMOKE_FLASH_CASES.values())]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("q_shape,kv_shape,bshd", SHAPES)
def test_flash_plan_at_every_shape_the_card_runs(q_shape, kv_shape, bshd,
                                                 dtype):
    q, k, v = _qkv(q_shape, kv_shape, DTYPES[dtype], bshd=bshd)
    plan = tfa.flash_plan(q, k, v)
    assert plan["route"] == ROUTE[dtype]
    assert plan["smem_bytes"] <= tfa.SMEM_LIMIT
    if plan["route"] == "tc":
        d = q_shape[-1]
        assert (plan["block_q"], plan["block_k"], plan["stages"]) == (
            128, 128, 2)
        assert plan["boxes"] * plan["swizzle"] // 2 == d
        assert plan["items"] == q_shape[0] * q_shape[1] * -(-q_shape[2]
                                                            // 128)
    else:
        assert (plan["block_q"], plan["block_k"]) == (64, 64)


@pytest.mark.parametrize("d,swizzle,boxes", [(32, 64, 1), (64, 128, 1),
                                             (96, 64, 3), (128, 128, 2)])
def test_tc_swizzle_and_boxes_per_head_dim(d, swizzle, boxes):
    """96 bf16 (192 bytes) fits no 128-byte swizzle row: three boxes of
    32 columns under the 64-byte swizzle; 64 and 128 take the 128-byte
    swizzle; 32 the 64-byte one in one box."""
    plan = tfa.flash_plan(*_qkv((1, 1, 128, d), (1, 1, 128, d),
                                torch.bfloat16))
    assert (plan["swizzle"], plan["boxes"]) == (swizzle, boxes)
    assert plan["smem_bytes"] == 1024 + 128 * d * 2 + 4 * 128 * d * 2 + 80


def _misaligned_base():
    x = torch.zeros(1 * 2 * 64 * 96 + 1, dtype=torch.bfloat16)
    q = x[1:].view(1, 2, 64, 96)
    return q, q, q


def _s_stride_200_bytes():
    q = torch.zeros((1, 2, 64, 100), dtype=torch.bfloat16)[..., :96]
    return q, q, q


def _h_stride_200_bytes():
    q = torch.zeros((1, 64, 2, 100), dtype=torch.bfloat16)[..., :96]
    q = q.transpose(1, 2)
    return q, q, q


def _head_dim_80():
    return _qkv((1, 2, 64, 80), (1, 2, 64, 80), torch.bfloat16)


def _gqa_4_over_3():
    q, _, _ = _qkv((1, 4, 64, 64), (1, 4, 64, 64), torch.bfloat16)
    _, k, v = _qkv((1, 3, 64, 64), (1, 3, 64, 64), torch.bfloat16)
    return q, k, v


def _d_stride_2():
    q = torch.zeros((1, 2, 64, 192), dtype=torch.bfloat16)[..., ::2]
    return q, q, q


def _mixed_dtypes():
    q, k, _ = _qkv((1, 2, 64, 64), (1, 2, 64, 64), torch.bfloat16)
    return q, k, k.float()


def _empty_keys():
    q, _, _ = _qkv((1, 2, 64, 64), (1, 2, 64, 64), torch.bfloat16)
    _, k, v = _qkv((1, 2, 0, 64), (1, 2, 0, 64), torch.bfloat16)
    return q, k, v


def _f32_grid_y():
    q = torch.zeros((1, 1, 1, 32)).expand(1, 65536, 1, 32)
    return q, q, q


BAD = [  # (inputs, message)
    (_misaligned_base, "base address must be a multiple of 16 bytes"),
    (_s_stride_200_bytes, "multiples of 16 bytes"),
    (_h_stride_200_bytes, "multiples of 16 bytes"),
    (_head_dim_80, "head dim 80 not supported"),
    (_gqa_4_over_3, "must be a multiple of k/v heads"),
    (_d_stride_2, "unit stride along the head dim"),
    (_mixed_dtypes, "all alike"),
    (_empty_keys, "empty attention"),
    (_f32_grid_y, "grid limit"),
]


@pytest.mark.parametrize("make,msg", BAD, ids=[m.__name__ for m, _ in BAD])
def test_flash_plan_raises_the_routes_value_errors(make, msg):
    with pytest.raises(ValueError, match=msg):
        tfa.flash_plan(*make())


def test_the_fma_route_takes_what_the_tc_route_refuses():
    """Only bfloat16 reads by TMA: f32 and int8 at a 200-byte sequence
    stride or an unaligned base take the CUDA-core route."""
    for dtype in (torch.float32, torch.int8):
        q = torch.zeros((1, 2, 64, 100), dtype=dtype)[..., :96]
        assert tfa.flash_plan(q, q, q)["route"] == "fma"
        x = torch.zeros(2 * 64 * 96 + 1, dtype=dtype)[1:].view(1, 2, 64, 96)
        assert tfa.flash_plan(x, x, x)["route"] == "fma"


def test_size_one_dims_take_the_span_as_stride():
    """A batch or head of size 1 is never stepped: its stride, which torch
    leaves free, does not decide the route."""
    q = torch.zeros((1, 64, 1, 96), dtype=torch.bfloat16).transpose(1, 2)
    assert tfa._tma_strides(q) == [64 * 96, 64 * 96, 96]
    q = torch.zeros((1, 1, 64, 96), dtype=torch.bfloat16).as_strided(
        (1, 1, 64, 96), (3, 5, 96, 1))   # free strides of 6 and 10 bytes
    assert tfa.flash_plan(q, q, q)["route"] == "tc"
    assert tfa._tma_strides(q) == [64 * 96, 64 * 96, 96]


def _c_section(src: str, start: str, end: str) -> str:
    i = src.index(start)
    return src[i:src.index(end, i)]


@pytest.mark.parametrize("py_name,c_name,section", [
    ("TC_BQ", "BQ", "tc"), ("TC_BK", "BK", "tc"),
    ("TC_STAGES", "STAGES", "tc"), ("_TC_ALIGN", "SMEM_ALIGN", "tc"),
    ("FMA_BQ", "BQ", "fma"), ("FMA_BK", "BK", "fma")])
def test_plan_constants_match_the_c_source(py_name, c_name, section):
    """flash_plan's constants are the kernels' (chip_smoke.py also holds
    the plan's tile against the built library's ``flash_tc_tile``)."""
    src = SRC.read_text()
    part = (_c_section(src, "namespace tc {", "}  // namespace tc")
            if section == "tc" else
            _c_section(src, "namespace {", "}  // namespace"))
    found = re.findall(r"constexpr int " + c_name + r" = (\d+);", part)
    assert found == [str(getattr(tfa, py_name))]


def test_barrier_bytes_match_the_c_source():
    src = _c_section(SRC.read_text(), "namespace tc {", "}  // namespace tc")
    assert "static constexpr int BARS = 8 * (2 + 4 * STAGES);" in src
    assert tfa._TC_BARRIERS == 8 * (2 + 4 * tfa.TC_STAGES)


@pytest.mark.parametrize("name", sorted(tfa.ARGTYPES))
def test_ctypes_argtypes_match_the_c_entry_points(name):
    """Each entry point's ctypes signature has the C declaration's
    parameters: pointers where it takes pointers, 64-bit ints for the
    strides, a float for the scale."""
    decl = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)",
                     SRC.read_text())
    params = [p.strip() for p in decl.group(1).split(",")]
    argtypes = tfa.ARGTYPES[name]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        assert ("*" in p) == (t is ctypes.c_void_p), (name, p)
        if t is ctypes.c_int64:
            assert p.startswith("int64_t"), (name, p)
        if t is ctypes.c_float:
            assert p.startswith("float"), (name, p)


def test_launches_is_the_sum_of_the_route_counts():
    """K5's wrapper counts per route; ``launches`` is derived, and a reset
    to 0 clears both routes."""
    fn = tfa.flash_attention_cuda
    saved = fn.launches_tc, fn.launches_fma
    try:
        fn.launches_tc, fn.launches_fma = 3, 5
        assert fn.launches == 8
        fn.launches = 0
        assert (fn.launches_tc, fn.launches_fma, fn.launches) == (0, 0, 0)
        with pytest.raises(ValueError):
            fn.launches = 2
    finally:
        fn.launches_tc, fn.launches_fma = saved
    assert fn.__name__ == "flash_attention_cuda" and fn.__doc__


class _FakeEntry:
    """A C entry point that records its arguments and returns ``rc``."""

    def __init__(self, calls, name, rc):
        self.calls, self.name, self.rc = calls, name, rc
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls.append((self.name, self.argtypes, args))
        return self.rc


class _FakeLib:
    def __init__(self, calls, rc=0):
        self.flash_tc_launch = _FakeEntry(calls, "flash_tc_launch", rc)
        self.flash_attention_fwd = _FakeEntry(calls, "flash_attention_fwd",
                                              rc)


def _fake_card(monkeypatch, calls, rc=0):
    monkeypatch.setattr(tfa, "_check_cuda", lambda q, k, v: None)
    monkeypatch.setattr(tfa, "_device_stream",
                        lambda t: (contextlib.nullcontext(), 7))
    monkeypatch.setattr(_build, "load", lambda name: _FakeLib(calls, rc))


@pytest.mark.parametrize("bshd", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_wrapper_takes_the_dtypes_route(monkeypatch, dtype, bshd):
    """The wrapper's launch arguments and counters per dtype, with the
    device check, the stream and the library replaced by recorders (no
    card here)."""
    calls = []
    _fake_card(monkeypatch, calls)
    fn = tfa.flash_attention_cuda
    before = fn.launches_tc, fn.launches_fma
    q, k, v = _qkv((2, 8, 200, 96), (2, 2, 328, 96), DTYPES[dtype],
                   bshd=bshd)
    out = fn(q, k, v, causal=True, scale=0.5)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert out.stride() == q.stride()
    (name, argtypes, args), = calls
    route = ROUTE[dtype]
    assert name == ("flash_tc_launch" if route == "tc"
                    else "flash_attention_fwd")
    assert argtypes == tfa.ARGTYPES[name]
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr())
    assert args[4:10] == (2, 8, 2, 200, 328, 96)
    want = [s for t in (q, k, v, out) for s in (
        tfa._tma_strides(t) if route == "tc" else t.stride()[:3])]
    assert list(args[10:22]) == want
    assert args[22:24] == (0.5, 1)
    assert args[24:] == ((7,) if route == "tc"
                         else (tfa._DTYPE_CODE[q.dtype], 7))
    assert (fn.launches_tc - before[0], fn.launches_fma - before[1]) == (
        (1, 0) if route == "tc" else (0, 1))


@pytest.mark.parametrize("rc,exc", [(-1, ValueError), (700, RuntimeError)])
def test_a_refused_or_failed_launch_raises_and_counts_nothing(monkeypatch,
                                                              rc, exc):
    calls = []
    _fake_card(monkeypatch, calls, rc)
    fn = tfa.flash_attention_cuda
    before = fn.launches_tc, fn.launches_fma
    q, k, v = _qkv((1, 2, 64, 64), (1, 2, 64, 64), torch.bfloat16)
    with pytest.raises(exc):
        fn(q, k, v, causal=False, scale=1.0)
    assert len(calls) == 1
    assert (fn.launches_tc, fn.launches_fma) == before


def test_a_bf16_input_the_route_refuses_never_reaches_a_kernel(
        monkeypatch):
    """No fallback: a bf16 head stride of 200 bytes raises the tensor-core
    route's ValueError; the CUDA-core kernel is not called instead."""
    calls = []
    _fake_card(monkeypatch, calls)
    q, k, v = _h_stride_200_bytes()
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        tfa.flash_attention_cuda(q, k, v, causal=True, scale=1.0)
    assert calls == []


def test_roofline_counts_attention_launches_per_precision_and_route(
        monkeypatch):
    """route_launches has the GEMM and the attention rows apart, per
    precision; on the CPU the plain twins run and no route launches."""
    monkeypatch.setattr(troofline, "_measure", lambda fn, dev, rep: 1.0)
    troofline.run_measured(smoke=True, device="cpu")
    routes = troofline.perf_stats()["route_launches"]
    assert sorted(routes) == ["flash_attention", "gemm"]
    assert sorted(routes["flash_attention"]) == ["f32"]
    for precs in routes.values():
        for r in precs.values():
            assert r == {"tc": 0, "fma": 0}
