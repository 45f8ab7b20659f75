"""K6's routes and tiling plan (``rmsnorm.rmsnorm_plan``), the wrapper's
dispatch to the two routes, its launch counts per route and its ctypes
signatures.

The CUDA kernels run only on the card (chip_smoke.py holds them against
the plain twin there and the plan against the built ``rmsnorm_tile``);
what surrounds them, the choice of route from shape, dtype and alignment,
the tile and the launch arguments, is Python and is held here.
"""

import contextlib
import ctypes
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.kernels.routes import RouteCounted  # noqa: E402

SRC = Path(trn.__file__).parent / "csrc" / "rmsnorm.cu"


def _x(shape, dtype, *, offset=0):
    """A zero tensor of ``shape`` on the CPU, viewed ``offset`` elements
    into its buffer (contiguous, but its base moved by offset * elt)."""
    n = 1
    for s in shape:
        n *= s
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


# (shape, dtype, offset, route, threads per row): the shapes chip_smoke
# runs on the card, and the edges of the vec route.
PLANS = [
    ((8192, 4096), torch.bfloat16, 0, "vec", 128),
    ((2048, 3072), torch.bfloat16, 0, "vec", 128),
    ((8192, 4096), torch.float32, 0, "vec", 256),
    ((2048, 3072), torch.float32, 0, "vec", 256),
    ((5003, 4096), torch.bfloat16, 0, "vec", 128),
    ((1111, 3072), torch.float32, 0, "vec", 256),
    ((2, 128, 512), torch.float32, 0, "vec", 32),
    ((2, 64, 1024), torch.bfloat16, 0, "vec", 32),
    ((3, 100), torch.float32, 0, "vec", 32),
    ((4, 8), torch.bfloat16, 0, "vec", 32),            # one vector a row
    ((4, 8192), torch.bfloat16, 0, "vec", 256),        # the widest bf16
    ((4, 4096), torch.float32, 0, "vec", 256),         # the widest f32
    ((4, 1032), torch.bfloat16, 0, "vec", 64),
    ((300, 1004), torch.bfloat16, 0, "general", 32),   # d % 8 != 0
    ((7, 6), torch.float32, 0, "general", 32),         # 24-byte rows
    ((512, 4096), torch.bfloat16, 1, "general", 32),   # base off by 2 B
    ((512, 4096), torch.float32, 2, "general", 32),    # base off by 8 B
    ((512, 4096), torch.bfloat16, 8, "vec", 128),      # off by 16 B
    ((64, 16384), torch.bfloat16, 0, "general", 32),   # above the limit
    ((4, 8200), torch.bfloat16, 0, "general", 32),
    ((4, 4100), torch.float32, 0, "general", 32),
]


@pytest.mark.parametrize("shape,dtype,offset,route,tpr", PLANS)
def test_rmsnorm_plan_route_and_tile(shape, dtype, offset, route, tpr):
    plan = trn.rmsnorm_plan(_x(shape, dtype, offset=offset))
    assert plan["route"] == route
    assert plan["threads_per_row"] == tpr
    if route == "vec":
        d = shape[-1]
        vectors = d * dtype.itemsize // 16
        assert plan["vectors_per_thread"] == trn.VEC_PER_THREAD
        # the least power of two that covers the row
        assert tpr * trn.VEC_PER_THREAD >= vectors
        assert tpr == 32 or (tpr // 2) * trn.VEC_PER_THREAD < vectors
        assert plan["rows_per_cta"] * tpr == plan["cta_threads"] == 256
        assert plan["ctas_per_sm"] == trn.VEC_CTAS_PER_SM
        assert "why" not in plan
    else:
        assert (plan["vectors_per_thread"], plan["rows_per_cta"],
                plan["ctas_per_sm"], plan["cta_threads"]) == (0, 8, 0, 256)
        assert plan["why"]


@pytest.mark.parametrize("shape,dtype,offset,why", [
    ((300, 1004), torch.bfloat16, 0, "no multiple of 16"),
    ((512, 4096), torch.bfloat16, 1, "not 16-byte aligned"),
    ((64, 16384), torch.bfloat16, 0, "exceeds 1024"),
])
def test_general_plan_says_why(shape, dtype, offset, why):
    assert why in trn.rmsnorm_plan(_x(shape, dtype, offset=offset))["why"]


def test_route_depends_on_shape_dtype_and_alignment_only():
    """Two tensors alike in shape, dtype and alignment get one plan,
    whatever their values or row count."""
    a = trn.rmsnorm_plan(torch.randn(64, 4096).bfloat16())
    b = trn.rmsnorm_plan(_x((3, 4096), torch.bfloat16))
    assert a == b


BAD = {  # id: (tensor, message)
    "float16": (lambda: torch.zeros((4, 64), dtype=torch.float16),
                "float32 or bfloat16"),
    "int8": (lambda: torch.zeros((4, 64), dtype=torch.int8),
             "float32 or bfloat16"),
    "transposed": (lambda: torch.zeros((64, 4)).t(), "contiguous"),
    "no_rows": (lambda: torch.zeros((0, 64)), "non-empty"),
    "no_columns": (lambda: torch.zeros((4, 0)), "non-empty"),
    "scalar": (lambda: torch.zeros(()), "non-empty"),
}


@pytest.mark.parametrize("make,msg", BAD.values(), ids=BAD.keys())
def test_rmsnorm_plan_raises_the_routes_value_errors(make, msg):
    with pytest.raises(ValueError, match=msg):
        trn.rmsnorm_plan(make())


def test_rmsnorm_plan_refuses_rows_past_the_int_range():
    """2**31 rows of 8: the kernels count rows in an int.  (A stand-in
    for the tensor, which would take 32 GB.)"""
    class Big:
        dtype, shape = torch.bfloat16, (2 ** 31, 8)

        def is_contiguous(self):
            return True

        def dim(self):
            return 2

        def numel(self):
            return 2 ** 34

        def element_size(self):
            return 2

        def data_ptr(self):
            return 0

    with pytest.raises(ValueError, match="int range"):
        trn.rmsnorm_plan(Big())


def _c_section(src, start, end):
    i = src.index(start)
    return src[i:src.index(end, i)]


@pytest.mark.parametrize("py_name,c_name,section", [
    ("VEC_BYTES", "VEC_BYTES", "vec"), ("VEC_PER_THREAD", "VPT", "vec"),
    ("VEC_CTA_THREADS", "CTA_THREADS", "vec"),
    ("VEC_CTAS_PER_SM", "CTAS_PER_SM", "vec"),
    ("VEC_MAX_THREADS_PER_ROW", "MAX_TPR", "vec"),
    ("GENERAL_CTA_THREADS", "NTHREADS", "general")])
def test_plan_constants_match_the_c_source(py_name, c_name, section):
    """rmsnorm_plan's constants are the kernels' (chip_smoke.py also holds
    the plan's tile against the built library's ``rmsnorm_tile``)."""
    src = SRC.read_text()
    part = (_c_section(src, "namespace vec {", "}  // namespace vec")
            if section == "vec" else
            _c_section(src, "namespace {", "}  // namespace"))
    found = re.findall(r"constexpr int " + c_name + r" = (\d+);", part)
    assert found == [str(getattr(trn, py_name))]


def test_general_rows_per_cta_matches_the_c_source():
    part = _c_section(SRC.read_text(), "namespace {", "}  // namespace")
    assert "constexpr int ROWS_PER_CTA = NTHREADS / 32;" in part
    assert trn.GENERAL_ROWS_PER_CTA == trn.GENERAL_CTA_THREADS // 32


def test_vec_instantiates_every_threads_per_row_the_plan_names():
    """The launcher's switch has a case for each power of two from 32 to
    the limit, the set vec_threads_per_row can return."""
    src = SRC.read_text()
    cases = sorted(int(c) for c in re.findall(
        r"case (\d+): return launch_tpr<T, \1>", src))
    want, tpr = [], 32
    while tpr <= trn.VEC_MAX_THREADS_PER_ROW:
        want.append(tpr)
        tpr *= 2
    assert cases == want
    got = {trn.vec_threads_per_row(d, elt) for elt in (2, 4)
           for d in range(8, 20000, 8)}
    assert got == set(want) | {0}


@pytest.mark.parametrize("name", sorted(trn.ARGTYPES))
def test_ctypes_argtypes_match_the_c_entry_points(name):
    """Each entry point's ctypes signature has the C declaration's
    parameters: pointers where it takes pointers, a float for eps."""
    decl = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)",
                     SRC.read_text())
    params = [p.strip() for p in decl.group(1).split(",")]
    argtypes = trn.ARGTYPES[name]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        assert ("*" in p) == (t is ctypes.c_void_p), (name, p)
        if t is ctypes.c_float:
            assert p.startswith("float"), (name, p)
        if t is ctypes.c_int:
            assert p.startswith("int "), (name, p)


# -- launch counts per route -------------------------------------------------

def test_launches_is_the_sum_of_the_route_counts():
    """K6's wrapper counts per route; ``launches`` is derived, and a reset
    to 0 clears both routes."""
    fn = trn.rmsnorm_cuda
    assert fn.routes == ("vec", "general")
    saved = fn.launches_vec, fn.launches_general
    try:
        fn.launches_vec, fn.launches_general = 3, 5
        assert fn.launches == 8
        assert fn.by_route() == {"vec": 3, "general": 5}
        fn.launches = 0
        assert (fn.launches_vec, fn.launches_general, fn.launches) == (
            0, 0, 0)
        with pytest.raises(ValueError):
            fn.launches = 2
    finally:
        fn.launches_vec, fn.launches_general = saved
    assert fn.__name__ == "rmsnorm_cuda" and fn.__doc__


@pytest.mark.parametrize("routes", [("tc", "fma"), ("vec", "general"),
                                    ("a", "b", "c")])
def test_route_counted_counts_each_route_apart(routes):
    counted = RouteCounted(lambda plan: counted.count(plan), routes)
    for i, route in enumerate(routes):
        for _ in range(i + 1):
            counted({"route": route})
    assert counted.by_route() == {r: i + 1 for i, r in enumerate(routes)}
    assert counted.launches == sum(range(1, len(routes) + 1))
    with pytest.raises(ValueError, match="none of"):
        counted.count({"route": "other"})
    counted.launches = 0
    assert counted.by_route() == dict.fromkeys(routes, 0)


def test_route_counted_default_is_tc_and_fma():
    counted = RouteCounted(lambda: None)
    assert counted.routes == ("tc", "fma")
    assert (counted.launches_tc, counted.launches_fma) == (0, 0)


# -- dispatch, with the card faked -------------------------------------------

class _FakeEntry:
    """A C entry point that records its arguments and returns ``rc``."""

    def __init__(self, calls, name, rc):
        self.calls, self.name, self.rc = calls, name, rc
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls.append((self.name, self.argtypes, self.restype, args))
        return self.rc


class _FakeLib:
    def __init__(self, calls, rc):
        for name in trn.ARGTYPES:
            setattr(self, name, _FakeEntry(calls, name, rc))


@pytest.fixture
def fake_card(monkeypatch):
    """Replace the device check, the stream and the library by recorders
    (no card here); returns (calls, loads, set_rc)."""
    calls, loads, rc = [], [], [0]

    def load(name):
        loads.append(name)
        return _FakeLib(calls, rc[0])

    trn._library.cache_clear()
    monkeypatch.setattr(trn, "_check_cuda", lambda x, scale: None)
    monkeypatch.setattr(trn, "_device_stream",
                        lambda t: (contextlib.nullcontext(), 7))
    monkeypatch.setattr(_build, "load", load)
    yield calls, loads, rc
    trn._library.cache_clear()


@pytest.mark.parametrize("shape,dtype,offset,route,tpr",
                         [PLANS[i] for i in (0, 1, 2, 13, 15, 18)])
def test_cuda_wrapper_takes_the_plans_route(fake_card, shape, dtype, offset,
                                            route, tpr):
    calls, loads, _ = fake_card
    fn = trn.rmsnorm_cuda
    before = fn.by_route()
    x = _x(shape, dtype, offset=offset)
    scale = torch.ones(shape[-1])
    out = fn(x, scale, eps=1e-5)
    assert out.dtype == x.dtype and out.shape == x.shape
    (name, argtypes, restype, args), = calls
    assert name == ("rmsnorm_vec_launch" if route == "vec"
                    else "rmsnorm_general_launch")
    assert argtypes == trn.ARGTYPES[name] and restype is ctypes.c_int
    rows = x.numel() // shape[-1]
    assert args == (x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows,
                    shape[-1], 1e-5, trn._DTYPE_CODE[dtype], 7)
    after = fn.by_route()
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == route) for r in after}
    assert loads == ["rmsnorm"]


def test_library_is_loaded_once_and_f32_scale_passed_as_is(fake_card):
    """The host path: the library is looked up and its signatures set on
    the first call only; an f32 contiguous scale is handed over as it is,
    any other is converted."""
    calls, loads, _ = fake_card
    x = _x((16, 256), torch.bfloat16)
    scale = torch.ones(256)
    for _ in range(3):
        trn.rmsnorm_cuda(x, scale)
    assert loads == ["rmsnorm"]
    assert [c[3][1] for c in calls] == [scale.data_ptr()] * 3
    half = torch.ones(256, dtype=torch.bfloat16)
    trn.rmsnorm_cuda(x, half)
    assert calls[-1][3][1] != half.data_ptr()
    assert loads == ["rmsnorm"]


@pytest.mark.parametrize("rc,exc", [(-1, ValueError), (700, RuntimeError)])
def test_a_refused_or_failed_launch_raises_and_counts_nothing(fake_card, rc,
                                                              exc):
    calls, _, set_rc = fake_card
    set_rc[0] = rc
    fn = trn.rmsnorm_cuda
    before = fn.by_route()
    with pytest.raises(exc):
        fn(_x((16, 256), torch.bfloat16), torch.ones(256))
    assert len(calls) == 1
    assert fn.by_route() == before


def test_a_scale_of_the_wrong_shape_never_reaches_a_kernel(fake_card):
    calls, _, _ = fake_card
    with pytest.raises(ValueError, match="scale shape"):
        trn.rmsnorm_cuda(_x((16, 256), torch.float32), torch.ones(128))
    assert calls == []
