"""The GEMM kernels' routes and tiling plan (``dispersed_gemm.tc_plan``),
the wrappers' dispatch to the two routes, and the plain twins against the
JAX package at W = 3.

The CUDA kernels run only on the card (chip_smoke.py holds them against
their plain twins there); what surrounds them, the choice of route, the
CTA tiling, the shared-memory budget and the launch arguments, is Python
and is held here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import dispersed_gemm as jdg  # noqa: E402
from repro_torch.benchmarks import roofline as troofline  # noqa: E402
from repro_torch.kernels import dispersed_gemm as tdg  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}
ROUTE = {"float32": "fma", "bfloat16": "tc", "int8": "tc"}


def _used_points():
    """Every (m, k, n, W, block_m, block_k, dtype) the card runs: the
    roofline grid and its equal-footprint study, chip_smoke's kernel cases
    (all three dtypes, W = 3 on the tensor cores) and its granite-8b
    timing shape, and vmem_dispersion's spot check.  W = 0 is K4."""
    pts = set()
    for m, k, n in troofline.GEMM_CASES.values():
        for w in troofline.W_AXIS:
            for dt in DTYPES:
                pts.add((m, k, n, w, troofline.BLOCK_M, troofline.BLOCK_K,
                         dt))
        for w, bm, bk in troofline.equal_vmem_points(m):
            pts.add((m, k, n, w, bm, bk, "float32"))
    smoke = [(m, 512, n, w, 64, 128) for (m, n) in ((256, 256), (512, 256))
             for w in (0, 1, 2, 4)]
    smoke += [(512, 512, 256, w, bm, bk) for (w, bm, bk) in
              ((4, 64, 128), (2, 128, 128), (1, 256, 64))]
    smoke += [(256, 512, 200, 2, 64, 128), (256, 512, 200, 0, 64, 128)]
    for case in smoke:
        for dt in DTYPES:
            pts.add(case + (dt,))
    for dt in ("bfloat16", "int8"):
        pts.add((384, 128, 256, 3, 64, 128, dt))
        for w in (1, 4, 0):
            pts.add((8192, 4096, 14336, w, 128, 512, dt))
    pts.add((256, 512, 256, 2, 128, 256, "float32"))
    return sorted(pts)


@pytest.mark.parametrize("m,k,n,w,bm,bk,dtype", _used_points())
def test_tc_plan_at_every_point_the_card_runs(m, k, n, w, bm, bk, dtype):
    plan = tdg.tc_plan(m, n, k, block_m=bm, block_k=bk, working_set=w,
                       dtype=DTYPES[dtype])
    assert plan["route"] == ROUTE[dtype]
    assert plan["smem_bytes"] <= tdg.SMEM_LIMIT
    assert plan["acc_per_thread"] <= 128
    if plan["route"] == "tc":
        assert plan["cluster"] == max(w, 1)
        assert plan["block_m"] == bm
        assert plan["n_tile"] * plan["block_m"] == 256 * plan[
            "acc_per_thread"]            # 2 warpgroups x 128 threads
        assert plan["stages"] >= 3
        if w == 0:
            assert plan["fill_smem_bytes"] <= tdg.SMEM_LIMIT
            assert plan["fill_stages"] >= 2
    else:
        assert plan["cluster"] == 1
        assert plan["block_m"] == (w or 1) * bm      # the CTA's rows


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("bm", [64, 128, 256])
def test_tc_n_tile_does_not_depend_on_w(bm, dtype):
    m = 12 * 256                 # nm divisible by 1, 2, 3 and 4
    plans = [tdg.tc_plan(m, 512, 1024, block_m=bm, block_k=256,
                         working_set=w, dtype=DTYPES[dtype])
             for w in (1, 2, 3, 4)]
    assert len({p["n_tile"] for p in plans}) == 1
    assert [p["cluster"] for p in plans] == [1, 2, 3, 4]
    assert len({(p["stages"], p["smem_bytes"]) for p in plans}) == 1


BAD_TC = [  # (m, k, n, W, block_m, block_k, dtype, message)
    (64 * 16, 256, 256, 16, 64, 128, "bfloat16", "at most 8 CTAs"),
    (64 * 16, 256, 256, 16, 64, 128, "int8", "at most 8 CTAs"),
    (256, 256, 256, 1, 32, 128, "bfloat16", "block_m in"),
    (384, 256, 256, 1, 192, 128, "int8", "block_m in"),
    (256, 96, 256, 1, 64, 96, "bfloat16", "chunks of 64"),
    (256, 256, 256, 0, 64, 32, "int8", "chunks of 64"),
    (256, 256, 200 - 4, 1, 64, 128, "bfloat16", "multiple of 8"),
    (256, 256, 198, 0, 64, 128, "int8", "multiple of 4"),
    (384, 128, 256, 3, 64, 128, "float32", "power of two"),
    (256, 256, 256, 1, 4, 128, "float32", "power of two"),
]


@pytest.mark.parametrize("m,k,n,w,bm,bk,dtype,msg", BAD_TC)
def test_tc_plan_raises_the_routes_value_errors(m, k, n, w, bm, bk, dtype,
                                                msg):
    with pytest.raises(ValueError, match=msg):
        tdg.tc_plan(m, n, k, block_m=bm, block_k=bk, working_set=w,
                    dtype=DTYPES[dtype])


def test_tc_plan_takes_what_the_other_route_refuses():
    # W * block_m = 192 rows: no power of two, but 3 CTAs of 64 rows
    assert tdg.tc_plan(384, 256, 128, block_m=64, block_k=128,
                       working_set=3, dtype=torch.bfloat16)["cluster"] == 3
    # int8 reads B with ordinary loads: any n; f32: any block_m of 2^i
    assert tdg.tc_plan(256, 196, 256, block_m=64, block_k=128,
                       working_set=1, dtype=torch.int8)["route"] == "tc"
    assert tdg.tc_plan(256, 256, 256, block_m=32, block_k=128,
                       working_set=1, dtype=torch.float32)["route"] == "fma"
    # K3 walks all of k: its block_k need not be a multiple of 64
    assert tdg.tc_plan(256, 256, 256, block_m=64, block_k=32,
                       working_set=1, dtype=torch.bfloat16)["route"] == "tc"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_cuda_wrappers_take_the_dtypes_route(monkeypatch, dtype):
    """The wrappers' launch arguments and counters, with the device check
    and both launchers replaced by recorders (no card here)."""
    calls = []
    monkeypatch.setattr(tdg, "_check_cuda", lambda a, b, name: None)
    monkeypatch.setattr(tdg, "_launch_tc", lambda a, b, acc, out, **kw:
                        calls.append(("tc", acc is not None, kw)))
    monkeypatch.setattr(tdg, "_launch", lambda a, b, acc, out, **kw:
                        calls.append(("fma", acc is not None, kw)))
    fns = (tdg.matmul_grouped_cuda, tdg.matmul_dispersed_cuda)
    before = [(f.launches, f.launches_tc, f.launches_fma) for f in fns]
    a = torch.zeros((256, 512), dtype=DTYPES[dtype])
    b = torch.zeros((512, 256), dtype=DTYPES[dtype])
    out = tdg.matmul_grouped_cuda(a, b, block_m=64, block_k=128,
                                  working_set=2)
    assert out.dtype == a.dtype and out.shape == (256, 256)
    tdg.matmul_dispersed_cuda(a, b, block_m=64, block_k=128)
    route = ROUTE[dtype]
    assert [c[0] for c in calls] == [route] * 5
    k3, k4 = calls[0][2], [c[2] for c in calls[1:]]
    assert (k3["k_begin"], k3["k_end"], k3["load_acc"],
            k3["store_out"]) == (0, 512, False, True)
    assert not calls[0][1]                   # K3 keeps C on chip
    assert [(c["k_begin"], c["k_end"]) for c in k4] == [
        (0, 128), (128, 256), (256, 384), (384, 512)]
    assert [c["load_acc"] for c in k4] == [False, True, True, True]
    assert [c["store_out"] for c in k4] == [False, False, False, True]
    assert all(c[1] for c in calls[1:])      # K4's f32 C buffer
    if route == "tc":
        assert k3["plan"]["cluster"] == 2 and k4[0]["plan"]["cluster"] == 1
    else:
        assert k3["rows"] == 128 and k4[0]["rows"] == 64
    after = [(f.launches, f.launches_tc, f.launches_fma) for f in fns]
    for (n0, t0, f0), (n1, t1, f1), want in zip(before, after, (1, 4)):
        assert n1 - n0 == want
        assert (t1 - t0, f1 - f0) == ((want, 0) if route == "tc"
                                      else (0, want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("m,k,n", [(256, 512, 128), (512, 256, 256),
                                   (384, 128, 256)])
def test_grouped_twin_matches_pallas_at_w3(m, k, n, dtype):
    """W = 3 at block_m 64: legal where 3 divides the row-tile count
    (384 rows), the reference's ValueError elsewhere."""
    rng = np.random.default_rng(m + n)
    if dtype == "int8":
        arrs = [rng.integers(-4, 5, s).astype(np.int8)
                for s in ((m, k), (k, n))]
        ja, jb = (jnp.asarray(x) for x in arrs)
    else:
        arrs = [rng.standard_normal(s).astype(np.float32)
                for s in ((m, k), (k, n))]
        ja, jb = (jnp.asarray(x, getattr(jnp, dtype)) for x in arrs)
    ta, tb = (torch.from_numpy(x).to(DTYPES[dtype]) for x in arrs)
    kw = dict(block_m=64, block_k=128, working_set=3)
    try:
        want = jdg.matmul_grouped(ja, jb, interpret=True, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tdg.matmul_grouped(ta, tb, **kw)
        assert str(got.value) == str(e)
        return
    got = tdg.matmul_grouped(ta, tb, **kw)
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    if dtype == "int8":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    elif dtype == "bfloat16":
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126)))
                      - 7)
        assert (np.abs(g - w) <= np.maximum(ulp, 1e-4)).all()
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)
    assert torch.equal(got, tdg.matmul_grouped(ta, tb, block_m=64,
                                               block_k=128, working_set=1))


def test_ctypes_argtypes_match_the_c_entry_points():
    """Each entry point's ctypes signature has the C declaration's
    parameters, pointers where it takes pointers."""
    import ctypes
    import re
    from pathlib import Path
    src = (Path(tdg.__file__).parent / "csrc" / "dispersed_gemm.cu"
           ).read_text()
    for name, argtypes in tdg.ARGTYPES.items():
        decl = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        params = [p.strip() for p in decl.group(1).split(",")]
        assert len(params) == len(argtypes)
        for p, t in zip(params, argtypes):
            assert ("*" in p) == (t is ctypes.c_void_p), (name, p)


def test_launches_is_the_sum_of_the_route_counts():
    """A GEMM wrapper counts per route; ``launches`` is derived, and a
    reset to 0 clears both routes."""
    for fn in (tdg.matmul_grouped_cuda, tdg.matmul_dispersed_cuda):
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
        assert fn.__name__.startswith("matmul_") and fn.__doc__


@pytest.mark.parametrize("py_name,c_name", [
    ("TC_K_CHUNK", "KCHUNK"), ("TC_MAX_CLUSTER", "MAX_CLUSTER"),
    ("SMEM_LIMIT", "SMEM_LIMIT"), ("_TC_ALIGN", "SMEM_ALIGN"),
    ("_TC_MAX_STAGES", "MAX_STAGES"), ("_FMA_ACC_PER_CTA", "ACC_PER_CTA"),
    ("_FMA_KC", "KC"), ("_FMA_PAD", "PAD")])
def test_plan_constants_match_the_c_source(py_name, c_name):
    """tc_plan's constants are the kernel's (chip_smoke.py also holds the
    plan's tiles against the built library's ``gemm_tc_tile``)."""
    import re
    from pathlib import Path
    src = (Path(tdg.__file__).parent / "csrc" / "dispersed_gemm.cu"
           ).read_text()
    found = re.findall(r"constexpr int " + c_name + r" = (\d+);", src)
    assert found == [str(getattr(tdg, py_name))]
