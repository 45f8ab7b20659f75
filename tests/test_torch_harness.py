"""The port's benchmark harness (``python -m repro_torch.benchmarks.run``)
and examples against the reference's, on the CPU.

``run.main`` writes the reference's report layout with the port's
accounting (``dispatches``, ``launches``, ``device``; no ``compiles``),
its ``kernels`` block equal to the reference harness's on the same
arguments (dropout and gemv at ``max_events`` = 2,000; the fixed roster of
policy_headroom at 1,000), the roofline's payload merged in, and exits 2
for an unknown suite; every suite of the reference's harness runs,
network_sweep included; without a card and without ``--device cpu`` it
raises.  Both examples run on the CPU and print the paper's
verdicts.
"""

import importlib
import json

import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.benchmarks import run as trun  # noqa: E402

NAMES = ("dropout", "gemv")


@pytest.fixture
def fresh_port_session():
    """A fresh process-default port Session on the CPU for one test; the
    previous default is restored afterwards."""
    old = tapi._DEFAULT_SESSION
    ses = tapi.reset_default_session(device="cpu")
    yield ses
    tapi._DEFAULT_SESSION = old


def _report(main, path, extra_args, suites):
    assert main(["--kernels", ",".join(NAMES), "--json", str(path)]
                + extra_args + suites) == 0
    return json.loads(path.read_text())


@pytest.mark.parametrize("budget,suites", [
    (2_000, ["table3", "fig4", "pareto", "fig2"]),
    (1_000, ["policy_headroom"])], ids=["named_kernels", "fixed_roster"])
def test_run_json_report_equals_reference(tmp_path, budget, suites,
                                          fresh_port_session):
    """The port's report: the reference's layout and kernel records (equal
    to the reference harness's on the same arguments) and the port's
    accounting."""
    from benchmarks import run as jrun
    args = ["--max-events", str(budget)]
    got = _report(trun.main, tmp_path / "port.json",
                  args + ["--device", "cpu"], suites)
    old = japi._DEFAULT_SESSION
    japi.reset_default_session()
    try:
        want = _report(jrun.main, tmp_path / "ref.json", args, suites)
    finally:
        japi._DEFAULT_SESSION = old
    assert {"schema", "suites", "kernels", "metrics", "macro_models",
            "total_wall_s", "total_dispatches", "device"} <= set(got)
    assert got["schema"] == want["schema"] and got["device"] == "cpu"
    assert got["kernels"] == want["kernels"] and got["kernels"]
    if "table3" in suites:
        assert "table3.vec_cycles" in got["kernels"]["dropout"]
        assert "pareto_cap3_l14.cycles" in got["kernels"]["gemv"]
        assert got["suites"]["fig2"]["dispatches"] == 0
    else:
        assert "policy_headroom_cap4.fifo_no_fetch_cycles" in got[
            "kernels"]["flashattention2"]
    assert got["metrics"].keys() == want["metrics"].keys()
    assert got["macro_models"] == want["macro_models"]
    for suite in suites:
        rec, ref = got["suites"][suite], want["suites"][suite]
        assert "compiles" not in rec
        assert rec["rows"] == ref["rows"]
        assert rec["device"] == "cpu"
        assert rec["launches"] == {"engine_reg": 0, "engine_l1": 0,
                                   "cluster_l2": 0}
        assert len(rec["sweeps"]) == len(ref["sweeps"])
        for s, r in zip(rec["sweeps"], ref["sweeps"]):
            for key in ("axes", "points", "fold", "kernel_params",
                        "derived"):
                assert s[key] == r[key], (suite, key)
            assert "compiles" not in s
        assert rec["dispatches"] == sum(s["dispatches"]
                                        for s in rec["sweeps"])


def test_run_merges_the_roofline_record(tmp_path):
    """The roofline drives its kernels itself: its launches and plain
    calls and its json_extra() payload land in its suite record."""
    got = _report(trun.main, tmp_path / "port.json",
                  ["--max-events", "1000", "--device", "cpu"],
                  ["roofline", "vmem_dispersion"])
    roof = got["suites"]["roofline"]
    assert roof["device"] == "cpu" and roof["dispatches"] == 0
    assert roof["extra"]["device"] == "cpu" and roof["extra"]["rows"]
    assert set(roof["launches"]) >= {"engine_reg", "matmul_grouped",
                                     "matmul_dispersed", "flash_attention"}
    assert not any(roof["launches"].values())
    assert sum(roof["plain_calls"].values()) > 0
    assert roof["rows"] == len(roof["extra"]["rows"])
    assert got["suites"]["vmem_dispersion"]["rows"] == 6


@pytest.mark.parametrize("suite", ["network_sweep"])
def test_run_refuses_unported_suites(suite, tmp_path):
    """The last suite the port lacked runs: network_sweep exits 0 with
    its whole grid (50 rows, 350 points) at a truncated budget, its
    record counting engine calls and launches, not compiles."""
    path = tmp_path / "net.json"
    from repro_torch import rvv as trvv
    before = set(trvv.BENCHMARKS)
    try:
        assert trun.main(["--device", "cpu", "--max-events", "100",
                          "--json", str(path), suite]) == 0
    finally:
        for name in set(trvv.BENCHMARKS) - before:
            del trvv.BENCHMARKS[name]
    rec = json.loads(path.read_text())["suites"][suite]
    assert rec["rows"] == 50 and rec["dispatches"] == 2
    assert rec["extra"]["points"] == 350
    assert len(rec["extra"]["networks"]) == 5
    assert "compiles" not in rec and "compiles" not in rec["extra"]


def test_run_refuses_bad_arguments(capsys):
    assert trun.main(["--device", "cpu", "nope"]) == 2
    assert "unknown suite(s) nope" in capsys.readouterr().err
    assert trun.main(["--device", "cpu", "--max-events", "0", "fig2"]) == 2
    assert trun.main(["--device", "cpu", "fig2", "--json"]) == 2
    assert set(trun.SUITES) == set(
        importlib.import_module("benchmarks.run").SUITES)


def test_run_needs_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would use it")
    old = tapi._DEFAULT_SESSION
    tapi._DEFAULT_SESSION = None
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trun.main(["fig4"])
    finally:
        tapi._DEFAULT_SESSION = old


@pytest.mark.parametrize("example", ["quickstart", "dispersion_analysis"])
def test_examples_run_on_the_cpu(example, capsys):
    mod = importlib.import_module(f"repro_torch.examples.{example}")
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    if example == "quickstart":
        assert "dispersed execution bit-identical" in out
        assert "min registers for >95% hit rate: 5" in out
        assert "VPU area  -53%   total area -23%" in out
        assert "area-cycles front: cVRF 3" in out
    else:
        assert "   3   0.500   0.500   0.500" in out
        assert "  4     2.18     29.4" in out


@pytest.mark.parametrize("w", (1, 2, 4, 8, 16))
def test_ops_traffic_models_equal_reference(w):
    """``kernels.ops`` exports the two closed-form traffic models as the
    reference's ``kernels/ops.py`` does; dispersion_analysis prints the
    GEMM's at granite-8b's MLP shape, and the attention model is held at
    the prefill's shape."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as tops
    kw = dict(block_m=128, block_k=512, working_set=w)
    assert tops.hbm_traffic_model(8192, 14336, 4096, **kw) == \
        jops.hbm_traffic_model(8192, 14336, 4096, **kw)
    kw = dict(block_q=128 * w, block_k=128)
    assert tops.flash_traffic_model(4, 32, 512 * w, 512 * w, 96, **kw) == \
        jops.flash_traffic_model(4, 32, 512 * w, 512 * w, 96, **kw)
