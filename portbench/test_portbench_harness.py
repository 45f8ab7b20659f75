"""CPU tests of the benchmark's harness: every file found by name, the
traffic a function of the seed, the yardstick's counts, the imports."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from portbench import harness, traffic, weights, yardstick  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    spec = harness.cell_spec(workload, BENCH)
    assert spec["config"]["kind"] in ("sim", "train")
    assert harness.driver(spec["config"]["kind"]).run_cell
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    ref = ROOT / "portbench" / spec["config"]["reference"]
    assert ref.exists()
    if spec["config"]["kind"] == "train":
        assert (ROOT / "portbench" / "limits" / f"{workload}.json").exists()


def test_every_metric_and_config_has_its_file():
    for m in BENCH["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists()
    for w in BENCH["workloads"]:
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json"
                ).exists()


@pytest.mark.parametrize("metric", [
    "sim.sweep_p90_ms", "sim.front_ms", "sim.engine_host_ms",
    "sim.k1_device_ms", "sim.k1_roofline_pct", "sim.device_idle_pct"])
def test_paper_sweep_files_stand_ready(metric):
    """The paper's design-space sweep (``configs/rvv-paper.json``,
    traffic ``dse``) has its configuration, driver, reference and
    readers, so that its cell is added by entries alone."""
    pkg = ROOT / "portbench"
    cfg = json.loads((pkg / "configs" / "rvv-paper.json").read_text())
    assert cfg["kind"] == "sim" and len(cfg["programs"]) == 11
    assert set(cfg["programs"]) == set(yardstick.INSTRUCTIONS)
    assert harness.driver(cfg["kind"]).run_cell
    assert (pkg / cfg["reference"]).exists()
    assert (pkg / "traffic" / "dse.json").exists()
    assert callable(harness.metric_reader(metric))


def test_unknown_workload_refused():
    with pytest.raises(harness.CellError):
        harness.cell_spec("no.such.cell", BENCH)


def _mix(name):
    return json.loads((ROOT / "portbench" / "traffic" / f"{name}.json"
                       ).read_text())


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40 + 3])
def test_sweep_queries_follow_the_seed(seed):
    mix = _mix("dse")
    a = traffic.sweep_queries(mix, [4, 16], seed, 64)
    assert a == traffic.sweep_queries(mix, [4, 16], seed, 64)
    assert a != traffic.sweep_queries(mix, [4, 16], seed + 1, 64)
    # every seed offers the same work: one query per geometry a block
    for i in range(0, 64, 2):
        assert sorted(a[i:i + 2]) == [0, 1]


@pytest.mark.parametrize("name", ["4x1024", "1x4096"])
def test_documents_follow_the_seed(name):
    mix = dict(_mix(name), batch=2, seq_len=300)
    docs = traffic.Documents(mix, 32064, 32000)
    a = docs.tokens(2**31 + 5, 0)
    assert a.shape == (2, 301)
    assert (a == docs.tokens(2**31 + 5, 0)).all()
    assert not (a == docs.tokens(2**31 + 6, 0)).all()
    assert not (a == docs.tokens(2**31 + 5, 1)).all()
    assert not (a[0] == a[1]).all()
    assert a.min() >= 0 and a.max() < 32064
    # documents are joined by the end-of-text token
    assert any((docs.tokens(2**31 + 5, s) == 32000).any() for s in range(20))


def test_instruction_counts():
    assert sum(yardstick.INSTRUCTIONS.values()) == 15_807_727
    assert yardstick.INSTRUCTIONS["resnet50_l10"] == 9_671_553


def test_k1_bytes_bound_by_hand():
    # 15,807,727 rows of 9 bytes and 6,600 points of 12 int32 counters
    assert yardstick.k1_bytes_bound(15_807_727, 6_600) == (
        142_269_543 + 316_800)


def test_phi3_flops_by_hand():
    cfg = json.loads((ROOT / "portbench" / "configs" /
                      "phi3-mini-3.8b.json").read_text())
    d, L, ff, V = 3072, 32, 8192, 32064
    matmul = L * (4 * d * d + 3 * d * ff) + d * V
    assert matmul == yardstick.dense_matmul_params(cfg) == 3_722_379_264
    assert yardstick.dense_params(cfg) == matmul + V * d + 65 * d \
        == 3_821_079_552
    # 4 x 1,024: the window of 2,047 keys masks nothing
    keys = 4 * 1024 * 1025 // 2
    assert yardstick.dense_lm_flops(cfg, 4, 1024) == (
        6 * matmul * 4096 + 12 * d * L * keys)
    # 1 x 4,096: the first 2,047 queries see 1..2,047 keys, the rest 2,047
    keys = 2047 * 2048 // 2 + (4096 - 2047) * 2047
    assert yardstick.attended_keys(4096, 2047) == keys
    assert yardstick.dense_lm_flops(cfg, 1, 4096) == (
        6 * matmul * 4096 + 12 * d * L * keys)


def test_weights_cover_the_published_widths():
    cfg = json.loads((ROOT / "portbench" / "configs" /
                      "phi3-mini-3.8b.json").read_text())
    total = sum(math.prod(s) for _, s, _ in weights.leaves(cfg))
    assert total == yardstick.dense_params(cfg)


def test_what_a_run_loads_holds_no_jax():
    """The harness, every driver, reader and reference, and the program
    modules the drivers call, loaded in a fresh process: no top-level
    module named jax, jaxlib, flax or repro (whole names)."""
    code = """
import sys, importlib
from pathlib import Path
from portbench import harness
import portbench.run
from portbench.drivers import sim, train
from portbench.reference import dense_lm, rvv_walk, rvvtrace
import json
bench = json.load(open("BENCHMARK.json"))
for m in bench["per_layer"]:
    harness.metric_reader(m["name"])
from repro_torch import api
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.train.train_step import make_train_step
print(sorted({n.split('.')[0] for n in sys.modules}))
print(harness.forbidden_loaded())
"""
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    top = eval(out.stdout.splitlines()[-2])
    assert "repro_torch" in top
    assert out.stdout.splitlines()[-1] == "[]"
    assert not {"jax", "jaxlib", "flax", "repro"} & set(top)


def test_reference_imports_nothing_of_the_program():
    code = """
import sys
from portbench.reference import dense_lm, rvv_walk, rvvtrace
print(sorted({n.split('.')[0] for n in sys.modules}))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    top = set(eval(out.stdout.splitlines()[-1]))
    assert not {"repro_torch", "repro", "jax"} & top


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}",
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
