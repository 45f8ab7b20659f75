"""The port stands alone: it imports neither JAX nor the JAX package."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import jax\b|from jax\b|import repro\.|import repro\s*$|"
    r"from repro\.|from repro import)", re.MULTILINE)


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_port_and_chip_smoke_import_without_jax():
    mods = list(_port_modules())
    for m in ("repro_torch.serve.engine", "repro_torch.api",
              "repro_torch.metrics", "repro_torch.kernels.dispersed_gemm",
              "repro_torch.kernels.rmsnorm", "repro_torch.kernels.traffic",
              "repro_torch.kernels.ref", "repro_torch.benchmarks.roofline",
              "repro_torch.benchmarks.vmem_dispersion",
              "repro_torch.kernels.engine_scan", "repro_torch.core.simulator",
              "repro_torch.core.folding", "repro_torch.core.planner",
              "repro_torch.configs.paper_machine", "repro_torch.device"):
        assert m in mods, m
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_sources_name_no_jax_or_reference_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if FORBIDDEN.search(f.read_text())]
    assert not offenders, offenders


def test_chip_smoke_refuses_without_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: chip_smoke would run")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_kernel_build_needs_nvcc_and_names_libraries_by_source():
    import shutil
    from repro_torch.kernels import _build
    path = _build.library_path("flash_attention")
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path("flash_attention")
    assert path.name.startswith("libflash_attention-")
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc present: the build would run")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all(["flash_attention"])


def test_every_kernel_source_gets_its_own_library():
    from repro_torch.kernels import _build
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert names == ["dispersed_gemm", "engine_scan", "flash_attention",
                     "rmsnorm"]
    paths = {_build.library_path(n) for n in names}
    assert len(paths) == len(names)
    for name in names:
        assert _build.library_path(name).name.startswith(f"lib{name}-")


def test_shared_header_edit_renames_every_library(tmp_path, monkeypatch):
    import shutil
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = sorted(p.stem for p in csrc.glob("*.cu"))
    before = {n: _build.library_path(n) for n in names}
    header = csrc / "convert.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for n in names:
        assert _build.library_path(n) != before[n]
