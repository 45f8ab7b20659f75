"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``kernels/build/``
(listed in ``.gitignore``) at first use, and loaded with ``ctypes``.  The
library's file name carries a hash of its source and flags, so an edited
source is rebuilt and a stale library is never loaded.  Nothing here runs
at import time: the CPU tests import every module on machines without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def build_all(names=None) -> dict[str, str]:
    """Compile every named source (default: all of ``csrc/*.cu``) that has
    no library yet, one ``nvcc`` each, all started together.  Returns each
    name's compiler log (``-Xptxas -v``: registers, shared memory, spills);
    an empty log means the library was already built.  Raises on a failed
    build with the compiler's output."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = [name for name in names if not library_path(name).exists()]
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{logs[name]}")
        else:
            os.replace(tmp, out)          # atomic: readers never see a half
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    if name not in _LOADED:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        _LOADED[name] = ctypes.CDLL(str(path))
    return _LOADED[name]
