"""Shared helpers for the RVV-lite benchmark kernels (paper Table 2)."""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable

import numpy as np

from repro_torch.core.simulator import ScalarCost
from repro_torch.core.trace import Assembler, MemoryMap, Program

BIG = np.float32(1e30)


@dataclasses.dataclass
class Built:
    """A built benchmark: the trace plus its expected outputs.

    ``expected`` maps buffer name -> expected contents; ``regions`` maps
    buffer name -> (expected 2-D array, (rows, row_stride_words)) for kernels
    whose valid output is a sub-rectangle of a padded buffer.
    """

    program: Program
    expected: dict[str, np.ndarray]   # buffer name -> expected final contents
    rtol: float = 1e-4                # reference computed in f64; trace is f32
    atol: float = 1e-5
    regions: dict[str, tuple[np.ndarray, int]] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class Benchmark:
    name: str
    domain: str
    build: Callable[..., Built]
    scalar_cost: Callable[..., ScalarCost]
    paper_params: dict
    reduced_params: dict
    table2: str = ""                   # the paper's Table 2 description


class BenchmarkRegistry(dict):
    """``name -> Benchmark`` map populated by :func:`register_benchmark`.

    Unknown lookups raise with the sorted list of registered kernels, so a
    typo'd sweep axis fails with the menu instead of a bare KeyError.
    """

    def __missing__(self, name):
        raise KeyError(
            f"unknown kernel {name!r}; available: "
            f"{', '.join(sorted(self))}")


BENCHMARKS: BenchmarkRegistry = BenchmarkRegistry()


def register_benchmark(name: str, *, domain: str, paper_params: dict,
                       reduced_params: dict, table2: str = "",
                       scalar_cost: Callable[..., ScalarCost] | None = None,
                       exist_ok: bool = False):
    """Decorator registering a kernel's ``build`` function as a Benchmark.

    ``scalar_cost`` defaults to the decorated module's ``scalar_cost``
    function, resolved lazily (kernel modules conventionally define it below
    ``build``).  A module may stack the decorator to register several named
    configurations of one build function (see ``rvv.gemm``).

    ``exist_ok=True`` makes re-registration of the same name idempotent (the
    first registration wins); the trace-from-model bridge uses this so that
    lowering the same network twice — or two networks sharing a layer shape —
    does not raise.  Hand-written kernels keep the default duplicate check.
    """
    def deco(build: Callable[..., Built]) -> Callable[..., Built]:
        cost = scalar_cost
        if cost is None:
            mod = sys.modules[build.__module__]
            cost = lambda **kw: mod.scalar_cost(**kw)  # noqa: E731
        if name in BENCHMARKS:
            if exist_ok:
                return build
            raise ValueError(f"benchmark {name!r} registered twice")
        BENCHMARKS[name] = Benchmark(name, domain, build, cost,
                                     dict(paper_params), dict(reduced_params),
                                     table2)
        return build
    return deco


def get_benchmark(name: str) -> Benchmark:
    """Registry lookup; unknown names raise with the available kernels."""
    return BENCHMARKS[name]


def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def check(built: Built, memory: np.ndarray) -> None:
    """Assert every expected buffer matches the interpreter's final memory."""
    for name, want in built.expected.items():
        got = built.program.buffer_view(memory, name)[: want.size]
        np.testing.assert_allclose(
            got, want.reshape(-1), rtol=built.rtol, atol=built.atol,
            err_msg=f"buffer {name!r} mismatch")
    for name, (want2d, stride_words) in built.regions.items():
        r, cwid = want2d.shape
        got = built.program.buffer_view(memory, name)
        got2d = got[: r * stride_words].reshape(r, stride_words)[:, :cwid]
        np.testing.assert_allclose(
            got2d, want2d, rtol=built.rtol, atol=built.atol,
            err_msg=f"buffer region {name!r} mismatch")


# ------------------------------------------------------------------ exp ----
# Vectorised exp approximation used by FlashAttention-2: RVV has no exp
# instruction, so real kernels use a short polynomial / squaring scheme.
# exp(x) ~= (1 + clamp(x, -60, 0)/32)**32  (monotone, strictly positive, and
# identical in the trace and the numpy reference).

EXP_SQUARINGS = 5
EXP_DENOM = float(2 ** EXP_SQUARINGS)
EXP_CLAMP = -60.0


def emit_exp(a: Assembler, r: int, r_clamp: int) -> None:
    """In-place exp approximation of register ``r``; ``r_clamp`` must hold
    broadcast EXP_CLAMP. Exercises the v0 mask path (vmslt + vmerge)."""
    a.vmslt(r, r_clamp)            # v0 = (x < -60)
    a.vmerge(r, r_clamp, r)        # x = v0 ? -60 : x
    a.vmul_sc(r, r, 1.0 / EXP_DENOM)
    a.vadd_sc(r, r, 1.0)
    for _ in range(EXP_SQUARINGS):
        a.vmul(r, r, r)


def np_exp_approx(x: np.ndarray) -> np.ndarray:
    x = np.maximum(x, EXP_CLAMP)
    t = 1.0 + x / EXP_DENOM
    for _ in range(EXP_SQUARINGS):
        t = t * t
    return t
