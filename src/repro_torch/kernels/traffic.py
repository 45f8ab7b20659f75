"""Instrumented HBM traffic counting for block schedules.

Numpy copy of ``repro/kernels/traffic.py`` (the JAX package cannot be
imported by the port).  It walks a schedule's grid in the reference's
iteration order (row-major, last dimension fastest) and counts the block
transfers that schedule issues, using the same index maps the schedule is
built from.  On the card the count is the *schedule's*: a block that the
H100's 50 MB L2 serves again is still counted as a transfer.

Counting semantics per :class:`Part` kind:

  * ``"in"`` — an input block is fetched once per *run* of consecutive
    grid steps mapping to the same block index (a block stays resident
    while its index is unchanged and is refetched when it changes back
    later).
  * ``"out"`` — a pure output block is written exactly once (the final
    writeback).
  * ``"acc"`` — a memory-resident accumulator (the dispersed schedule's
    output tile) is *filled and spilled* once per run: every revisit
    round-trips, which is the paper's spill/fill traffic at block
    granularity.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

KINDS = ("in", "out", "acc")


@dataclasses.dataclass(frozen=True)
class Part:
    """One memory-backed operand of a schedule: a block size in bytes, the
    index map, and the counting kind (see module docstring)."""

    name: str
    block_bytes: int
    index_map: Callable
    kind: str

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"part {self.name!r}: kind must be one of {KINDS}, "
                f"got {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A schedule's traffic geometry: the grid plus its operand parts."""

    grid: tuple[int, ...]
    parts: tuple[Part, ...]

    def steps(self) -> int:
        return int(np.prod(self.grid))


def count(schedule: Schedule) -> dict[str, int]:
    """Walk the grid and count bytes moved per part (+ ``"total"``), in
    row-major order with the last grid dimension fastest."""
    runs = {p.name: 0 for p in schedule.parts}
    seen: dict[str, set] = {p.name: set() for p in schedule.parts}
    prev: dict[str, object] = {p.name: None for p in schedule.parts}
    for idx in np.ndindex(*schedule.grid):
        for p in schedule.parts:
            block = p.index_map(*idx)
            if block != prev[p.name]:
                runs[p.name] += 1
                prev[p.name] = block
                seen[p.name].add(block)
    out = {}
    for p in schedule.parts:
        if p.kind == "in":
            out[p.name] = runs[p.name] * p.block_bytes
        elif p.kind == "out":
            out[p.name] = len(seen[p.name]) * p.block_bytes
        else:                                   # "acc": fill + spill per run
            out[p.name] = 2 * runs[p.name] * p.block_bytes
    out["total"] = sum(out.values())
    return out
