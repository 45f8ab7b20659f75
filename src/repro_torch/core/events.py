"""Instruction trace -> fixed-width per-instruction event matrices.

The Register Dispersion hardware checks the (up to three) vector operands of
an instruction *serially* in the ID stage (paper §3.2.1), then accesses the
data cache in EX for vector loads/stores.  Earlier versions of this engine
flattened those accesses into one event stream of length E ~ 2-3x the
instruction count and scanned it one event at a time.  The fused engine
instead keeps the *instruction* as the scan unit: each instruction owns

    REG slots  0..2:  [vs1?] [vs2?] [vd?]       (hardware tag-check order)
    MEM slots  0..1:  [line0?] [line1?]          (unaligned straddle in 1)

as masked lanes of fixed-width ``(T, 3)`` / ``(T, 2)`` matrices, so one
engine step retires one whole instruction with unrolled lane logic —
cutting the scan length ~2-3x and removing all per-event kind dispatch.

Event ordering (and therefore every counter) is identical to the flat
engine: timestamps are drawn from the *uncompacted* slot grid (vs1=0, vs2=1,
vd=2, mem0=3, mem1=4, scalar=5 within each instruction), a monotone map of
the old flat event index, so all relative-order decisions (L1 LRU ages,
cVRF LRU/FIFO/OPT metrics) are unchanged.

``v0`` (the RVV mask register) is pinned in a dedicated register and never
generates cVRF events (paper §3.1).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import isa
from repro_torch.core.trace import Program

# Slots per instruction in the uncompacted timestamp grid
# (vs1, vs2, vd, mem0, mem1, scalar).
NUM_SLOTS = 6

NO_NEXT_USE = np.int32(2**31 - 8)


@dataclasses.dataclass
class EventStream:
    """Per-instruction event matrices (T = number of instructions).

    REG slot order is the hardware's serial tag-check order: vs1, vs2, vd.
    """

    reg_valid: np.ndarray    # (T, 3) bool  REG slot carries a cVRF access
    reg: np.ndarray          # (T, 3) int8  architectural register id
    vd_writes: np.ndarray    # (T,)  bool   vd slot is a write
    vd_reads: np.ndarray     # (T,)  bool   vd slot must fetch (vmacc family)
    vd_no_fetch: np.ndarray  # (T,)  bool   full overwrite, fetch skippable
    lock_vs1: np.ndarray     # (T,)  int8   tag locked during vs2/vd checks
    lock_vs2: np.ndarray     # (T,)  int8   tag locked during vd check
    mem_valid: np.ndarray    # (T, 2) bool  data-cache access lanes
    mem_line: np.ndarray     # (T, 2) int32 cacheline index (-1 if invalid)
    mem_write: np.ndarray    # (T, 2) bool
    cost: np.ndarray         # (T,)  int32  base cycles of the instruction
    next_use: np.ndarray     # (T, 3) int32 Belady next-use grid index
    events_per_row: np.ndarray  # (T,) int8 flat-engine event count per instr
    spill_line0: int         # first cacheline of the reserved spill region
    num_instructions: int
    repeats: list            # periodicity metadata (see trace.Program)

    @property
    def num_events(self) -> int:
        """Events the flat (per-event) engine would have scanned."""
        return int(self.events_per_row.sum())


def _reg_valid(tbl, op, vd, vs1, vs2) -> np.ndarray:
    """(T, 3) REG-slot validity mask: which vs1/vs2/vd fields name live
    cVRF accesses (``v0`` is pinned and never generates one).  Shared by
    :func:`expand` and :func:`next_use_grid` so the fused engine and the
    interpreter's Belady pre-pass always see the same access set."""
    mask_reg = isa.MASK_REG
    reg_valid = np.zeros((op.shape[0], 3), np.bool_)
    # slot 0/1: vs1 / vs2 reads.
    reg_valid[:, 0] = tbl["reads_vs1"][op] & (vs1 >= 0) & (vs1 != mask_reg)
    reg_valid[:, 1] = tbl["reads_vs2"][op] & (vs2 >= 0) & (vs2 != mask_reg)
    # slot 2: vd access (read and/or write).
    reg_valid[:, 2] = ((tbl["reads_vd"][op] | tbl["writes_vd"][op])
                       & (vd >= 0) & (vd != mask_reg))
    return reg_valid


def expand(program: Program, rows: np.ndarray | None = None) -> EventStream:
    """Vectorised numpy expansion of a trace into per-instruction matrices.

    ``rows``: optional sorted row index array — expand only those
    instructions (used by ``core.folding`` to expand a folded trace without
    materialising the full one).
    """
    tbl = isa.op_table()
    op, vd, vs1, vs2 = program.op, program.vd, program.vs1, program.vs2
    addr, cost_override = program.addr, program.cost_override
    if rows is not None:
        op, vd, vs1, vs2 = op[rows], vd[rows], vs1[rows], vs2[rows]
        addr, cost_override = addr[rows], cost_override[rows]
    T = op.shape[0]

    r_vd = tbl["reads_vd"][op]
    w_vd = tbl["writes_vd"][op]
    full_ow = tbl["full_overwrite"][op]
    is_load = tbl["is_load"][op]
    is_store = tbl["is_store"][op]
    cost = np.where(cost_override >= 0, cost_override,
                    tbl["cost"][op]).astype(np.int32)

    reg_valid = _reg_valid(tbl, op, vd, vs1, vs2)
    reg = np.zeros((T, 3), np.int8)
    reg[:, 0], reg[:, 1], reg[:, 2] = vs1, vs2, vd
    # Serial tag check (paper 3.2.1): vs2's miss handling must not evict the
    # already-resolved vs1; vd's must not evict vs1 or vs2.
    lock_vs1 = np.where(reg_valid[:, 0], vs1, -1).astype(np.int8)
    lock_vs2 = np.where(reg_valid[:, 1], vs2, -1).astype(np.int8)

    # MEM lanes: data-cache lines touched by vector loads/stores.
    is_mem = is_load | is_store
    nbytes = np.where((op == isa.VBCAST) | (op == isa.VSES), 4,
                      isa.VLEN_BYTES)
    line0 = addr >> 5
    line1 = (addr + nbytes - 1) >> 5
    mem_valid = np.zeros((T, 2), np.bool_)
    mem_line = np.full((T, 2), -1, np.int32)
    mem_valid[:, 0] = is_mem
    mem_line[:, 0] = np.where(is_mem, line0, -1)
    mem_valid[:, 1] = is_mem & (line1 != line0)     # unaligned straddle
    mem_line[:, 1] = np.where(mem_valid[:, 1], line1, -1)
    mem_write = mem_valid & is_store[:, None]

    events = (reg_valid.sum(1) + mem_valid.sum(1)
              + (op == isa.SCALAR)).astype(np.int8)
    ev = EventStream(
        reg_valid=reg_valid,
        reg=reg.astype(np.int8),
        vd_writes=(w_vd & reg_valid[:, 2]),
        vd_reads=(r_vd & reg_valid[:, 2]),
        vd_no_fetch=(full_ow & w_vd & ~r_vd & reg_valid[:, 2]),
        lock_vs1=lock_vs1,
        lock_vs2=lock_vs2,
        mem_valid=mem_valid,
        mem_line=mem_line,
        mem_write=mem_write,
        cost=cost,
        next_use=_next_use(reg, reg_valid),
        events_per_row=events,
        spill_line0=(program.memory.nbytes + isa.VLEN_BYTES - 1)
        // isa.VLEN_BYTES + 4,
        num_instructions=T,
        repeats=list(program.repeats) if rows is None else [],
    )
    return ev


def next_use_grid(program: Program) -> np.ndarray:
    """(T, 3) Belady next-use indices for a program's vs1/vs2/vd REG slots.

    The shared index space (row-major over the (T, 3) slot grid) is what the
    fused engine feeds OPT; the numpy interpreter uses this helper so its
    OPT victim choices compare the exact same farthest-next-use metric —
    the precondition for OPT rows of the differential conformance matrix.
    """
    op, vd, vs1, vs2 = program.op, program.vd, program.vs1, program.vs2
    reg_valid = _reg_valid(isa.op_table(), op, vd, vs1, vs2)
    reg = np.stack([vs1, vs2, vd], axis=1).astype(np.int8)
    return _next_use(reg, reg_valid)


def _next_use(reg: np.ndarray, reg_valid: np.ndarray) -> np.ndarray:
    """Belady next-use grid indices for REG slots, one stable-argsort pass.

    Index space is the row-major (T, 3) REG-slot grid — a monotone map of
    event order, which is all OPT's farthest-next-use comparison needs.
    """
    T = reg.shape[0]
    flat_valid = reg_valid.ravel()
    idx = np.flatnonzero(flat_valid)
    regs_here = reg.ravel()[idx]
    # Stable sort groups by register while keeping ascending event order
    # inside each group, so each entry's successor is its next use.
    order = np.argsort(regs_here, kind="stable")
    si = idx[order]
    sr = regs_here[order]
    nxt = np.full(T * 3, NO_NEXT_USE, np.int32)
    if si.size > 1:
        same = sr[:-1] == sr[1:]
        nxt[si[:-1][same]] = si[1:][same].astype(np.int32)
    return nxt.reshape(T, 3)


def _next_use_naive(reg: np.ndarray, reg_valid: np.ndarray) -> np.ndarray:
    """Reference implementation of :func:`_next_use` (per-register loop)."""
    T = reg.shape[0]
    nxt = np.full(T * 3, NO_NEXT_USE, np.int32)
    idx = np.flatnonzero(reg_valid.ravel())
    regs_here = reg.ravel()[idx]
    for r in np.unique(regs_here):
        ri = idx[regs_here == r]
        if ri.size > 1:
            nxt[ri[:-1]] = ri[1:]
    return nxt.reshape(T, 3)
