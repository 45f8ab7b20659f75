"""Functional RVV-lite interpreters (numpy test oracles).

Two execution modes:

  * :func:`run` — conventional full VRF: 32 physical vector registers.
  * :func:`run_dispersed` — the paper's mechanism operating on *data*:
    ``capacity`` physical registers + a pinned ``v0`` + the reserved spill
    region inside simulated memory.  Misses trigger actual spill/fill data
    movement exactly as §3.2 describes.

Register Dispersion must be **semantics-preserving**: for any program and any
capacity >= 3 (three operands must be co-resident), ``run_dispersed`` must
produce bit-identical memory/registers to ``run``.  Property tests in
``tests/test_property_dispersion.py`` check this on random programs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import events as ev_mod
from repro_torch.core import isa, policies
from repro_torch.core.trace import Program

VL = isa.VL_ELEMS


@dataclasses.dataclass
class RunResult:
    memory: np.ndarray              # final memory image (f32 words)
    vregs: np.ndarray               # (32, VL) final architectural registers
    vrf_hits: int = 0
    vrf_misses: int = 0
    spills: int = 0
    fills: int = 0


def _exec_op(op, vd_val, vs1_val, vs2_val, imm, mask):
    """Pure f32 semantics of one vector instruction. Returns new vd value
    (or None) and new mask (or None)."""
    f = np.float32
    if op == isa.VADD:
        return vs1_val + vs2_val, None
    if op == isa.VSUB:
        return vs1_val - vs2_val, None
    if op == isa.VMUL:
        return vs1_val * vs2_val, None
    if op == isa.VDIV:
        with np.errstate(divide="ignore", invalid="ignore"):
            return (vs1_val / vs2_val).astype(f), None
    if op == isa.VSQRT:
        with np.errstate(invalid="ignore"):
            return np.sqrt(vs1_val).astype(f), None
    if op == isa.VFMA:
        return (vd_val + vs1_val * vs2_val).astype(f), None
    if op == isa.VMAX:
        return np.maximum(vs1_val, vs2_val), None
    if op == isa.VMIN:
        return np.minimum(vs1_val, vs2_val), None
    if op == isa.VREDSUM:
        out = np.zeros(VL, f)
        out[0] = f(vs1_val[0]) + vs2_val.astype(np.float64).sum().astype(f)
        return out, None
    if op == isa.VREDMAX:
        out = np.zeros(VL, f)
        out[0] = max(f(vs1_val[0]), vs2_val.max())
        return out, None
    if op == isa.VMVV:
        return vs1_val.copy(), None
    if op == isa.VCMPLT:
        return None, (vs1_val < vs2_val).astype(f)
    if op == isa.VMERGE:
        return np.where(mask > 0, vs1_val, vs2_val).astype(f), None
    if op == isa.VSLIDE1DN:
        return np.concatenate([vs1_val[1:], [f(imm)]]).astype(f), None
    if op == isa.VSLIDE1UP:
        return np.concatenate([[f(imm)], vs1_val[:-1]]).astype(f), None
    if op == isa.VXOR:
        a = vs1_val.view(np.int32) ^ vs2_val.view(np.int32)
        return a.view(f).copy(), None
    if op == isa.VMULSC:
        return (vs1_val * f(imm)).astype(f), None
    if op == isa.VADDSC:
        return (vs1_val + f(imm)).astype(f), None
    raise ValueError(f"unhandled op {op}")


def run(program: Program) -> RunResult:
    """Full-VRF functional execution."""
    mem = program.memory.copy()
    regs = np.zeros((isa.NUM_ARCH_VREGS, VL), np.float32)
    for i in range(program.num_instructions):
        op = int(program.op[i])
        if op == isa.SCALAR:
            continue
        vd, vs1, vs2 = (int(program.vd[i]), int(program.vs1[i]),
                        int(program.vs2[i]))
        addr, imm = int(program.addr[i]), float(program.imm[i])
        if op == isa.VLE:
            regs[vd] = mem[addr // 4: addr // 4 + VL]
        elif op == isa.VSE:
            mem[addr // 4: addr // 4 + VL] = regs[vs1]
        elif op == isa.VSES:
            mem[addr // 4] = regs[vs1][0]
        elif op == isa.VBCAST:
            regs[vd] = mem[addr // 4]
        else:
            vd_val = regs[vd] if vd >= 0 else None
            res, new_mask = _exec_op(
                op, vd_val, regs[vs1] if vs1 >= 0 else None,
                regs[vs2] if vs2 >= 0 else None, imm, regs[isa.MASK_REG])
            if new_mask is not None:
                regs[isa.MASK_REG] = new_mask
            elif res is not None:
                regs[vd] = res
    return RunResult(memory=mem, vregs=regs)


class _DispersedRF:
    """Data-holding cVRF: capacity physical slots + pinned v0 + spill region."""

    def __init__(self, capacity: int, policy: int, mem: np.ndarray,
                 spill_word0: int):
        self.capacity = capacity
        self.policy = policy
        self.mem = mem
        self.spill_word0 = spill_word0           # f32-word index of v1's home
        self.phys = np.zeros((capacity, VL), np.float32)
        self.tags = np.full(capacity, -1, np.int64)
        self.dirty = np.zeros(capacity, bool)
        self.ins_seq = np.zeros(capacity, np.int64)
        self.last_use = np.zeros(capacity, np.int64)
        self.freq = np.zeros(capacity, np.int64)
        self.next_use = np.zeros(capacity, np.int64)
        self.pinned = np.zeros(capacity, bool)
        self.v0 = np.zeros(VL, np.float32)       # dedicated mask register
        self.seq = 0
        self.now = 0
        self.hits = self.misses = self.spills = self.fills = 0

    def _home(self, reg: int) -> int:
        assert reg >= 1
        return self.spill_word0 + (reg - 1) * VL

    def access(self, reg: int, *, write: bool, read: bool,
               next_use: int = 0, locked=()) -> int:
        """Bring ``reg`` into the physical file; returns its slot index."""
        self.now += 1
        if reg == isa.MASK_REG:
            return -1                             # pinned, handled separately
        where = np.nonzero(self.tags == reg)[0]
        if where.size:
            s = int(where[0])
            self.hits += 1
            self.last_use[s] = self.now
            self.freq[s] += 1
            self.next_use[s] = next_use
            self.dirty[s] |= write
            return s
        self.misses += 1
        free = np.nonzero(self.tags < 0)[0]
        if free.size:
            s = int(free[0])
        else:
            s = policies.np_select_victim(
                self.tags, self.ins_seq, self.last_use, self.freq,
                self.next_use, self.pinned, self.capacity, self.policy,
                locked=locked)
            if self.dirty[s]:                     # spill evictee to its home
                h = self._home(int(self.tags[s]))
                self.mem[h: h + VL] = self.phys[s]
                self.spills += 1
        # Fill from the reserved address (the paper always fetches; a value
        # that was never spilled reads the zero-initialised home location,
        # matching the zero-initialised registers of ``run``).
        h = self._home(reg)
        self.phys[s] = self.mem[h: h + VL]
        self.fills += 1
        self.tags[s] = reg
        self.dirty[s] = write
        self.seq += 1
        self.ins_seq[s] = self.seq
        self.last_use[s] = self.now
        self.freq[s] = 1
        self.next_use[s] = next_use
        return s


def run_dispersed(program: Program, capacity: int,
                  policy: int = policies.FIFO) -> RunResult:
    """Register-Dispersion execution: semantics must match :func:`run`.

    For OPT the interpreter runs a Belady pre-pass
    (:func:`repro_torch.core.events.next_use_grid`): every register access
    carries the grid index of that register's next use, in the same (T, 3) slot
    index space the fused engine scans, so both engines' farthest-next-use
    victim choices — and therefore the differential counters — agree
    bit-for-bit.
    """
    if capacity < 3:
        raise ValueError("cVRF must hold at least 3 registers (3 operands)")
    spill_bytes = (isa.NUM_ARCH_VREGS - 1) * isa.VLEN_BYTES
    base = program.memory.size * 4
    base = (base + isa.VLEN_BYTES - 1) // isa.VLEN_BYTES * isa.VLEN_BYTES
    mem = np.zeros((base + spill_bytes) // 4, np.float32)
    mem[: program.memory.size] = program.memory
    rf = _DispersedRF(capacity, policy, mem, base // 4)

    # Belady pre-pass: OPT needs each access's next-use index; the other
    # policies ignore it (the accessor stores it but never reads it back).
    nxt = (ev_mod.next_use_grid(program) if policy == policies.OPT
           else np.zeros((program.num_instructions, 3), np.int32))

    tbl = isa.op_table()
    for i in range(program.num_instructions):
        op = int(program.op[i])
        if op == isa.SCALAR:
            continue
        vd, vs1, vs2 = (int(program.vd[i]), int(program.vs1[i]),
                        int(program.vs2[i]))
        addr, imm = int(program.addr[i]), float(program.imm[i])

        def val(reg, slot):
            return rf.v0 if reg == isa.MASK_REG else rf.phys[slot]

        s1 = (rf.access(vs1, write=False, read=True,
                        next_use=int(nxt[i, 0]))
              if tbl["reads_vs1"][op] and vs1 >= 0 else -1)
        s2 = (rf.access(vs2, write=False, read=True, locked=(vs1,),
                        next_use=int(nxt[i, 1]))
              if tbl["reads_vs2"][op] and vs2 >= 0 else -1)
        sd = -1
        if (tbl["reads_vd"][op] or tbl["writes_vd"][op]) and vd >= 0:
            sd = rf.access(vd, write=bool(tbl["writes_vd"][op]),
                           read=bool(tbl["reads_vd"][op]),
                           locked=(vs1, vs2), next_use=int(nxt[i, 2]))

        if op == isa.VLE:
            out = rf.mem[addr // 4: addr // 4 + VL].copy()
            if vd == isa.MASK_REG:
                rf.v0 = out
            else:
                rf.phys[sd] = out
        elif op == isa.VSE:
            rf.mem[addr // 4: addr // 4 + VL] = val(vs1, s1)
        elif op == isa.VSES:
            rf.mem[addr // 4] = val(vs1, s1)[0]
        elif op == isa.VBCAST:
            out = np.full(VL, rf.mem[addr // 4], np.float32)
            if vd == isa.MASK_REG:
                rf.v0 = out
            else:
                rf.phys[sd] = out
        else:
            res, new_mask = _exec_op(
                op,
                val(vd, sd) if vd >= 0 else None,
                val(vs1, s1) if vs1 >= 0 else None,
                val(vs2, s2) if vs2 >= 0 else None,
                imm, rf.v0)
            if new_mask is not None:
                rf.v0 = new_mask
            elif res is not None:
                if vd == isa.MASK_REG:
                    rf.v0 = res
                else:
                    rf.phys[sd] = res

    # Reconstruct the architectural register file for comparison: cached
    # registers from the cVRF, everything else from its home address.
    vregs = np.zeros((isa.NUM_ARCH_VREGS, VL), np.float32)
    for r in range(1, isa.NUM_ARCH_VREGS):
        h = rf._home(r)
        vregs[r] = rf.mem[h: h + VL]
    for s in range(capacity):
        if rf.tags[s] >= 0:
            vregs[int(rf.tags[s])] = rf.phys[s]
    vregs[isa.MASK_REG] = rf.v0
    return RunResult(memory=rf.mem[: program.memory.size], vregs=vregs,
                     vrf_hits=rf.hits, vrf_misses=rf.misses,
                     spills=rf.spills, fills=rf.fills)
