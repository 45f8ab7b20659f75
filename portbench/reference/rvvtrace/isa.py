"""RVV-lite instruction set used by the Register Dispersion simulator.

The paper targets the RISC-V "V" extension on a 3-stage in-order core with a
256-bit / 8-lane VPU (Table 1).  We model the subset of RVV that the paper's
benchmark suite (Table 2) exercises, at the granularity the cVRF mechanism
cares about: which *architectural vector registers* each instruction reads and
writes, whether the destination is also a source (``vmacc``/``vmadd``-style),
whether the instruction is masked (reads the pinned ``v0``), and its memory
behaviour.

Vector length: VL = 256 bits = 8 x f32 elements = one 32-byte cacheline, per
the paper's constraint that VL never exceeds the cacheline size so a vector
load is a single micro-op.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# ----------------------------------------------------------------------------
# Machine parameters (Table 1 of the paper).
# ----------------------------------------------------------------------------
VLEN_BITS = 256
ELEM_BITS = 32
VL_ELEMS = VLEN_BITS // ELEM_BITS            # 8 f32 elements per vector reg
VLEN_BYTES = VLEN_BITS // 8                  # 32 bytes = one cacheline
NUM_ARCH_VREGS = 32                          # RVV mandates 32 architectural regs
MASK_REG = 0                                 # v0: pinned, never dispersed

# ----------------------------------------------------------------------------
# Opcodes.
# ----------------------------------------------------------------------------
SCALAR = 0        # scalar bookkeeping (loop counters, pointer bumps, branches)
VLE = 1           # unit-stride vector load   vd <- mem[addr : addr+32]
VSE = 2           # unit-stride vector store  mem[addr : addr+32] <- vs1
VADD = 3          # vd = vs1 + vs2
VSUB = 4          # vd = vs1 - vs2
VMUL = 5          # vd = vs1 * vs2
VDIV = 6          # vd = vs1 / vs2
VSQRT = 7         # vd = sqrt(vs1)
VFMA = 8          # vd = vd + vs1 * vs2      (vmacc: destination is a source)
VMAX = 9          # vd = max(vs1, vs2)
VMIN = 10         # vd = min(vs1, vs2)
VREDSUM = 11      # vd[0] = vs1[0] + sum(vs2)  (reads vs1 seed; writes vd)
VREDMAX = 12      # vd[0] = max(vs1[0], max(vs2))
VBCAST = 13       # vd = broadcast(mem_scalar[addr])   (flw + vfmv.v.f macro)
VMVV = 14         # vd = vs1                  (vmv.v.v register move)
VCMPLT = 15       # v0 = (vs1 < vs2)          (writes the pinned mask register)
VMERGE = 16       # vd = v0 ? vs1 : vs2       (masked merge; reads v0)
VSLIDE1DN = 17    # vd = {vs1[1:], x}         (slide down one element)
VSLIDE1UP = 18    # vd = {x, vs1[:-1]}        (slide up one element)
VXOR = 19         # vd = bitwise-ish xor (modelled on f32 lanes as a*0+b style)
VMULSC = 20       # vd = vs1 * scalar_imm     (vector-scalar multiply)
VADDSC = 21       # vd = vs1 + scalar_imm
VSES = 22         # mem[addr] <- vs1[0]        (vfmv.f.s + fsw macro, 4 bytes)

NUM_OPS = 23

OP_NAMES = {
    SCALAR: "scalar", VLE: "vle", VSE: "vse", VADD: "vadd", VSUB: "vsub",
    VMUL: "vmul", VDIV: "vdiv", VSQRT: "vsqrt", VFMA: "vmacc", VMAX: "vmax",
    VMIN: "vmin", VREDSUM: "vredsum", VREDMAX: "vredmax", VBCAST: "vbcast",
    VMVV: "vmv.v.v", VCMPLT: "vmslt", VMERGE: "vmerge", VSLIDE1DN: "vslide1dn",
    VSLIDE1UP: "vslide1up", VXOR: "vxor", VMULSC: "vmul.vx", VADDSC: "vadd.vx",
}


@dataclasses.dataclass(frozen=True)
class OpInfo:
    """Static metadata for one opcode.

    reads_vs1 / reads_vs2: whether the vs1/vs2 fields name live register reads.
    reads_vd:  destination-is-source (vmacc/vmadd/vmerge family).
    writes_vd: instruction produces a vector register result.
    writes_mask: result goes to the pinned v0 instead of a cVRF-managed reg.
    full_overwrite: vd is fully overwritten (no fetch needed on a vd miss when
        the allocate-no-fetch optimisation is enabled; the paper always
        fetches, so this only matters for the beyond-paper policy flag).
    is_load / is_store: unit-stride vector memory op touching ``addr``.
    cost: base occupancy cycles on the 8-lane VPU (1 for most ops; division,
        sqrt and reductions are multi-cycle on low-cost implementations).
    """

    reads_vs1: bool = False
    reads_vs2: bool = False
    reads_vd: bool = False
    writes_vd: bool = True
    writes_mask: bool = False
    full_overwrite: bool = True
    is_load: bool = False
    is_store: bool = False
    cost: int = 1


OP_INFO: dict[int, OpInfo] = {
    SCALAR: OpInfo(writes_vd=False, full_overwrite=False, cost=1),
    VLE: OpInfo(is_load=True, cost=1),
    VSE: OpInfo(reads_vs1=True, writes_vd=False, full_overwrite=False,
                is_store=True, cost=1),
    VADD: OpInfo(reads_vs1=True, reads_vs2=True),
    VSUB: OpInfo(reads_vs1=True, reads_vs2=True),
    VMUL: OpInfo(reads_vs1=True, reads_vs2=True),
    VDIV: OpInfo(reads_vs1=True, reads_vs2=True, cost=8),
    VSQRT: OpInfo(reads_vs1=True, cost=8),
    VFMA: OpInfo(reads_vs1=True, reads_vs2=True, reads_vd=True,
                 full_overwrite=False),
    VMAX: OpInfo(reads_vs1=True, reads_vs2=True),
    VMIN: OpInfo(reads_vs1=True, reads_vs2=True),
    VREDSUM: OpInfo(reads_vs1=True, reads_vs2=True, cost=4),
    VREDMAX: OpInfo(reads_vs1=True, reads_vs2=True, cost=4),
    VBCAST: OpInfo(is_load=True, cost=2),        # scalar load + broadcast
    VMVV: OpInfo(reads_vs1=True),
    VCMPLT: OpInfo(reads_vs1=True, reads_vs2=True, writes_vd=False,
                   writes_mask=True, full_overwrite=False),
    VMERGE: OpInfo(reads_vs1=True, reads_vs2=True),    # also reads v0 (pinned)
    VSLIDE1DN: OpInfo(reads_vs1=True),
    VSLIDE1UP: OpInfo(reads_vs1=True),
    VXOR: OpInfo(reads_vs1=True, reads_vs2=True),
    VMULSC: OpInfo(reads_vs1=True),
    VADDSC: OpInfo(reads_vs1=True),
    VSES: OpInfo(reads_vs1=True, writes_vd=False, full_overwrite=False,
                 is_store=True, cost=2),
}

MASK_READERS = {VMERGE}        # ops that read v0 as an implicit operand


def op_table() -> dict[str, np.ndarray]:
    """Dense per-opcode metadata tables indexed by opcode (for the simulator)."""
    n = NUM_OPS
    tbl = {
        "reads_vs1": np.zeros(n, np.bool_),
        "reads_vs2": np.zeros(n, np.bool_),
        "reads_vd": np.zeros(n, np.bool_),
        "writes_vd": np.zeros(n, np.bool_),
        "writes_mask": np.zeros(n, np.bool_),
        "full_overwrite": np.zeros(n, np.bool_),
        "is_load": np.zeros(n, np.bool_),
        "is_store": np.zeros(n, np.bool_),
        "cost": np.zeros(n, np.int32),
    }
    for op, info in OP_INFO.items():
        tbl["reads_vs1"][op] = info.reads_vs1
        tbl["reads_vs2"][op] = info.reads_vs2
        tbl["reads_vd"][op] = info.reads_vd
        tbl["writes_vd"][op] = info.writes_vd
        tbl["writes_mask"][op] = info.writes_mask
        tbl["full_overwrite"][op] = info.full_overwrite
        tbl["is_load"][op] = info.is_load
        tbl["is_store"][op] = info.is_store
        tbl["cost"][op] = info.cost
    return tbl
