"""The paper's own machine configuration (Table 1) as a config module:
Codasip L31 (RV32IMFCB, 3-stage, 200 MHz) + 256-bit / 8-lane VPU.

Used by the simulator defaults and the benchmark harness; exposed here so
the paper target sits beside the assigned LM architectures.
"""

from repro_torch.core.isa import (MASK_REG, NUM_ARCH_VREGS, VL_ELEMS,
                                  VLEN_BITS, VLEN_BYTES)
from repro_torch.core.simulator import (DEFAULT_MACHINE, MachineParams,
                                        MachineSweep)

L31_VPU = DEFAULT_MACHINE                 # L1D 16 KB 2-way, mem 5 cyc
CVRF_SIZES = (3, 4, 5, 6, 7, 8, 16)       # the paper's evaluated heights
FULL_VRF = NUM_ARCH_VREGS                 # 32 architectural registers
PAPER_CVRF = 8                            # the headline configuration

# Table 1 gives the memory latency as a 1-5 cycle range: the whole range as
# one machine sweep axis (one engine run for all five points).
TABLE1_MEM_RANGE = MachineSweep.make((1, 2, 3, 4, 5))

__all__ = ["L31_VPU", "CVRF_SIZES", "FULL_VRF", "PAPER_CVRF",
           "TABLE1_MEM_RANGE", "MachineParams", "MachineSweep", "MASK_REG",
           "NUM_ARCH_VREGS", "VL_ELEMS", "VLEN_BITS", "VLEN_BYTES"]
