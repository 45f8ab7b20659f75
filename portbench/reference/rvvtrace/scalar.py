"""The scalar-core cost record the programs' builders return beside their
traces (the walk never reads it)."""

import dataclasses


@dataclasses.dataclass
class ScalarCost:
    flop_ops: int = 0
    int_ops: int = 0
    loads: int = 0
    stores: int = 0
    unique_lines: int = 0
    loop_iters: int = 0
    flop_cycles: float = 2.0
    load_cycles: float = 1.5
    overhead_per_iter: int = 3
