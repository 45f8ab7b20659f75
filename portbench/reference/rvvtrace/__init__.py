"""A frozen copy of the port's RVV-lite trace layer: the ISA table, the
assembler and the eleven benchmark programs, numpy only.

The benchmark's reference builds each program's instruction stream from
this copy, so what it walks never comes from the program under test.
Importing the package registers the programs in :data:`BENCHMARKS`, in
the paper's Table 2 order with the two deep-nest workloads last.
"""

from . import pathfinder      # noqa: F401
from . import jacobi2d        # noqa: F401
from . import somier          # noqa: F401
from . import gemv            # noqa: F401
from . import dropout         # noqa: F401
from . import conv2d          # noqa: F401
from . import gemm            # noqa: F401
from . import flashattention2  # noqa: F401
from . import conv2d_batched  # noqa: F401
from . import mha             # noqa: F401
from .common import BENCHMARKS, get_benchmark  # noqa: F401
