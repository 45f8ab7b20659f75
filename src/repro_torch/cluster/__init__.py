"""Clustered vector units: N dispersion cores behind shared memory.

The port of the reference's ``repro.cluster``: the lockstep N-core
cluster (private cVRF + L1 per core, shared L2 + banked memory channels
with deterministic round-robin arbitration).  On the card a whole cores x
capacity x policy x latency grid is K1 once and K2 once per launch group
(``kernels/cluster_scan.py``); ``device="cpu"`` runs the plain twin.
"""

from repro_torch.cluster.contention import (ClusterConfig, l2_access,
                                            l2_init, queue_rounds,
                                            rank_order)
from repro_torch.cluster.engine import (CLUSTER_COUNTER_NAMES,
                                        CORE_CYCLE_AGGREGATES,
                                        check_cluster_affine,
                                        simulate_cluster_grid,
                                        simulate_clusters)

__all__ = [
    "ClusterConfig", "CLUSTER_COUNTER_NAMES", "CORE_CYCLE_AGGREGATES",
    "check_cluster_affine", "l2_access", "l2_init", "queue_rounds",
    "rank_order", "simulate_cluster_grid",
]
