from repro_torch.serve import chaos, engine, kvcache, slo, traffic
from repro_torch.serve.chaos import (FAULT_PROFILES, FaultEvent,
                                     FaultInjector, FaultProfile,
                                     make_profile)
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.kvcache import DispersedKVPool, PagePoolConfig
from repro_torch.serve.slo import SLOReport, summarize
from repro_torch.serve.traffic import (TRAFFIC_MIXES, Scenario, Tenant,
                                       TrafficConfig, VirtualClock, generate)

__all__ = [
    "engine", "kvcache", "traffic", "chaos", "slo",
    "Request", "ServeEngine", "DispersedKVPool", "PagePoolConfig",
    "VirtualClock", "Tenant", "TrafficConfig", "Scenario", "generate",
    "TRAFFIC_MIXES", "FaultEvent", "FaultProfile", "FaultInjector",
    "make_profile", "FAULT_PROFILES", "SLOReport", "summarize",
]
