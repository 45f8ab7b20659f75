from repro_torch.runtime.fault_tolerance import (Heartbeat, RestartPolicy,
                                           StragglerPolicy)
__all__ = ["Heartbeat", "RestartPolicy", "StragglerPolicy"]
