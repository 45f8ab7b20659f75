"""Model zoo: the ten assigned architectures, module for module after
``repro.models``."""

from repro_torch.models import attention, common, mlp, model, rglru, ssm
from repro_torch.models.model import Model

__all__ = ["attention", "common", "mlp", "model", "rglru", "ssm", "Model"]
