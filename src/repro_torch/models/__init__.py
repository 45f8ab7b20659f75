"""Model zoo: the dense family, module for module after ``repro.models``."""

from repro_torch.models import attention, common, mlp, model
from repro_torch.models.model import Model

__all__ = ["attention", "common", "mlp", "model", "Model"]
