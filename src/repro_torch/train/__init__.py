from repro_torch.train import train_step, trainer
from repro_torch.train.trainer import TrainConfig, Trainer
__all__ = ["train_step", "trainer", "TrainConfig", "Trainer"]
