from repro_torch.train import optimizer, schedule
from repro_torch.train.optimizer import AdamW, SGDM
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["optimizer", "schedule", "AdamW", "SGDM", "Trainer", "TrainerConfig"]
