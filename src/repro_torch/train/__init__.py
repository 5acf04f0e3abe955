from .loop import TrainConfig, Trainer
from .step import make_train_step

__all__ = ["TrainConfig", "Trainer", "make_train_step"]
