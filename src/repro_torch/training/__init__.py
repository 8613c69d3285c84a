from .trainer import Trainer, TrainConfig, make_train_step

__all__ = ["Trainer", "TrainConfig", "make_train_step"]
