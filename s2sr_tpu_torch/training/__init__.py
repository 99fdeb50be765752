from .checkpoint import CheckpointManager
from .data import PairSampler, prefetch
from .train import TrainConfig, init_training, make_train_step

__all__ = [
    "CheckpointManager",
    "PairSampler",
    "prefetch",
    "TrainConfig",
    "init_training",
    "make_train_step",
]
