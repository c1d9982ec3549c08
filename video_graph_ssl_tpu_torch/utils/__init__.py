"""Utils: checkpoints, experiment directories, metrics, telemetry, and the
weight bridge from the JAX package (exports as the JAX package's
``utils``, without its orbax backend)."""

from .checkpoint import load_checkpoint_state, save_checkpoint_state
from .meters import AverageMeter, accuracy, average_precision, mean_average_precision
from .saver import Saver
from .summary import TensorboardSummary, creat_saver

__all__ = [
    "Saver",
    "TensorboardSummary",
    "creat_saver",
    "AverageMeter",
    "accuracy",
    "average_precision",
    "mean_average_precision",
    "save_checkpoint_state",
    "load_checkpoint_state",
]
