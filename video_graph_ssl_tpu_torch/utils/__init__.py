"""Utils: checkpoints, experiment directories, metrics, telemetry, op-level
spans and counters (``tracing``), and the weight bridge from the JAX package
(exports as the JAX package's ``utils``, without its orbax backend).

The exports below load on first use, so that ``ops/`` and ``models/`` can
import ``utils.tracing`` without loading the checkpoint code, which imports
them."""

import importlib

_EXPORTS = {
    "Saver": "saver",
    "TensorboardSummary": "summary",
    "creat_saver": "summary",
    "AverageMeter": "meters",
    "accuracy": "meters",
    "average_precision": "meters",
    "mean_average_precision": "meters",
    "save_checkpoint_state": "checkpoint",
    "load_checkpoint_state": "checkpoint",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
