"""Local optimizers and learning-rate schedules, the port of
``src/repro/optim`` (no optax there either): (init, update) pairs over the
port's parameter trees (``core.tree_util``)."""
from repro_torch.optim.optimizers import Optimizer, adam, apply_updates, clip_by_global_norm, sgd
from repro_torch.optim.schedules import constant, cosine, linear_warmup

__all__ = [
    "Optimizer",
    "adam",
    "sgd",
    "apply_updates",
    "clip_by_global_norm",
    "constant",
    "cosine",
    "linear_warmup",
]
