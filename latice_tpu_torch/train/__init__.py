"""Training: loss, optimizer, steps, schedule, metrics, checkpoints, trainer."""

from latice_tpu_torch.train.checkpoint import CheckpointManager
from latice_tpu_torch.train.loss import (
    VAELoss,
    binary_cross_entropy_with_logits,
    gaussian_likelihood,
    monte_carlo_kl,
)
from latice_tpu_torch.train.metrics import EpochAggregator
from latice_tpu_torch.train.module import VAEModule
from latice_tpu_torch.train.schedule import ReduceLROnPlateau
from latice_tpu_torch.train.state import (
    OptaxAdam,
    get_learning_rate,
    make_optimizer,
    set_learning_rate,
)
from latice_tpu_torch.train.steps import keyed_generator, make_eval_step, make_train_step
from latice_tpu_torch.train.trainer import Trainer

__all__ = [
    "CheckpointManager",
    "EpochAggregator",
    "OptaxAdam",
    "ReduceLROnPlateau",
    "Trainer",
    "VAELoss",
    "VAEModule",
    "binary_cross_entropy_with_logits",
    "gaussian_likelihood",
    "get_learning_rate",
    "keyed_generator",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "monte_carlo_kl",
    "set_learning_rate",
]
