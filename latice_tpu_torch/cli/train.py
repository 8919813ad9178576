"""Train the VAE from the ``conf/`` tree, on the GPU by default.

    python -m latice_tpu_torch.cli.train                         # defaults
    python -m latice_tpu_torch.cli.train trainer.max_epochs=5 seed=1
    python -m latice_tpu_torch.cli.train -m \\
        lightning_module.optimizer_partial.learning_rate=1e-4,5e-4
    python -m latice_tpu_torch.cli.train --device cpu data_module.path=x.npy ...

The port of ``latice_tpu.cli.train`` (reference train.py:59-113): composes
the config, seeds the host RNGs, creates the log and checkpoint
directories, instantiates trainer, data module and training module from
their ``_target_``s (the JAX package's names, mapped to the port's) and
runs the fit loop. ``--multirun`` expands comma-separated values into a
sweep.
"""

from __future__ import annotations

import argparse
import logging
import os
import random
from pathlib import Path

import numpy as np

from latice_tpu_torch.config import expand_sweeps, load_config, maybe_instantiate

logger = logging.getLogger(__name__)


def set_random_seeds(seed: int) -> None:
    """Seed the host RNGs (reference train.py:46-56); the weights and the
    noise are keyed from the trainer's seed explicitly."""
    np.random.seed(seed)
    random.seed(seed)


def train(config: dict, device: str | None = None):
    """Train from a composed config; returns ``(trainer, model)``.

    ``device`` is where to train: ``cuda`` unless the caller asks for
    another (a missing card raises).
    """
    if config.get("seed") is not None:
        set_random_seeds(int(config["seed"]))

    trainer_cfg = dict(config["trainer"])
    logger_cfg = trainer_cfg.pop("logger", {}) or {}
    save_dir = Path(logger_cfg.get("save_dir", "lightning_logs"))
    os.makedirs(save_dir, exist_ok=True)
    (save_dir / "checkpoints").mkdir(parents=True, exist_ok=True)

    from latice_tpu_torch.data import DPDataModule, StreamedDPDataModule
    from latice_tpu_torch.train.module import VAEModule
    from latice_tpu_torch.train.trainer import Trainer
    from latice_tpu_torch.utils.loggers import make_default_logger

    # Keys kept for parity with the reference's config that the trainer
    # does not take as they are.
    trainer_cfg.pop("accelerator", None)
    devices = trainer_cfg.pop("devices", "auto")
    trainer_cfg.pop("callbacks", None)
    trainer_cfg.pop("_target_", None)
    if trainer_cfg.get("augment") is not None:
        trainer_cfg["augment"] = maybe_instantiate(trainer_cfg["augment"])

    exp_logger = make_default_logger(
        save_dir,
        tensorboard=bool(logger_cfg.get("tensorboard", True)),
        wandb=bool(logger_cfg.get("wandb", False)),
        project=str(logger_cfg.get("project", "VAE_Training")),
    )
    seed = int(config.get("seed") or 0)

    # devices=N (N>1): a data-parallel mesh over the first N cards, or over
    # N CPU entries when training on the CPU.
    mesh = None
    if devices not in ("auto", None, 1, "1"):
        import torch

        from latice_tpu_torch.parallel import make_mesh

        n = int(devices)
        on_cpu = torch.device(device or "cuda").type == "cpu"
        mesh = make_mesh(n, devices=["cpu"] * n if on_cpu else None)
        logger.info(f"Data-parallel training over mesh: {mesh}")

    logger.info("Instantiating trainer <latice_tpu_torch.train.trainer.Trainer>")
    trainer = Trainer(logger=exp_logger, seed=seed, mesh=mesh, device=device, **trainer_cfg)

    logger.info(f"Instantiating datamodule <{config['data_module']['_target_']}>")
    datamodule = maybe_instantiate(config["data_module"])
    if not isinstance(datamodule, (DPDataModule, StreamedDPDataModule)):
        raise TypeError(f"data_module must be a data module, got {type(datamodule).__name__}")

    logger.info(f"Instantiating module <{config['lightning_module']['_target_']}>")
    module = maybe_instantiate(config["lightning_module"], VAEModule)

    model = trainer.fit(module, datamodule)
    return trainer, model


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-m", "--multirun", action="store_true", help="expand comma sweeps")
    parser.add_argument("--config-path", default="conf")
    parser.add_argument("--config-name", default="train.yaml")
    parser.add_argument("--device", default=None, help="torch device (default: cuda)")
    parser.add_argument("overrides", nargs="*", help="key=value overrides")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    runs = expand_sweeps(args.overrides) if args.multirun else [args.overrides]
    for i, overrides in enumerate(runs):
        if len(runs) > 1:
            logger.info(f"=== multirun job {i}: {overrides} ===")
        config = load_config(args.config_path, args.config_name, overrides)
        train(config, device=args.device)


if __name__ == "__main__":
    main()
