"""The epoch loop: the port of ``latice_tpu.train.trainer``.

Drives the train and eval steps over epochs with the reference's contract
(SURVEY §3.1): seeded splits, per-step and epoch metrics under the
reference names, top-k checkpoints on ``Epoch_val_loss``
(conf/trainer/default.yaml), ReduceLROnPlateau on the validation loss, a
progress bar per epoch and the reconstruction figure of each validation
epoch (lightning_module.py:331-343).

Every batch, epoch tails included, is padded to the data module's
``batch_size`` with masked rows, as in the JAX trainer, so every step sees
one shape and the pad rows weigh nothing. Epoch means weigh each step by
its real rows. The model's weights are drawn from the trainer's seed at the
start of ``fit``, as the JAX trainer initializes its state there.
"""

from __future__ import annotations

import collections
import logging
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from latice_tpu_torch.data.datamodule import pad_batch
from latice_tpu_torch.data.prefetch import prefetch_to_device
from latice_tpu_torch.parallel.mesh import chunk_device
from latice_tpu_torch.train.checkpoint import CheckpointManager
from latice_tpu_torch.train.metrics import EpochAggregator
from latice_tpu_torch.train.module import VAEModule
from latice_tpu_torch.train.state import get_learning_rate, set_learning_rate
from latice_tpu_torch.train.steps import keyed_generator, make_eval_step, make_train_step
from latice_tpu_torch.utils.progress import make_progress_bar

logger = logging.getLogger(__name__)

__all__ = ["Trainer"]

_INIT_STREAM = 0


def _nchw(batch: np.ndarray) -> np.ndarray:
    """NHWC patterns with one channel as NCHW: the same bytes, reshaped."""
    b, h, w, c = batch.shape
    if c != 1:
        raise ValueError(f"expected one-channel NHWC patterns, got {batch.shape}")
    return np.ascontiguousarray(batch, dtype=np.float32).reshape(b, 1, h, w)


class Trainer:
    """Epoch-loop trainer for VAEModule over a DPDataModule.

    Args:
        max_epochs: number of epochs (reference default 2).
        precision: ``"16-mixed"`` (bfloat16 autocast) or ``"32"``.
        logger: object with ``log_metrics``/``log_image``/``finalize`` (see
            `utils.loggers`); None disables logging.
        checkpoint_dir: directory for top-k checkpoints; None disables.
        save_top_k / monitor: checkpoint selection (reference: 5 on
            Epoch_val_loss).
        mesh: optional `parallel.Mesh` for data-parallel training: each
            padded batch splits over the model's replicas, the noise drawn
            once for the global batch, the gradients summed on the first
            device (`train.steps`); validation splits the same way. The
            data module's batch size must divide by the mesh size.
        log_every_n_steps: step-metric logging cadence.
        seed: seed of the weights and of the noise streams.
        enable_progress_bar: a live train/val bar per epoch on stderr
            (`utils.progress`: rich when it imports, else a plain line).
        recon_figure: log the original-vs-reconstruction grid of the last
            validation batch each epoch (``logger.log_image``; a missing
            matplotlib is logged as a warning and training goes on).
        augment: optional training-time perturbation, a ``(generator,
            batch) -> batch`` callable over NHWC batches or a
            `data.AugmentConfig`, applied in the train step (`data.augment`).
            Validation stays unaugmented, so ``Epoch_val_*`` stay comparable
            across runs.
        denoising: with ``augment``, train the denoising-VAE objective
            (reconstruct the clean batch from the augmented input).
        device: where to train; ``cuda`` unless the caller asks for another.
            With ``mesh``, the mesh's first device or None.
    """

    def __init__(
        self,
        max_epochs: int = 2,
        precision: str = "16-mixed",
        logger: Any | None = None,
        checkpoint_dir: str | Path | None = None,
        save_top_k: int = 5,
        monitor: str = "Epoch_val_loss",
        mesh: Any | None = None,
        log_every_n_steps: int = 50,
        seed: int = 42,
        enable_progress_bar: bool = True,
        recon_figure: bool = True,
        augment: Any | None = None,
        denoising: bool = False,
        device: str | torch.device | None = None,
    ) -> None:
        if augment is not None and not callable(augment):
            from latice_tpu_torch.data.augment import AugmentConfig, make_augment_fn

            if not isinstance(augment, AugmentConfig):
                raise TypeError(
                    "augment must be a callable or a data.AugmentConfig, "
                    f"got {type(augment).__name__}"
                )
            augment = make_augment_fn(augment)
        self.augment = augment
        self.denoising = denoising
        self.mesh = mesh
        self.device = chunk_device(mesh, device)
        self.max_epochs = max_epochs
        self.precision = precision
        self.logger = logger
        self.log_every_n_steps = log_every_n_steps
        self.seed = seed
        self.enable_progress_bar = enable_progress_bar
        self.recon_figure = recon_figure
        self.checkpoints = (
            CheckpointManager(checkpoint_dir, save_top_k=save_top_k, monitor=monitor)
            if checkpoint_dir
            else None
        )
        self.model: torch.nn.Module | None = None
        self.optimizer: torch.optim.Optimizer | None = None
        self.global_step = 0
        self.history: list[dict[str, float]] = []
        self.start_epoch = 0
        self.latent: np.ndarray | None = None
        self.steps_run = {"train": 0, "val": 0}

    @staticmethod
    def _train_batches(datamodule: Any, epoch: int):
        """Epoch-seeded batches when the data module supports it (a resumed
        run replays them); otherwise its stateful stream."""
        try:
            return datamodule.train_batches(epoch=epoch)
        except TypeError:
            return datamodule.train_batches()

    @staticmethod
    def _num_batches(datamodule: Any) -> int | None:
        try:
            return int(datamodule.num_train_batches())
        except (AttributeError, TypeError):
            return None

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    def train_epoch(
        self,
        model: torch.nn.Module,
        optimizer: torch.optim.Optimizer,
        train_step: Any,
        batches: Any,
        batch_size: int,
        global_step: int,
        bar: Any = None,
    ) -> tuple[EpochAggregator, int]:
        """One epoch's training loop, as `fit` runs it: each ``(patterns,
        angles)`` of ``batches`` (NHWC patterns) is padded to ``batch_size``,
        prefetched to the device and stepped; the step's metrics are read
        back, aggregated, logged and shown on ``bar`` (a
        `utils.progress.make_progress_bar`, none by default). Returns the
        epoch's aggregator and the global step after it."""
        bar = bar if bar is not None else make_progress_bar(False, 0)
        agg = EpochAggregator("train_")
        # Real-row counts ride beside the prefetch stream, appended at
        # transfer time and consumed in order.
        counts: collections.deque[int] = collections.deque()

        def host_batches():
            for b, _ in batches:
                x, m, n = pad_batch(np.asarray(b, np.float32), batch_size)
                counts.append(n)
                yield (_nchw(x), m)

        for x, m in prefetch_to_device(host_batches(), device=self.device):
            metrics = train_step(model, optimizer, x, m, global_step)
            global_step += 1
            self.steps_run["train"] += 1
            step_metrics = agg.update(
                {k: float(v) for k, v in metrics.items()}, weight=counts.popleft()
            )
            # "elbo" is the reference's progress-bar name for the
            # training loss (lightning_module.py:266).
            step_metrics["elbo"] = step_metrics["train_loss"]
            if global_step % self.log_every_n_steps == 0 and self.logger:
                self.logger.log_metrics(step_metrics, global_step)
            bar.step(step_metrics)
        return agg, global_step

    def fit(self, module: VAEModule, datamodule: Any, resume: bool = False) -> torch.nn.Module:
        """Train; returns the trained model (also ``self.model``).

        With ``resume=True`` and a ``last_state`` checkpoint, training
        continues after the saved epoch with the weights, the optimizer's
        moments and the step counter restored.
        """
        module = module.with_precision(self.precision)
        model = module.model.to(self.device)
        model.init_weights(keyed_generator(torch.device("cpu"), self.seed, _INIT_STREAM))
        optimizer = module.configure_optimizer()

        datamodule.setup("fit")
        batch_size = getattr(datamodule, "batch_size", None)
        if batch_size is None:
            batch_size = len(next(iter(datamodule.train_batches()))[0])
        if self.mesh is not None and batch_size % self.mesh.size:
            raise ValueError(
                f"batch_size {batch_size} must divide by the mesh size {self.mesh.size}: "
                "batches are padded to the static size and then split over the mesh"
            )

        global_step = 0
        if resume and self.checkpoints is not None:
            try:
                state = self.checkpoints.load_last_state()
                model.load_state_dict(state["model"])
                optimizer.load_state_dict(state["optimizer"])
                global_step = int(state["step"])
                self.start_epoch = self.checkpoints.last_epoch() + 1
                logger.info(f"Resumed from epoch {self.start_epoch - 1}")
            except FileNotFoundError:
                logger.info("No checkpoint to resume from; starting fresh")

        train_step = make_train_step(
            module.loss_fn, augment=self.augment, denoising=self.denoising, seed=self.seed,
            mesh=self.mesh,
        )
        eval_step = make_eval_step(
            module.loss_fn, return_recon=self.recon_figure, seed=self.seed, mesh=self.mesh
        )
        self.model, self.optimizer = model, optimizer

        n_params = sum(p.numel() for p in model.parameters())
        logger.info(
            f"Training {n_params / 1e6:.2f}M params for {self.max_epochs} epochs "
            f"on {self.device if self.mesh is None else self.mesh} "
            f"(precision={self.precision})"
        )

        for epoch in range(self.start_epoch, self.max_epochs):
            epoch_start = time.time()
            bar = make_progress_bar(
                self.enable_progress_bar, epoch, self._num_batches(datamodule)
            )
            train_agg, global_step = self.train_epoch(
                model, optimizer, train_step, self._train_batches(datamodule, epoch),
                batch_size, global_step, bar,
            )

            val_agg = EpochAggregator("val_")
            last_val = None
            bar.set_phase("val")
            for i, (batch, _) in enumerate(datamodule.val_batches()):
                x, m, n = pad_batch(np.asarray(batch, np.float32), batch_size)
                # Per-(epoch, batch) noise: one key for all epochs would make
                # the validation noise identical from epoch to epoch.
                out = eval_step(
                    model, self._to_device(_nchw(x)), self._to_device(m),
                    key=epoch * 100_003 + i,
                )
                metrics, x_hat = out if self.recon_figure else (out, None)
                self.steps_run["val"] += 1
                step_metrics = val_agg.update(
                    {k: float(v) for k, v in metrics.items()}, weight=n
                )
                bar.step(step_metrics)
                if x_hat is not None and n >= 4:
                    # Kept on the device; only the last one is copied out.
                    last_val = (x[:n], x_hat[:n])
            bar.close()

            epoch_metrics = {**train_agg.epoch_metrics(), **val_agg.epoch_metrics()}
            epoch_metrics["learning_rate"] = get_learning_rate(optimizer)
            epoch_metrics["epoch_time_s"] = time.time() - epoch_start
            self.history.append(epoch_metrics)
            if self.logger:
                self.logger.log_metrics(epoch_metrics, epoch)
            logger.info(
                f"epoch {epoch}: " + " ".join(f"{k}={v:.5g}" for k, v in epoch_metrics.items())
            )

            if self.recon_figure and last_val is not None and self.logger:
                self._log_reconstruction(last_val, epoch)

            if self.checkpoints is not None:
                self.checkpoints.save(
                    epoch,
                    model.state_dict(),
                    epoch_metrics,
                    full_state={
                        "model": model.state_dict(),
                        "optimizer": optimizer.state_dict(),
                        "step": global_step,
                    },
                )

            if module.scheduler is not None and "Epoch_val_loss" in epoch_metrics:
                current_lr = get_learning_rate(optimizer)
                new_lr = module.scheduler.step(epoch_metrics["Epoch_val_loss"], current_lr)
                if new_lr != current_lr:
                    logger.info(f"Reducing learning rate to {new_lr:.3g}")
                    set_learning_rate(optimizer, new_lr)

        if self.logger:
            self.logger.finalize()
        self.global_step = global_step
        return model

    @torch.no_grad()
    def test(
        self, module: VAEModule, datamodule: Any, model: torch.nn.Module | None = None
    ) -> np.ndarray:
        """The encoder means over the test split (reference
        lightning_module.py:348-357), ``(N, latent_dim)`` float32, also
        stored on ``self.latent``. Uses the model from ``fit`` unless
        ``model`` is given; ``module`` keeps the JAX trainer's signature.
        Batches are padded to the static batch size."""
        model = model if model is not None else self.model
        if model is None:
            raise RuntimeError("No trained model: call fit() first or pass model=")
        model = model.to(self.device).set_precision(self.precision).eval()
        batch_size = getattr(datamodule, "batch_size", None) or 256
        outs = []
        for batch, _ in datamodule.test_batches():
            x, _, n = pad_batch(np.asarray(batch, np.float32), batch_size)
            mu, _ = model.encode(self._to_device(_nchw(x)))
            outs.append(mu[:n].float().cpu().numpy())
        self.latent = np.concatenate(outs) if outs else np.zeros((0, 0), np.float32)
        return self.latent

    def _log_reconstruction(self, last_val, epoch: int) -> None:
        """Render the 2xN original-vs-reconstruction grid
        (lightning_module.py:331-343 / utils.py:77-148)."""
        try:
            from latice_tpu_torch.utils.viz import figure_to_array, plot_detection

            x, x_hat = last_val
            fig = plot_detection(x, x_hat.float().cpu().numpy())
            self.logger.log_image("reconstruction/eval_check", figure_to_array(fig), epoch)
        except Exception as e:  # the figure must never stop training
            logger.warning(f"Reconstruction figure logging failed: {e}")
