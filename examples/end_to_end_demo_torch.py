"""End-to-end demo on the PyTorch port: train a VAE, build a dictionary,
index patterns.

The `latice_tpu_torch` twin of ``examples/end_to_end_demo.py``, the script
form of the reference's demo notebooks (notebook/index.ipynb and
notebook/index_faiss.ipynb): train a model with `Trainer` on a
`DPDataModule`, build the latent dictionary into the FAISS-named database
through `DiffractionPatternIndexer`, then time single-pattern indexing and
batch indexing through `IndexPipeline`, with `PhaseTimer`'s report.

The trainer draws its own initial weights (``Trainer(seed=42)``), so the
trained numbers are the port's, not the JAX run's.

Run on the card (from the repository root; ``--cpu`` runs on the CPU in
f32, as the JAX script's ``--cpu``):
    python -m examples.end_to_end_demo_torch --workdir /tmp/latice_demo
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np


def make_synthetic_dictionary(workdir: Path, n_groups=50, per_group=5, seed=7):
    """Simulated 'dictionary': groups of near-identical patterns sharing an
    orientation cluster (stand-in for the reference's simulated EBSD bank)."""
    rng = np.random.default_rng(seed)
    patterns, angles = [], []
    for _ in range(n_groups):
        base = rng.uniform(size=(128, 128))
        base_angle = rng.uniform([0, 20, 0], [340, 140, 340])
        for _ in range(per_group):
            patterns.append(base + rng.normal(size=(128, 128)) * 0.01)
            angles.append(base_angle + rng.uniform(-0.4, 0.4, 3))
    patterns, angles = np.asarray(patterns), np.asarray(angles)
    np.save(workdir / "dict_patterns.npy", patterns)
    (workdir / "dict_angles.txt").write_text(
        "eu\n%d\n" % len(angles)
        + "".join(f"{a[0]} {a[1]} {a[2]}\n" for a in angles)
    )
    return patterns, angles


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workdir", default="/tmp/latice_demo")
    parser.add_argument("--inplanes", type=int, default=4)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    return parser.parse_args(argv)


def main(argv=None, device=None) -> dict:
    """The demo; returns its printed figures. ``device`` is ``cpu`` with
    ``--cpu``, else ``cuda`` unless given."""
    args = parse_args(argv)
    cpu = args.cpu or str(device) == "cpu"
    device = device or ("cpu" if cpu else "cuda")

    from latice_tpu_torch import IndexPipeline, resolve_device
    from latice_tpu_torch.data import DPDataModule
    from latice_tpu_torch.index import DiffractionPatternIndexer, IndexerConfig
    from latice_tpu_torch.index.faiss_db import (
        FaissLatentVectorDatabase,
        FaissLatentVectorDatabaseConfig,
    )
    from latice_tpu_torch.models import VariationalAutoEncoderRawData
    from latice_tpu_torch.train import Trainer, VAEModule
    from latice_tpu_torch.utils import PhaseTimer

    dev = resolve_device(device)
    out: dict = {}
    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    patterns, angles = make_synthetic_dictionary(workdir)
    timer = PhaseTimer()

    # 1. Train (the notebooks load vae-best.pt; we train briefly instead).
    print(f"== training ({args.epochs} epoch, inplanes={args.inplanes}) ==")
    dm = DPDataModule(
        workdir / "dict_patterns.npy", workdir / "dict_angles.txt", batch_size=25
    )
    module = VAEModule(
        VariationalAutoEncoderRawData(inplanes=args.inplanes, latent_dim=16),
        kl_lambda=5e-6,
    )
    trainer = Trainer(
        max_epochs=args.epochs,
        precision="32" if cpu else "16-mixed",
        checkpoint_dir=workdir / "checkpoints",
        logger=None,
        recon_figure=False,
        device=dev,
    )
    with timer.phase("train"):
        model = trainer.fit(module, dm)
    out["final_loss"] = trainer.history[-1]["Epoch_train_loss"]
    print(f"   final loss: {out['final_loss']:.5f}")

    # 2. Build the dictionary database (index.ipynb cells 5-7).
    print("== building dictionary ==")
    db = FaissLatentVectorDatabase(
        FaissLatentVectorDatabaseConfig(npz_path=str(workdir / "index.npz")), device=dev
    )
    indexer = DiffractionPatternIndexer(
        model,
        db=db,
        config=IndexerConfig(
            pattern_path=workdir / "dict_patterns.npy",
            angles_path=workdir / "dict_angles.txt",
            batch_size=25,
            device=dev.type,
        ),
    )
    with timer.phase("build_dictionary"):
        indexer.build_dictionary(progress=False)
    out["vectors"] = db.get_count()
    print(f"   {db.get_count()} vectors")

    # 3. Single-pattern indexing with timing (index.ipynb cell 9).
    query = patterns[0]
    result = indexer.index_pattern(query, top_n=5)  # warm
    with timer.phase("index_single"):
        result = indexer.db.find_best_orientation(
            indexer.encode_pattern(query), top_n=5, orientation_threshold=3.0,
            min_required_matches=4,
        )
    out.update(single_success=bool(result.success), single_mean=result.mean_orientation)
    print(f"   success={result.success} mean={np.round(result.mean_orientation, 2)}"
          f" truth={np.round(angles[0], 2)}")

    # 4. Batch indexing through the pipeline (index.ipynb cell 13 ++).
    print("== fused batch indexing ==")
    pipe = IndexPipeline(
        model, db._vectors, db._orientations,
        top_n=5, orientation_threshold=3.0, min_required_matches=4,
        batch_size=125, device=dev,
    )
    pipe(patterns[:125])  # warm
    t0 = time.time()
    dense = pipe(patterns)
    dt = time.time() - t0
    out.update(result=dense, success=float(dense.success.mean()),
               patterns_per_s=len(patterns) / dt)
    print(f"   {len(patterns)} patterns in {dt*1e3:.0f} ms "
          f"({len(patterns)/dt:,.0f}/s), success {dense.success.mean():.0%}")

    print("== phase timing ==")
    out["phases"] = timer.report()
    for key, value in sorted(out["phases"].items()):
        print(f"   {key}: {value:.4g}")
    return out


if __name__ == "__main__":
    main()
