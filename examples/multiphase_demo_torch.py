"""Multi-phase indexing demo on the PyTorch port: two crystal phases, one
dictionary, one scan.

The `latice_tpu_torch` twin of ``examples/multiphase_demo.py``: two
synthetic phases (distinct band-frequency families standing in for
distinct structures, cubic "432" and hexagonal "622" point groups), a
shared VAE trained with the dictionary resident on the card, a
phase-labeled dictionary through `IndexPipeline`, and a Voronoi-grain scan
where every pixel must be resolved to both the right phase and the right
orientation, then multi-phase grain segmentation. The model starts from
the JAX script's ``model.init(key 0)`` weights
(`examples.common_torch.jax_init_state_dict`); the noise of
step ``s`` is keyed by ``(0, s)``. The JAX script keys it by ``key(s)``;
the port's generator draws other numbers than JAX's whatever the key.

Run on the card (from the repository root; ``--cpu`` runs on the CPU,
``--out map.png`` draws a phase map where matplotlib is installed):
    python -m examples.multiphase_demo_torch
"""

from __future__ import annotations

import argparse
import time

import numpy as np

PHASE_FREQS = [(9.0, 14.0, 6.0), (11.0, 7.0, 16.0)]
PHASE_GROUPS = ["432", "622"]  # cubic, hexagonal


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default=None, help="optional phase-map PNG")
    parser.add_argument("--side", type=int, default=32, help="scan side length")
    parser.add_argument("--steps", type=int, default=500, help="train steps")
    parser.add_argument("--cpu", action="store_true")
    return parser.parse_args(argv)


def main(argv=None, device=None, grid: int = 12, batch: int = 256, inplanes: int = 32,
         precision: str = "16-mixed") -> dict:
    """The demo; returns its printed figures. ``device`` is ``cpu`` with
    ``--cpu``, else ``cuda`` unless given; the other keywords default to the
    JAX script's constants."""
    args = parse_args(argv)
    device = device or ("cpu" if args.cpu else "cuda")

    from examples.accuracy_benchmark_torch import render_patterns
    from examples.common_torch import (
        dictionary_grid,
        encode_dictionary,
        make_model,
        pyplot_or_none,
        resident_stack,
        train_resident,
    )
    from examples.orientation_map_demo_torch import make_grain_map
    from latice_tpu_torch import IndexPipeline, resolve_device

    dev = resolve_device(device)
    out: dict = {}
    rng = np.random.default_rng(0)

    # Per-phase dictionaries on the same orientation grid.
    grid_angles = dictionary_grid(grid)
    print(f"rendering 2 x {len(grid_angles)}-entry phase dictionaries...")
    dict_patterns = np.concatenate(
        [render_patterns(grid_angles, freqs=f) for f in PHASE_FREQS]
    )
    dict_angles = np.concatenate([grid_angles, grid_angles])
    dict_phases = np.repeat([0, 1], len(grid_angles)).astype(np.int32)

    # Scan: Voronoi grains, each with a phase and an orientation.
    grain_id, grain_angles = make_grain_map(args.side, 20, [0, 40, 0], [30, 70, 30], seed=3)
    grain_phase = rng.integers(0, 2, size=len(grain_angles))
    scan_angles = grain_angles[grain_id.ravel()]
    scan_phases = grain_phase[grain_id.ravel()]
    print(f"rendering {len(scan_angles)}-pixel two-phase scan...")
    scan = np.concatenate(
        [
            render_patterns(
                scan_angles[i : i + 1], noise=0.1, seed=100 + i,
                freqs=PHASE_FREQS[scan_phases[i]],
            )
            for i in range(len(scan_angles))
        ]
    )

    # Train the shared VAE on the union dictionary.
    model = make_model(inplanes=inplanes, latent_dim=16, precision=precision, device=dev)
    xd = resident_stack(dict_patterns, dev)
    t0 = time.time()
    metrics = train_resident(model, xd, args.steps, batch, rng, seed=0)
    out["final_loss"] = float(metrics["loss"])
    out["train_s"] = time.time() - t0
    print(f"trained {args.steps} steps in {out['train_s']:.1f}s, loss {out['final_loss']:.4f}")

    # Phase-labeled dictionary through the pipeline.
    vecs = encode_dictionary(model, xd)
    pipe = IndexPipeline(
        model, vecs, dict_angles,
        top_n=10, orientation_threshold=5.0, min_required_matches=3,
        batch_size=512, dictionary_phases=dict_phases,
        phase_symmetries=PHASE_GROUPS, device=dev,
    )
    t0 = time.time()
    res = pipe(scan[..., None].astype(np.float32))
    out["index_s"] = time.time() - t0
    phase_acc = (res.phase == scan_phases).mean()
    err = np.abs(res.best_orientation - scan_angles)
    err = np.minimum(err, 360 - err).max(axis=1)
    out.update(result=res, success=float(res.success.mean()), phase_accuracy=float(phase_acc),
               median_err_deg=float(np.median(err[res.success])), model=model, vectors=vecs,
               dict_angles=dict_angles, dict_phases=dict_phases, scan=scan)
    print(
        f"indexed {len(scan)} pixels in {out['index_s']:.1f}s: "
        f"success {res.success.mean():.1%}, phase accuracy {phase_acc:.1%}, "
        f"median orientation err {np.median(err[res.success]):.2f} deg"
    )

    # Multi-phase grain analysis of the indexed map: same-phase edges reduce
    # with that phase's point group, phase boundaries always segment.
    from latice_tpu_torch.crystal import label_grains, misorientation_maps_multiphase

    side = int(np.sqrt(len(scan)))
    maps = misorientation_maps_multiphase(
        res.best_orientation.reshape(side, side, 3),
        np.asarray(res.phase).reshape(side, side),
        ["432", "622"],
        device=dev,
    )
    labels, n_grains = label_grains(maps, threshold_deg=5.0)
    out.update(labels=labels, n_grains=n_grains, truth_grains=len(np.unique(grain_id)))
    print(
        f"grain segmentation (per-phase symmetry): {n_grains} grains "
        f"(truth: {len(np.unique(grain_id))} Voronoi cells)"
    )

    plt = pyplot_or_none() if args.out else None
    if plt is not None:
        from latice_tpu_torch.utils import get_color_key

        # IPF-z map colored with each pixel's own phase point group.
        ipf = np.zeros((len(scan_angles), 3))
        for pid, grp in enumerate(PHASE_GROUPS):
            sel = res.phase == pid
            if sel.any():
                ipf[sel] = get_color_key(res.best_orientation[sel], "ipf_z", group=grp) / 255.0

        side = args.side
        fig, axs = plt.subplots(1, 3, figsize=(12, 4), dpi=120)
        for ax, img, title, kw in [
            (axs[0], scan_phases.reshape(side, side), "ground-truth phase",
             dict(cmap="coolwarm", vmin=0, vmax=1)),
            (axs[1], res.phase.reshape(side, side), "indexed phase",
             dict(cmap="coolwarm", vmin=0, vmax=1)),
            (axs[2], ipf.reshape(side, side, 3), "indexed IPF-z (per-phase key)", {}),
        ]:
            ax.imshow(img, **kw)
            ax.set_title(title)
            ax.axis("off")
        fig.tight_layout()
        fig.savefig(args.out)
        plt.close(fig)
        print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
