"""Orientation-map demo on the PyTorch port: index a synthetic scan and
render the IPF map.

The `latice_tpu_torch` twin of ``examples/orientation_map_demo.py``: a
Voronoi grain structure, its patterns (the cosine toy of
`examples.accuracy_benchmark_torch.render_patterns`), 600 device-resident
train steps, the scan indexed through `IndexPipeline`, grain segmentation,
grain statistics, the ODF's texture index, Schmid factors and side-by-side
IPF-z maps of truth and result (drawn where matplotlib is installed). The
model starts from the JAX script's ``model.init(key 0)`` weights
(`examples.common_torch.jax_init_state_dict`), and the noise
of step ``s`` is keyed by ``(3, s)``, as the JAX script's
``fold_in(key 3, step)``.

Run on the card (from the repository root; ``--cpu`` runs on the CPU):
    python -m examples.orientation_map_demo_torch --out /tmp/orientation_map.png
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def make_grain_map(side: int, n_grains: int, angle_lo, angle_hi, seed=0):
    """Voronoi grain structure: (side, side) map of grain ids + per-grain
    orientations."""
    rng = np.random.default_rng(seed)
    seeds = rng.uniform(0, side, size=(n_grains, 2))
    yy, xx = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    d2 = (yy[..., None] - seeds[:, 0]) ** 2 + (xx[..., None] - seeds[:, 1]) ** 2
    grain_id = np.argmin(d2, axis=-1)
    grain_angles = rng.uniform(angle_lo, angle_hi, size=(n_grains, 3))
    return grain_id, grain_angles


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default="/tmp/orientation_map.png")
    parser.add_argument("--side", type=int, default=48, help="scan side length")
    parser.add_argument("--cpu", action="store_true")
    return parser.parse_args(argv)


def main(argv=None, device=None, grid: int = 16, steps: int = 600, batch: int = 256,
         inplanes: int = 32, precision: str = "16-mixed", odf_samples: int = 4096) -> dict:
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
    from latice_tpu_torch import IndexPipeline, resolve_device
    from latice_tpu_torch.crystal import grain_boundary_mask, label_grains, misorientation_maps
    from latice_tpu_torch.utils import get_color_key

    dev = resolve_device(device)
    out: dict = {}
    rng = np.random.default_rng(0)
    lo, hi = [0, 40, 0], [30, 70, 30]

    # Dictionary: 2-degree grid over the orientation box.
    dict_angles = dictionary_grid(grid)
    print(f"rendering {len(dict_angles)}-entry dictionary...")
    dict_patterns = render_patterns(dict_angles)

    # Scan: Voronoi grains with orientations inside the box, noisy patterns.
    grain_id, grain_angles = make_grain_map(args.side, 25, lo, hi, seed=3)
    scan_angles = grain_angles[grain_id.ravel()]
    print(f"rendering {len(scan_angles)}-pixel scan...")
    scan = render_patterns(scan_angles, noise=0.15, seed=7)

    # Train briefly (device-resident batches).
    model = make_model(inplanes=inplanes, latent_dim=16, precision=precision, device=dev)
    xd = resident_stack(dict_patterns, dev)
    t0 = time.time()
    metrics = train_resident(model, xd, steps, batch, rng, seed=3)
    out["final_loss"] = float(metrics["loss"])
    out["train_s"] = time.time() - t0
    print(f"trained {steps} steps in {out['train_s']:.1f}s, loss {out['final_loss']:.4f}")

    # Encode dictionary + index the scan.
    vecs = encode_dictionary(model, xd)
    pipe = IndexPipeline(
        model, vecs, dict_angles,
        top_n=10, orientation_threshold=5.0, min_required_matches=3, batch_size=512,
        device=dev,
    )
    t0 = time.time()
    res = pipe(scan[..., None].astype(np.float32))
    out["index_s"] = time.time() - t0
    out["result"] = res
    out["success"] = float(res.success.mean())
    print(f"indexed {len(scan)} pixels in {out['index_s']:.1f}s; success {res.success.mean():.1%}")

    # Render IPF-z maps.
    side = args.side
    truth_rgb = get_color_key(scan_angles, "ipf_z").reshape(side, side, 3) / 255.0
    got_rgb = np.where(
        res.success[:, None],
        get_color_key(res.best_orientation, "ipf_z"),
        0,
    ).reshape(side, side, 3) / 255.0

    # Grain analysis on the indexed map: segment grains and compare the
    # recovered count against the Voronoi ground truth.
    euler_grid = res.best_orientation.reshape(side, side, 3)
    maps = misorientation_maps(euler_grid, group="432", device=dev)
    labels, n_grains = label_grains(maps, threshold_deg=5.0)
    boundaries = grain_boundary_mask(maps, threshold_deg=5.0)
    truth_grains = len(np.unique(grain_id))
    out.update(labels=labels, n_grains=n_grains, truth_grains=truth_grains)
    print(f"grain segmentation: {n_grains} grains recovered (truth: {truth_grains})")

    # The full post-indexing analysis suite on the recovered map.
    from latice_tpu_torch.crystal import grain_statistics, make_odf, schmid_factors, texture_index

    stats = grain_statistics(euler_grid, labels, group="432", device=dev)
    out["mean_ecd_px"] = float(stats.equivalent_diameter_px.mean())
    out["mean_gos_deg"] = float(stats.gos_deg.mean())
    print(
        f"grain statistics: mean ECD {stats.equivalent_diameter_px.mean():.1f} px, "
        f"mean GOS {stats.gos_deg.mean():.3f} deg"
    )
    odf = make_odf(res.best_orientation[res.success], halfwidth_deg=15.0, device=dev)
    out["texture_index"] = float(texture_index(odf, n=odf_samples, device=dev))
    print(f"texture index J = {out['texture_index']:.2f} (1 = random)")
    sf = schmid_factors(euler_grid, (0.0, 0.0, 1.0), family="fcc", device=dev)
    out["schmid_mean"] = float(sf.max_factor.mean())
    out["schmid_max"] = float(sf.max_factor.max())
    print(
        f"Schmid factors under [001] load: mean {sf.max_factor.mean():.3f}, "
        f"max {sf.max_factor.max():.3f}"
    )

    plt = pyplot_or_none()
    if plt is not None:
        fig, axs = plt.subplots(1, 4, figsize=(16, 4), dpi=120)
        grain_rgb = plt.get_cmap("tab20")(labels % 20)[..., :3]
        grain_rgb[boundaries] = 0.0
        for ax, img, title in [
            (axs[0], truth_rgb, "ground truth (IPF-z)"),
            (axs[1], got_rgb, "indexed (IPF-z)"),
            (axs[2], grain_rgb, f"grains ({n_grains}, boundaries black)"),
            (axs[3], res.success.reshape(side, side), "success mask"),
        ]:
            kw = {"vmin": 0, "vmax": 1, "cmap": "gray"} if img.ndim == 2 else {}
            ax.imshow(img, interpolation="nearest", **kw)
            ax.set_title(title)
            ax.axis("off")
        fig.tight_layout()
        fig.savefig(args.out)
        plt.close(fig)
        print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
