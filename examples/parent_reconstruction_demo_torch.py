"""Prior-austenite reconstruction from a synthetic martensite map, on the
PyTorch port.

The `latice_tpu_torch` twin of ``examples/parent_reconstruction_demo.py``:

1. synthesize a prior-parent microstructure: Voronoi parent grains, each
   shattered into Kurdjumov–Sachs lath variants with measurement noise;
2. segment child grains (`crystal.misorientation_maps`, `label_grains`);
3. reconstruct the parents (`crystal.reconstruct_parents`): candidate
   inversion, hypothesis scoring, variant ids;
4. score against the generating truth and render the child IPF / parent
   IPF / variant-map figure (where matplotlib is installed).

The synthesis is host numpy and scipy with the JAX script's draws; the
maps, statistics and reconstruction run on ``device``.

Run on the card (from the repository root; ``--cpu`` runs on the CPU):
    python -m examples.parent_reconstruction_demo_torch
"""

from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--size", type=int, default=96, help="map side (pixels)")
    ap.add_argument("--parents", type=int, default=6)
    ap.add_argument("--out", default="parent_reconstruction_demo.png")
    return ap.parse_args(argv)


def main(argv=None, device=None) -> dict:
    """The demo; returns its printed figures. ``device`` is ``cpu`` with
    ``--cpu``, else ``cuda`` unless given."""
    args = parse_args(argv)
    device = device or ("cpu" if args.cpu else "cuda")

    from scipy.spatial.transform import Rotation as R

    from examples.common_torch import pyplot_or_none
    from latice_tpu_torch import resolve_device
    from latice_tpu_torch.crystal import (
        grain_adjacency,
        grain_statistics,
        label_grains,
        misorientation_maps,
        or_rotation,
        reconstruct_parents,
        symmetry_quats,
    )
    from latice_tpu_torch.crystal.csl import _qmul_np

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    n, npar = args.size, args.parents

    # 1. Synthetic prior microstructure. Voronoi parents; each parent's
    # pixels split into 4-6 KS lath variants by a second, finer Voronoi.
    yy, xx = np.mgrid[0:n, 0:n]
    seeds = rng.uniform(0, n, size=(npar, 2))
    d2 = (yy[..., None] - seeds[:, 0]) ** 2 + (xx[..., None] - seeds[:, 1]) ** 2
    parent_px = d2.argmin(-1)  # (n, n) truth parent id
    t = or_rotation("ks")
    sym = symmetry_quats("432").double().numpy()
    parent_R = R.random(npar, random_state=rng)
    euler = np.empty((n, n, 3))
    for p in range(npar):
        mask = parent_px == p
        gp = np.roll(parent_R[p].as_quat(), 1)
        # lath regions: fine Voronoi inside the parent, each one KS variant
        nlath = rng.integers(4, 7)
        lseeds = np.stack(np.nonzero(mask), 1)[rng.choice(mask.sum(), nlath, replace=False)]
        py, px_ = np.nonzero(mask)
        lath = ((py[:, None] - lseeds[:, 0]) ** 2 + (px_[:, None] - lseeds[:, 1]) ** 2).argmin(-1)
        variants = rng.choice(24, nlath, replace=False)
        for li in range(nlath):
            sel = lath == li
            gc = _qmul_np(t, _qmul_np(sym[variants[li]], gp))
            noise = R.from_rotvec(rng.normal(scale=np.radians(0.15), size=(int(sel.sum()), 3)))
            euler[py[sel], px_[sel]] = (
                R.from_quat(np.roll(gc, -1)) * noise
            ).as_euler("zxz", degrees=True)

    # 2. Child-grain segmentation.
    maps = misorientation_maps(euler, group="432", device=dev)
    labels, n_child = label_grains(maps, threshold_deg=5.0)
    stats = grain_statistics(euler, labels, group="432", device=dev)
    print(f"child segmentation: {n_child} lath grains")

    # 3. Parent reconstruction from the child-grain means.
    rec = reconstruct_parents(
        stats.mean_orientation,
        grain_adjacency(labels),
        relationship="ks",
        tolerance_deg=2.5,
        device=dev,
    )
    parent_map = rec.parent_labels[labels]
    print(
        f"reconstruction: {rec.n_parents} parents (truth {npar}), "
        f"mean fit {rec.fit_deg.mean():.3f} deg"
    )

    # 4. Score: pixel agreement under the best parent-id matching (greedy).
    agree = 0
    used: set[int] = set()
    for p in range(npar):
        ids, counts = np.unique(parent_map[parent_px == p], return_counts=True)
        order = np.argsort(-counts)
        for o in order:
            if int(ids[o]) not in used:
                used.add(int(ids[o]))
                agree += int(counts[o])
                break
    acc = agree / parent_px.size
    print(f"pixel agreement with generating truth: {acc:.1%}")
    assert acc > 0.95, "reconstruction should recover the prior structure"
    out = dict(n_child=int(n_child), n_parents=int(rec.n_parents),
               mean_fit_deg=float(rec.fit_deg.mean()), agreement=float(acc),
               labels=labels, parent_map=parent_map, euler=euler)

    plt = pyplot_or_none()
    if plt is not None:
        from latice_tpu_torch.utils import get_color_key

        child_rgb = get_color_key(euler.reshape(-1, 3), "ipf_z").reshape(n, n, 3) / 255.0
        parent_euler_px = rec.parent_orientation[parent_map]
        parent_rgb = (
            get_color_key(parent_euler_px.reshape(-1, 3), "ipf_z").reshape(n, n, 3) / 255.0
        )
        variant_px = rec.variant[labels]
        fig, axs = plt.subplots(1, 3, figsize=(13, 4.4), dpi=120)
        for ax, img, title in (
            (axs[0], child_rgb, f"martensite (IPF-Z, {n_child} laths)"),
            (axs[1], parent_rgb, f"reconstructed austenite ({rec.n_parents} grains)"),
            (axs[2], plt.get_cmap("tab20")(variant_px % 20)[..., :3], "KS variant id"),
        ):
            ax.imshow(img)
            ax.set_title(title, fontsize=10)
            ax.axis("off")
        fig.tight_layout()
        fig.savefig(args.out, bbox_inches="tight")
        plt.close(fig)
        print(f"figure: {args.out}")
    return out


if __name__ == "__main__":
    main()
