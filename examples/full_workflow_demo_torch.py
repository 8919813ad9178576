"""Full-workflow demo on the PyTorch port: a synthetic polycrystal from
first principles to a finished analysis.

The `latice_tpu_torch` twin of ``examples/full_workflow_demo.py``:

1. `crystal.sample_fundamental_zone` — fundamental-zone dictionary orientations
2. `sim.simulate_patterns`          — kinematical Kikuchi patterns for the dictionary
3. (synthetic scan)                 — a Voronoi polycrystal rendered with the same
                                      physics, degraded with shot noise + hot pixels
4. `data.nlpar_denoise`             — neighborhood denoising of the raw scan
5. `IndexPipeline`                  — dictionary indexing (untrained encoder)
6. `sim.refine_candidates`          — autodiff refinement with NCC re-ranking of
                                      the top-k candidates
7. `crystal.misorientation_maps`    — grain labeling vs the known truth
8. `data.write_ang`                 — a .ang file MTEX/OIM can open

The encoder is untrained, as in the JAX script, so the asserts depend on
the initial weights; the scan noise is kept within the margin of JAX's
``model.init(key 1)``. The twin starts from those very weights, drawn in
numpy (`examples.common_torch.jax_init_state_dict`).

Run on the card (from the repository root; ``--cpu`` runs on the CPU):
    python -m examples.full_workflow_demo_torch
"""

from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grid", type=int, default=20, help="scan side length")
    ap.add_argument("--grains", type=int, default=6)
    return ap.parse_args(argv)


def main(argv=None, device=None) -> dict:
    """The demo; returns its printed figures. ``device`` is ``cpu`` with
    ``--cpu``, else ``cuda`` unless given."""
    args = parse_args(argv)
    device = device or ("cpu" if args.cpu else "cuda")

    import torch

    from examples.common_torch import make_model
    from latice_tpu_torch import IndexPipeline, resolve_device
    from latice_tpu_torch.crystal import (
        from_euler_zxz_deg,
        label_grains,
        misorientation_maps,
        sample_fundamental_zone,
        symmetry_reduced_misorientation,
        to_euler_zxz_deg,
    )
    from latice_tpu_torch.data import nlpar_denoise, write_ang
    from latice_tpu_torch.sim import (
        DetectorGeometry,
        cubic_reflectors,
        refine_candidates,
        simulate_patterns,
    )

    dev = resolve_device(device)
    out: dict = {}
    rng = np.random.default_rng(args.seed)

    # 1-2) Dictionary: FZ orientations -> kinematical patterns ------------
    quats = sample_fundamental_zone("432", resolution_deg=14.0)
    geometry = DetectorGeometry()
    reflectors = cubic_reflectors("fcc", max_hkl=2, min_d=1.0)
    dict_patterns = simulate_patterns(quats, geometry, reflectors, device=dev)
    dict_eulers = to_euler_zxz_deg(torch.from_numpy(quats.astype(np.float32))).numpy()
    print(f"dictionary: {len(quats)} FZ orientations at 14 deg, simulated")

    # 3) Synthetic polycrystal scan: Voronoi grains on the grid -----------
    g = args.grid
    seeds = rng.uniform(0, g, size=(args.grains, 2))
    yy, xx = np.mgrid[0:g, 0:g]
    d2 = (yy[..., None] - seeds[:, 0]) ** 2 + (xx[..., None] - seeds[:, 1]) ** 2
    grain_of = d2.argmin(-1)  # (g, g) grain id per pixel
    grain_orient = rng.choice(len(quats), size=args.grains, replace=False)
    pix_orient = grain_orient[grain_of]  # dictionary row per pixel
    scan = dict_patterns[pix_orient.ravel()].copy()
    scan += rng.normal(size=scan.shape).astype(np.float32) * 0.01
    scan = np.where(rng.random(scan.shape) < 1e-4, 6.0, scan).astype(np.float32)

    # 4) NLPAR (hot pixels repaired before averaging) ----------------------
    den = nlpar_denoise(
        scan.reshape(g, g, *scan.shape[1:]), h=2.0, hot_pixel_threshold=6.0, device=dev
    ).reshape(len(scan), *scan.shape[1:])

    # 5) Dictionary indexing ----------------------------------------------
    model = make_model(inplanes=4, latent_dim=16, precision="32", init_seed=1,
                       device=dev).eval()
    with torch.inference_mode():
        lat = model.encode(torch.from_numpy(dict_patterns[:, None]).to(dev))[0].cpu().numpy()
    vecs = lat / np.linalg.norm(lat, axis=1, keepdims=True)
    pipe = IndexPipeline(
        model, vecs, dict_eulers,
        top_n=5, orientation_threshold=3.0, min_required_matches=1,
        batch_size=g * g, device=dev,
    )
    res = pipe(den)
    top1 = (res.indices[:, 0] == pix_orient.ravel()).mean()
    out.update(n_dictionary=len(quats), result=res, top1=float(top1))
    print(f"indexing: top-1 accuracy {top1:.1%} (untrained encoder)")

    # 6) Refinement with NCC re-ranking of every top-5 candidate.
    cand_q = from_euler_zxz_deg(
        torch.as_tensor(dict_eulers[res.indices], dtype=torch.float32).reshape(-1, 3)
    ).numpy().reshape(len(den), -1, 4)
    refined_q, ncc, best_k = refine_candidates(
        den, cand_q, geometry, reflectors, steps=25, device=dev
    )
    truth_q = quats[pix_orient.ravel()].astype(np.float32)
    err = np.degrees(
        symmetry_reduced_misorientation(torch.as_tensor(refined_q), torch.as_tensor(truth_q))
        .numpy()
    )
    reranked = (err < 2.0).mean()
    out.update(reranked=float(reranked), overruled=float((best_k > 0).mean()),
               median_err_deg=float(np.median(err)), ncc_median=float(np.median(ncc)),
               refined_q=refined_q)
    print(
        f"refined+reranked: {reranked:.1%} of pixels correct "
        f"(re-rank overruled the encoder on {(best_k > 0).mean():.1%}); "
        f"median error {np.median(err):.3f} deg, ncc median {np.median(ncc):.3f}"
    )

    # 7) Grain analysis vs the known Voronoi truth -------------------------
    refined_euler = to_euler_zxz_deg(torch.as_tensor(refined_q)).numpy()
    maps = misorientation_maps(refined_euler.reshape(g, g, 3), group="432", device=dev)
    labels, n_found = label_grains(maps, threshold_deg=5.0)
    # Majority-label agreement with the truth partition.
    agree = 0
    for gid in range(args.grains):
        mask = grain_of == gid
        if mask.any():
            vals, counts = np.unique(labels[mask], return_counts=True)
            agree += counts.max()
    agree /= g * g
    out.update(labels=labels, n_found=int(n_found), agreement=float(agree))
    print(
        f"grains: truth {args.grains}, found {n_found}; "
        f"majority-partition agreement {agree:.1%}"
    )

    # 8) Vendor export ------------------------------------------------------
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".ang", delete=False) as f:
        ang_path = f.name
    final = res._replace(best_orientation=refined_euler.astype(np.float64))
    write_ang(ang_path, final, grid=(g, g), step=0.5)
    with open(ang_path) as fh:
        n_rows = sum(1 for line in fh if not line.startswith("#"))
    out.update(ang_path=ang_path, ang_rows=n_rows)
    print(f"export: {ang_path} ({n_rows} rows) — opens in MTEX/OIM")

    assert reranked > max(top1, 0.8), "re-ranked refinement should win"
    assert np.median(err) < 0.5, "refinement should be sub-grid"
    assert agree > 0.75, "grain partition should match the Voronoi truth"
    print("OK: full native workflow, dictionary to .ang")
    return out


if __name__ == "__main__":
    main()
