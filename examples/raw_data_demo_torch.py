"""Raw-detector-data demo on the PyTorch port: degrade patterns the way
real acquisitions do (vignetting, additive diffusion background, hot
pixels, shot noise), then recover indexability with the on-device
preprocessing stack + NLPAR.

The `latice_tpu_torch` twin of ``examples/raw_data_demo.py``. Three
configurations of the same pipeline are compared:

1. *naive* — dictionary encoded from clean patterns, raw scan indexed with
   no correction;
2. *preprocess* — dictionary and queries both normalized to band contrast
   (`PreprocessConfig` fused into `IndexPipeline`: hot-pixel repair, static
   vignette division, dynamic background removal);
3. *preprocess + NLPAR* — queries additionally denoised over the scan grid
   (`nlpar_denoise`, hot pixels repaired before averaging).

The demo scores top-1 accuracy and median orientation error against the
known ground truth, and asserts each stage improves top-1 accuracy.

The encoder is untrained, as in the JAX script, so its asserts depend on
the initial weights: the noise level is tuned to the margin of JAX's
``model.init(key 1)``. The twin starts from those very weights, drawn in
numpy (`examples.common_torch.jax_init_state_dict`).

Run on the card (from the repository root; ``--cpu`` runs on the CPU):
    python -m examples.raw_data_demo_torch
"""

from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--noise", type=float, default=0.015)
    return ap.parse_args(argv)


def main(argv=None, device=None) -> dict:
    """The demo; returns the three stages' top-1 accuracies and median
    errors. ``device`` is ``cpu`` with ``--cpu``, else ``cuda`` unless
    given."""
    args = parse_args(argv)
    device = device or ("cpu" if args.cpu else "cuda")

    import torch

    from examples.common_torch import make_model
    from latice_tpu_torch import IndexPipeline, resolve_device
    from latice_tpu_torch.data import PreprocessConfig, make_preprocess_fn, nlpar_denoise

    dev = resolve_device(device)
    rng = np.random.default_rng(args.seed)

    # --- dictionary: distinct clean patterns with known orientations -----
    n_dict = 24
    base = rng.uniform(0.2, 0.8, size=(n_dict, 128, 128)).astype(np.float32)
    dict_angles = rng.uniform([10, 30, 10], [170, 140, 170], size=(n_dict, 3))

    model = make_model(inplanes=4, latent_dim=16, precision="32", init_seed=1,
                       device=dev).eval()

    @torch.inference_mode()
    def enc(x):
        return model.encode(x[:, None])[0].cpu().numpy()

    def normed(lat):
        return lat / np.linalg.norm(lat, axis=1, keepdims=True)

    # --- scan: a 4-row grid of dictionary patterns, detector-degraded ----
    rows = 4
    pick = np.tile(np.arange(n_dict), rows)
    truth_idx = pick
    clean = base[pick]
    yy, xx = np.mgrid[0:128, 0:128].astype(np.float32) / 127.0
    vignette = (
        0.55 + 0.45 * np.exp(-((xx - 0.5) ** 2 + (yy - 0.5) ** 2) * 2)
    ).astype(np.float32)
    diffusion = (0.35 * (0.5 + 0.5 * xx)).astype(np.float32)
    raw = clean * vignette[None] + diffusion[None]
    raw += rng.normal(size=raw.shape).astype(np.float32) * args.noise
    raw = np.where(rng.random(raw.shape) < 2e-4, 8.0, raw).astype(np.float32)

    # Correction recipes. The dictionary must live in the same
    # representation corrected queries land in: band contrast.
    query_cfg = PreprocessConfig(
        hot_pixel_threshold=6.0,
        static_background=vignette,
        dynamic_sigma="auto",
    )
    dict_fn = make_preprocess_fn(PreprocessConfig(dynamic_sigma="auto"))

    # min_required_matches=1: every dictionary orientation is distinct here,
    # so scoring is top-1 accuracy + error.
    kw = dict(
        top_n=8, orientation_threshold=3.0, min_required_matches=1,
        batch_size=n_dict * rows, device=dev,
    )
    base_dev = torch.from_numpy(base).to(dev)
    naive_vecs = normed(enc(base_dev))
    naive = IndexPipeline(model, naive_vecs, dict_angles, **kw)
    with torch.inference_mode():
        band_vecs = normed(enc(dict_fn(base_dev)))
    corrected = IndexPipeline(model, band_vecs, dict_angles, preprocess=query_cfg, **kw)

    out: dict = {}

    def run(name, pipe, queries):
        res = pipe(queries)
        top1 = (res.indices[:, 0] == truth_idx).mean()
        want = dict_angles[truth_idx]
        err = np.abs(res.best_orientation - want).max(axis=1)
        print(
            f"{name:24s} top-1 acc {top1:6.1%}   median |err| "
            f"{np.median(err):7.2f} deg"
        )
        out[name] = dict(top1=float(top1), median_err_deg=float(np.median(err)), result=res)
        return top1

    print(f"scan {rows}x{n_dict}, dictionary {n_dict} entries, "
          f"noise {args.noise}, untrained encoder")
    a = run("naive (no correction)", naive, raw)
    b = run("preprocess", corrected, raw)
    den = nlpar_denoise(
        raw.reshape(rows, n_dict, 128, 128), h=2.0, hot_pixel_threshold=6.0, device=dev
    ).reshape(-1, 128, 128)
    c = run("preprocess + NLPAR", corrected, den)
    assert a < b < c, "each correction stage should improve top-1 accuracy"
    assert c > 0.7, "corrected + denoised scan should mostly index"
    print("OK: correction recovers the degraded scan")
    return out


if __name__ == "__main__":
    main()
