"""Accuracy benchmark on the PyTorch port: train the VAE, index noisy
patterns, measure error.

The `latice_tpu_torch` twin of ``examples/accuracy_benchmark.py``, the
BASELINE "orientation-match quality gate": render orientation-dependent
synthetic patterns, build a 2-degree-grid dictionary of 4096 entries, train
the VAE on it with the stack resident on the card, and index noisy
re-renders on-grid and off-grid, then pattern DI (no encoder) and, with
``--kinematical`` or ``--dynamical``, the dictionary-free spherical plane and
autodiff refinement through the renderer.

The flags, seeds, draws and printed lines are the JAX script's. The model
starts from the JAX script's own initial weights, ``model.init(key 0)``
(`examples.common_torch.jax_init_state_dict`); the train step's noise
comes from `latice_tpu_torch.train.make_train_step`'s keyed generator (seed
3, step ``s``), the counterpart of ``fold_in(key 3, step)``. ``main``'s
keyword arguments default to the script's constants; the tests shrink
them and feed JAX's weights and noise in through ``state_dict`` and
``eps_fn``. The stages after pattern DI are functions of their inputs
(`spherical_row`, `fitted_reflectors`, `refine_rows`), whose keywords the
tests also shrink.

Run on the card (from the repository root):
    python -m examples.accuracy_benchmark_torch [--kinematical | --dynamical] [--scaled]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R
from examples.common_torch import (
    dictionary_grid,
    encode_dictionary,
    make_model,
    resident_stack,
    train_resident,
)

_DYN_MASTER = {}  # per device


def _dynamical_master(device="cuda"):
    """Bloch-wave fcc-Ni master, 201x201 at 64 beams (cached per device)."""
    key = str(device)
    if key not in _DYN_MASTER:
        from latice_tpu_torch.sim import cubic_structure, dynamical_master_pattern

        t0 = time.time()
        _DYN_MASTER[key] = dynamical_master_pattern(
            cubic_structure("fcc", "ni", 3.52), size=201, n_beams=64, device=device
        )
        print(f"dynamical master 201x201 computed in {time.time()-t0:.1f}s")
    return _DYN_MASTER[key]


def render_patterns(angles_deg, noise=0.0, seed=0, freqs=(9.0, 14.0, 6.0),
                    mode="cosine", device="cuda"):
    """Synthetic band patterns from orientations.

    Default: the fast cosine toy, on the host (``freqs`` sets band
    frequencies per crystal axis; distinct tuples emulate distinct phases).
    The min-max normalization spans the whole call, so a chunked render
    would differ. With ``--kinematical``, physical Kikuchi bands via
    `latice_tpu_torch.sim` (fcc nickel at 20 kV) on ``device``; with
    ``--dynamical``, lookups into the Bloch-wave master. Noise is drawn on
    the host from ``seed`` after the render, as the JAX script draws it.
    """
    rng = np.random.default_rng(seed)
    if mode != "cosine":
        if freqs != (9.0, 14.0, 6.0):
            raise ValueError(
                f"--{mode} renders one fcc-Ni phase; per-phase freqs "
                "are a cosine-toy feature"
            )
        if mode == "dynamical":
            from latice_tpu_torch.sim import render_from_master

            out = render_from_master(
                _dynamical_master(device), np.asarray(angles_deg, np.float64),
                chunk=256, device=device,
            ).astype(np.float32)
        else:
            from latice_tpu_torch.sim import simulate_patterns

            out = simulate_patterns(
                np.asarray(angles_deg, np.float64), chunk=256, device=device
            )
        if noise:
            out = out + rng.normal(size=out.shape).astype(np.float32) * noise
        return np.clip(out, 0, 1)
    mats = R.from_euler("zxz", angles_deg, degrees=True).as_matrix()
    h = w = 128
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    base = np.stack([xx, yy, np.ones_like(xx) * 0.7], -1)
    base /= np.linalg.norm(base, axis=-1, keepdims=True)
    out = np.zeros((len(mats), h, w), np.float32)
    for k, f in enumerate(freqs):
        dot = np.einsum("hwc,nc->nhw", base, mats[:, k, :])
        out += np.cos(f * np.pi * dot).astype(np.float32)
    out = (out - out.min()) / (out.max() - out.min())
    if noise:
        out = out + rng.normal(size=out.shape).astype(np.float32) * noise
    return np.clip(out, 0, 1)


def _eval_pipe(pipe, q_angles, q, tag, readings):
    res = pipe(q.astype(np.float32))
    got = R.from_euler("zxz", np.where(res.success[:, None], res.best_orientation, 0), degrees=True)
    want = R.from_euler("zxz", q_angles, degrees=True)
    err = np.degrees((got.inv() * want).magnitude())
    err = np.where(res.success, err, np.nan)
    print(f"{tag}: success={res.success.mean():.1%} median_err={np.nanmedian(err):.3f} deg "
          f"p90={np.nanpercentile(err, 90):.2f}")
    readings[tag] = dict(success=float(res.success.mean()),
                         median_err_deg=float(np.nanmedian(err)),
                         p90_deg=float(np.nanpercentile(err, 90)), result=res)
    return res


def spherical_row(master, q, q_angles, readings, bandwidth: int = 64, device="cuda"):
    """The dictionary-free plane: spherical cross-correlation of the
    ``(B, H, W)`` queries ``q`` against ``master``, the error of each
    indexed orientation from ``q_angles`` under the cubic group."""
    from latice_tpu_torch.crystal.symmetry import symmetry_reduced_misorientation
    from latice_tpu_torch.index import SphericalIndexer, SphericalIndexerConfig

    t0 = time.time()
    sph = SphericalIndexer(
        master, config=SphericalIndexerConfig(bandwidth=bandwidth, chunk=32), device=device,
    )
    t_setup = time.time() - t0
    t0 = time.time()
    sres = sph.index_patterns(q)
    dt = time.time() - t0
    want_q = np.roll(R.from_euler("zxz", q_angles, degrees=True).as_quat(), 1, axis=1)
    sph_err = np.degrees(symmetry_reduced_misorientation(
        torch.as_tensor(want_q, dtype=torch.float32),
        torch.as_tensor(np.asarray(sres.quaternions), dtype=torch.float32),
    ).numpy())
    print(
        f"spherical L={bandwidth}: median_err={np.median(sph_err):.3f} deg "
        f"p90={np.percentile(sph_err, 90):.2f} "
        f"({len(q)/dt:.0f} patterns/s wall; setup {t_setup:.1f}s)"
    )
    readings["spherical"] = dict(median_err_deg=float(np.median(sph_err)),
                                 p90_deg=float(np.percentile(sph_err, 90)),
                                 patterns_per_s=len(q) / dt, setup_s=t_setup, result=sres)


def fitted_reflectors(master):
    """The ``--dynamical`` refinement's forward model: fcc-Ni bands fitted
    to the Bloch-wave ``master``."""
    from latice_tpu_torch.sim import cubic_reflectors, fit_reflectors_to_master

    t0 = time.time()
    refl, fit_ncc = fit_reflectors_to_master(
        master, cubic_reflectors("fcc", a=3.52, kv=20.0, max_hkl=4, min_d=0.6),
    )
    print(f"fitted {len(refl)} bands to the master (NCC {fit_ncc:.3f}, {time.time()-t0:.1f}s)")
    return refl


def refine_rows(q, q_angles, last_res, dict_angles, readings, reflectors=None,
                steps: int = 40, chunk: int = 256, device="cuda"):
    """Autodiff refinement through the renderer of the ``(B, H, W)``
    queries ``q``: from ``last_res``'s consensus, then from every one of
    its top-k grid candidates with NCC re-ranking. Errors are taken where
    ``last_res`` succeeded."""
    from latice_tpu_torch.crystal import from_euler_zxz_deg
    from latice_tpu_torch.sim import refine_candidates, refine_orientations

    want = R.from_euler("zxz", q_angles, degrees=True)

    def errors(refined_q):
        got = R.from_quat(np.roll(refined_q, -1, axis=1))
        err = np.degrees((got.inv() * want).magnitude())
        return np.where(last_res.success, err, np.nan)

    t0 = time.time()
    init_q = from_euler_zxz_deg(
        torch.as_tensor(last_res.best_orientation, dtype=torch.float32)).numpy()
    refined_q, ncc = refine_orientations(
        q, init_q, steps=steps, chunk=chunk, reflectors=reflectors, device=device
    )
    err = errors(refined_q)
    dt = time.time() - t0
    print(
        f"refined (consensus init): median_err={np.nanmedian(err):.3f} "
        f"deg p90={np.nanpercentile(err, 90):.2f} "
        f"ncc={np.median(ncc):.3f} ({dt:.1f}s)"
    )
    readings["refined (consensus init)"] = dict(
        median_err_deg=float(np.nanmedian(err)), p90_deg=float(np.nanpercentile(err, 90)),
        ncc=float(np.median(ncc)), seconds=dt)

    t0 = time.time()
    cand_q = from_euler_zxz_deg(
        torch.as_tensor(dict_angles[last_res.indices], dtype=torch.float32).reshape(-1, 3)
    ).numpy().reshape(*last_res.indices.shape, 4)
    refined_q, ncc, best_k = refine_candidates(
        q, cand_q, steps=steps, chunk=chunk, reflectors=reflectors, device=device
    )
    err = errors(refined_q)
    dt = time.time() - t0
    print(
        f"refined (top-{cand_q.shape[1]} candidates, NCC re-ranked): "
        f"median_err={np.nanmedian(err):.3f} deg "
        f"p90={np.nanpercentile(err, 90):.2f} ncc={np.median(ncc):.3f} "
        f"overruled={np.mean(best_k != 0):.0%} ({dt:.1f}s)"
    )
    readings["refined (candidates)"] = dict(
        median_err_deg=float(np.nanmedian(err)), p90_deg=float(np.nanpercentile(err, 90)),
        ncc=float(np.median(ncc)), overruled=float(np.mean(best_k != 0)), seconds=dt)


def main(scaled: bool = False, render: str = "cosine", device="cuda", grid: int = 16,
         steps: int = 600, batch: int = 256, n_query: int = 512, inplanes: int = 32,
         latent_dim: int = 16, precision: str = "16-mixed", state_dict=None, eps_fn=None,
         pipe_batch: int = 512) -> dict:
    """The gate; returns every printed figure under its printed tag (the
    pipelines' and the sphere's with their result as ``result``),
    ``final_loss`` and the stages' seconds. The keyword arguments after
    ``render`` default to the JAX script's constants (``inplanes`` and
    ``latent_dim`` apply without ``scaled``)."""
    from latice_tpu_torch import IndexPipeline, resolve_device

    dev = resolve_device(device)
    readings: dict = {"render": render, "scaled": scaled}
    dict_angles = dictionary_grid(grid)
    print("rendering dictionary...", len(dict_angles))
    dict_patterns = render_patterns(dict_angles, mode=render, device=dev)

    # --scaled: the 64-d-latent 6-stage flagship (conf/lightning_module/
    # scaled.yaml) for an accuracy-vs-capacity comparison on the same data.
    if scaled:
        arch = dict(inplanes=64, latent_dim=64, n_stages=6, bottleneck_hw=2)
    else:
        arch = dict(inplanes=inplanes, latent_dim=latent_dim)
    model = make_model(**arch, precision=precision, state_dict=state_dict, device=dev)
    xd = resident_stack(dict_patterns, dev)
    pipe_kw = dict(top_n=10, orientation_threshold=5.0, min_required_matches=3,
                   batch_size=pipe_batch, device=dev)

    def build_and_eval(tag):
        vecs = encode_dictionary(model, xd)
        pipe = IndexPipeline(model, vecs, dict_angles, **pipe_kw)
        q_angles = dict_angles[::8][:n_query]
        q = render_patterns(q_angles, noise=0.15, seed=9, mode=render, device=dev)[..., None]
        _eval_pipe(pipe, q_angles, q, tag, readings)

    print("== random weights ==")
    build_and_eval("random")

    print("== training (device-resident) ==")
    rng = np.random.default_rng(1)
    t0 = time.time()
    metrics = train_resident(model, xd, steps, batch, rng, seed=3, eps_fn=eps_fn)
    loss = float(metrics["loss"])  # waits for the last step
    readings["train_s"] = time.time() - t0
    readings["final_loss"] = loss
    print(f"{steps} steps in {readings['train_s']:.1f}s, final loss {loss:.5f}")
    print("== trained weights ==")
    build_and_eval("trained")

    # Sub-grid refinement: off-grid queries indexed with and without
    # similarity-weighted consensus. Uniform mean = reference parity.
    print("== off-grid refinement (similarity-weighted consensus) ==")
    vecs = encode_dictionary(model, xd)
    rng2 = np.random.default_rng(11)
    q_angles = rng2.uniform([1, 41, 1], [29, 69, 29], size=(n_query, 3))
    q = render_patterns(q_angles, noise=0.15, seed=13, mode=render, device=dev)[..., None]
    last_res = None
    for power in (None, 16, 64, 256):
        pipe = IndexPipeline(model, vecs, dict_angles, consensus_weight_power=power, **pipe_kw)
        last_res = _eval_pipe(pipe, q_angles, q, f"off-grid power={power}", readings)

    # Pattern-space DI baseline: NCC of the same noisy off-grid queries
    # against the raw dictionary stack, no encoder (bf16 table by default).
    print("== pattern-space DI baseline (NCC, no encoder) ==")
    from latice_tpu_torch.index import PatternDictionaryIndexer

    t0 = time.time()
    di = PatternDictionaryIndexer(dict_patterns, dict_angles, **pipe_kw)
    _eval_pipe(di, q_angles, q, "off-grid DI", readings)
    readings["di_s"] = time.time() - t0

    if render != "cosine":
        print("== spherical-harmonic indexing (dictionary-free) ==")
        if render == "dynamical":
            sph_master = _dynamical_master(dev)
        else:
            from latice_tpu_torch.sim import make_kinematical_master

            sph_master = make_kinematical_master(size=513)
        spherical_row(sph_master, q[..., 0], q_angles, readings, device=dev)

    if render == "dynamical":
        # Model mismatch: the dictionary saw dynamical profiles; query with
        # kinematical renders of the same orientations.
        print("== cross-model queries (kinematical renders, dynamical dictionary) ==")
        q_kin = render_patterns(q_angles, noise=0.15, seed=13, mode="kinematical",
                                device=dev)[..., None]
        pipe = IndexPipeline(model, vecs, dict_angles, **pipe_kw)
        _eval_pipe(pipe, q_angles, q_kin, "cross-model", readings)

    if render != "cosine":
        print("== off-grid autodiff refinement (sim.refine, 40 steps) ==")
        refl = fitted_reflectors(_dynamical_master(dev)) if render == "dynamical" else None
        refine_rows(q[..., 0], q_angles, last_res, dict_angles, readings, reflectors=refl,
                    device=dev)
    return readings


if __name__ == "__main__":
    if "--dynamical" in sys.argv:
        _mode = "dynamical"
    elif "--kinematical" in sys.argv:
        _mode = "kinematical"
    else:
        _mode = "cosine"
    main(scaled="--scaled" in sys.argv, render=_mode)
