"""``python -m latice_tpu_torch.cli.index build/export/query``: the
latent-dictionary plane, the port of ``latice_tpu/cli/_db_cmds.py``."""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from latice_tpu_torch.cli._common import _load_model, _open_scan, _refine_result, mesh_from_flag
from latice_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)


def cmd_build(args) -> None:
    from latice_tpu_torch.index import (
        DiffractionPatternIndexer,
        IndexerConfig,
        LatentVectorDatabaseConfig,
        TorchLatentVectorDatabase,
    )

    if len(args.patterns) != len(args.angles):
        raise SystemExit("--patterns and --angles must be given the same number of times")
    groups = args.phase_groups.split(",") if args.phase_groups else None
    if groups and len(groups) < len(args.patterns):
        raise SystemExit(f"{len(args.patterns)} phases but only {len(groups)} --phase-groups")
    # Phase labels persist with more than one phase OR an explicit point
    # group: a single-phase hexagonal dictionary must not fall back to cubic.
    multiphase = len(args.patterns) > 1 or groups is not None
    mesh = mesh_from_flag(args.devices, args.device, "build encode")
    device = resolve_device(args.device)
    model = _load_model(args.checkpoint, args.inplanes, args.latent_dim, device)
    db = TorchLatentVectorDatabase(
        LatentVectorDatabaseConfig(
            npz_path=args.db,
            dimension=args.latent_dim,
            phase_symmetries=groups if multiphase else None,
        ),
        device=device,
    )
    indexer = DiffractionPatternIndexer(
        model,
        db=db,
        config=IndexerConfig(
            pattern_path=args.patterns[0],
            angles_path=args.angles[0],
            batch_size=args.batch_size,
            device=str(device),
            latent_dim=args.latent_dim,
        ),
        mesh=mesh,
    )
    t0 = time.time()
    if multiphase:
        indexer.build_multiphase_dictionary(list(zip(args.patterns, args.angles)))
    else:
        indexer.build_dictionary()
    # Simulation provenance is reset from this build's inputs, so a rebuilt
    # npz never keeps an earlier build's forward model.
    db.sim_meta = None
    if len(args.patterns) == 1:
        sidecar = Path(args.patterns[0] + ".simmeta.json")
        if sidecar.exists():
            db.sim_meta = json.loads(sidecar.read_text())
            logger.info("Persisting simulation provenance for query --refine")
    db.save()
    logger.info(
        f"Built dictionary of {db.get_count()} vectors"
        + (f" across {len(args.patterns)} phases" if len(args.patterns) > 1 else "")
        + f" in {time.time() - t0:.1f}s -> {args.db}"
    )


def cmd_export(args) -> None:
    from latice_tpu_torch.index import DiffractionPatternIndexer, IndexerConfig

    device = resolve_device(args.device)
    model = _load_model(args.checkpoint, args.inplanes, args.latent_dim, device)
    indexer = DiffractionPatternIndexer(
        model,
        config=IndexerConfig(
            pattern_path=args.patterns,
            angles_path=args.angles,
            batch_size=args.batch_size,
            device=str(device),
            latent_dim=args.latent_dim,
        ),
    )
    latents, _ = indexer.export_latents(args.latents_out, args.angles_out)
    logger.info(f"Exported {len(latents)} latent vectors")


def _nlpar(x: np.ndarray, args, hot_pixel_threshold, device) -> np.ndarray:
    """``--nlpar H``: the stack denoised as its ``--scan-grid`` scan
    (`data.nlpar_denoise`), in model units; unchanged without the flag."""
    from latice_tpu_torch.data import nlpar_denoise

    if not args.nlpar:
        return x
    if not args.scan_grid:
        raise SystemExit("--nlpar needs --scan-grid ROWS COLS")
    rows, cols = args.scan_grid
    if len(x) != rows * cols:
        raise SystemExit(f"--scan-grid {rows}x{cols} does not match {len(x)} patterns")
    # NLPAR returns float32, so the pipeline's uint8 /255 would not fire:
    # divide here to stay in model units.
    if x.dtype == np.uint8:
        x = x.astype(np.float32) / 255.0
    x = np.asarray(x, np.float32)
    out = nlpar_denoise(
        x.reshape(rows, cols, *x.shape[1:]),
        search_radius=args.nlpar_radius,
        h=args.nlpar,
        # Hot pixels are repaired BEFORE averaging (they inflate the noise
        # estimate and smear into the window), at the recipe's threshold.
        hot_pixel_threshold=hot_pixel_threshold,
        device=device,
    )
    return out.reshape(x.shape)


def _parse_preprocess(args):
    """``--preprocess`` as a `data.PreprocessConfig`, or None."""
    from latice_tpu_torch.data import parse_preprocess_spec

    return parse_preprocess_spec(args.preprocess) if args.preprocess else None


def _resolve_static_auto(cfg, raw):
    """``static=auto`` replaced by the scan's mean pattern, taken in model
    units (uint8 divided by 255 first, as the pipeline does before the
    recipe runs). ``raw`` is the stack or an iterable of its slabs."""
    import dataclasses

    from latice_tpu_torch.data import estimate_static_background, prepare_patterns

    if cfg is None or not isinstance(cfg.static_background, str):
        return cfg

    def model_units(s):
        s = prepare_patterns(s)
        return s.astype(np.float32) / 255.0 if s.dtype == np.uint8 else s

    chunks = [raw] if isinstance(raw, np.ndarray) else raw
    bg = estimate_static_background(model_units(s) for s in chunks)
    logger.info("static=auto: using the scan-mean background")
    return dataclasses.replace(cfg, static_background=bg)


def cmd_query(args) -> None:
    """Index ``--patterns``: a whole ``.npy`` stack, or an HDF5 or UP scan
    streamed in ``--h5-chunk`` slabs (prefetched on a host thread) unless
    ``--nlpar`` or ``--refine`` needs it whole."""
    from latice_tpu_torch.data import (
        BandDetector,
        prefetch_host,
        prepare_patterns,
        write_ang,
        write_ctf,
    )
    from latice_tpu_torch.index import (
        IndexPipeline,
        LatentVectorDatabaseConfig,
        TorchLatentVectorDatabase,
        candidate_ambiguity,
        concat_dense_results,
    )

    with _open_scan(args) as (raw, batches):
        raw_dtype = raw.dtype
        mesh = mesh_from_flag(args.devices, args.device, "pipeline")
        device = resolve_device(args.device)
        preprocess = _resolve_static_auto(
            _parse_preprocess(args), raw if batches is None else batches()
        )
        model = _load_model(args.checkpoint, args.inplanes, args.latent_dim, device)
        db = TorchLatentVectorDatabase(
            LatentVectorDatabaseConfig(npz_path=args.db, dimension=args.latent_dim), device=device
        )
        if db.get_count() == 0:
            raise SystemExit(f"Database {args.db} is empty — run 'build' first")
        phase_kw = {}
        if db._has_phases:
            phase_kw = dict(
                dictionary_phases=db._phases, phase_symmetries=db.config.phase_symmetries
            )
        pipe = IndexPipeline(
            model,
            db._vectors,
            db._orientations,
            top_n=args.top_n,
            orientation_threshold=args.threshold,
            min_required_matches=args.min_matches,
            consensus_weight_power=args.weight_power,
            batch_size=args.batch_size,
            engine=args.engine,
            mesh=mesh,
            device=device,
            preprocess=preprocess,
            **phase_kw,
        )

        if args.refine and db.sim_meta is None:
            raise SystemExit(
                "--refine needs a dictionary with simulation provenance (built from "
                "'simulate' output); this npz has none"
            )

        hough: dict = {"detector": None, "iq": [], "bands": []}

        def detect(s: np.ndarray) -> np.ndarray:
            """``--hough-iq``: detector-side quality of the raw frames, before
            NLPAR (the vendor .ang IQ and .ctf Bands, not the similarity
            stand-ins), slab by slab."""
            if args.hough_iq:
                if hough["detector"] is None:
                    hough["detector"] = BandDetector(
                        height=s.shape[1], width=s.shape[2],
                        batch_size=min(args.batch_size, 256), device=device,
                    )
                det = hough["detector"](s)
                hough["iq"].append(det.iq)
                hough["bands"].append(det.band_count)
            return s

        hot = preprocess.hot_pixel_threshold if preprocess is not None else None
        t0 = time.time()
        if batches is None or args.nlpar or args.refine:
            # NLPAR averages across scan rows and --refine reads the patterns
            # again after indexing, so a streamed scan is read whole here.
            x = _nlpar(detect(prepare_patterns(np.asarray(raw[...]))), args, hot, device)
            result = pipe(x)
        else:
            # The next slab's disk read and host prep overlap the device work.
            slabs = prefetch_host(prepare_patterns(s) for s in batches())
            try:
                result = concat_dense_results(pipe(detect(s)) for s in slabs)
            finally:
                slabs.close()  # joins the reader before the file closes
            x = None
    n = len(result.success)
    dt = time.time() - t0
    logger.info(
        f"Indexed {n} patterns in {dt:.2f}s ({n / dt:,.0f}/s); "
        f"success rate {result.success.mean():.1%}"
    )
    summary = {
        "n_patterns": n,
        "success_rate": float(result.success.mean()),
        "seconds": dt,
        "out": args.out,
        # uint8 stacks reach the device as uint8 and are divided there;
        # every other dtype reaches the model as float32.
        "input_dtype": str(x.dtype) if x is not None
        else ("uint8" if raw_dtype == np.uint8 else "float32"),
    }
    # Saved BEFORE refinement, so a refinement failure keeps the indexing
    # result; refinement overwrites it on success.
    np.save(args.out, result.best_orientation)
    if args.refine:
        result, refine_summary = _refine_result(
            args, db.sim_meta, x, result, args.refine, db, device
        )
        summary.update(refine_summary)
        np.save(args.out, result.best_orientation)
    if result.phase is not None:
        phase_out = args.out.replace(".npy", "") + "_phase.npy"
        np.save(phase_out, result.phase)
        summary["phase_out"] = phase_out
        summary["phase_counts"] = np.bincount(result.phase).tolist()
    grid = tuple(args.scan_grid) if args.scan_grid else None
    db_groups = (
        list(db.config.phase_symmetries) if db.config.phase_symmetries is not None else None
    )
    ang_kw, ctf_kw = {}, {}
    if hough["iq"]:
        iq, bands = np.concatenate(hough["iq"]), np.concatenate(hough["bands"])
        iq_out = args.out.replace(".npy", "") + "_iq.npy"
        np.save(iq_out, iq)
        summary["hough_iq_out"] = iq_out
        summary["mean_iq"] = round(float(iq.mean()), 4)
        ang_kw, ctf_kw = {"iq": iq}, {"bands": bands}
    if args.ang:
        write_ang(args.ang, result, grid=grid, step=args.step, phase_groups=db_groups, **ang_kw)
        summary["ang_out"] = args.ang
    if args.ctf:
        write_ctf(args.ctf, result, grid=grid, step=args.step, phase_groups=db_groups, **ctf_kw)
        summary["ctf_out"] = args.ctf
    if args.ambiguity:
        amb = candidate_ambiguity(
            result,
            db._orientations,
            phase_groups=db_groups,
            dictionary_phases=db._phases if db_groups else None,
            device=device,
        )
        np.savez(
            args.ambiguity,
            angle_deg=amb.angle_deg,
            score_gap=amb.score_gap,
            has_rival=amb.has_rival,
        )
        flagged = amb.ambiguous(max_gap=args.ambiguity_gap)
        summary["ambiguity_out"] = args.ambiguity
        summary["ambiguous_frac"] = round(float(flagged.mean()), 4)
        logger.info(
            f"{flagged.sum()} / {len(flagged)} pixels ambiguous "
            f"(rival within {args.ambiguity_gap} cosine score)"
        )
    print(json.dumps(summary))


def register(sub, common) -> None:
    """Attach the build, export and query parsers."""
    b = sub.add_parser("build", parents=[common], help="build dictionary DB")
    b.add_argument(
        "--patterns", required=True, action="append",
        help="dictionary .npy stack (repeat once per phase for multi-phase)",
    )
    b.add_argument(
        "--angles", required=True, action="append",
        help="angle file (repeat once per phase, paired with --patterns)",
    )
    b.add_argument(
        "--phase-groups", default=None,
        help="comma-separated point groups, one per phase (e.g. 432,622); "
        "persisted in the npz and applied automatically at query time",
    )
    b.add_argument(
        "--devices", type=int, default=None,
        help="shard the build encode over N devices (data-parallel mesh, "
        "model replicated; latents match the single-device build to float "
        "roundoff); ignored with a warning when fewer cards are attached, N "
        "CPU entries with --device cpu. Default: single device",
    )
    b.set_defaults(fn=cmd_build)

    e = sub.add_parser("export", parents=[common], help="export dictionary latents to .npy")
    e.add_argument("--patterns", required=True, help="dictionary .npy stack")
    e.add_argument("--angles", required=True, help="angle file")
    e.add_argument("--latents-out", default="latents.npy")
    e.add_argument("--angles-out", default="orientations.npy")
    e.set_defaults(fn=cmd_export)

    q = sub.add_parser("query", parents=[common], help="index patterns")
    q.add_argument(
        "--patterns", required=True,
        help=".npy stack, HDF5 scan or EDAX .up1/.up2 to index (scans stream in "
        "--h5-chunk slabs)",
    )
    q.add_argument("--h5-dataset", default=None,
                   help="HDF5 dataset path (default: the detected pattern stack)")
    q.add_argument("--h5-chunk", type=int, default=4096, help="patterns per HDF5/UP slab")
    q.add_argument("--out", default="orientations.npy")
    q.add_argument("--ang", default=None, help="also write a TSL/OIM .ang result file")
    q.add_argument("--ctf", default=None, help="also write a Channel Text File (.ctf)")
    q.add_argument(
        "--scan-grid", type=int, nargs=2, metavar=("ROWS", "COLS"), default=None,
        help="scan shape for .ang/.ctf x-y columns (default: one line)",
    )
    q.add_argument("--step", type=float, default=1.0, help="scan step (um)")
    q.add_argument("--top-n", type=int, default=20)
    q.add_argument("--threshold", type=float, default=3.0)
    q.add_argument("--min-matches", type=int, default=18)
    q.add_argument(
        "--weight-power", type=float, default=None, metavar="P",
        help="similarity^P-weighted consensus mean (default: the uniform mean)",
    )
    q.add_argument(
        "--engine", default="exact", choices=("exact", "fused", "approx", "int8"),
        help="candidate search: exact (matmul + top-k), fused (the CUDA top-k "
        "kernel, scores never in device memory), approx (binned maxima, "
        "~0.95 recall@k) or int8 (quantized dictionary, int8 products)",
    )
    q.add_argument(
        "--devices", type=int, default=None,
        help="run the pipeline data-parallel over N devices: batch-sharded "
        "encode + row-sharded dictionary search; ignored with a warning when "
        "fewer cards are attached, N CPU entries with --device cpu (default: "
        "single device)",
    )
    q.add_argument(
        "--refine", type=int, default=None, metavar="STEPS",
        help="refine each orientation by autodiff against the dictionary's "
        "forward model (needs a dictionary built from 'simulate' output, "
        "whose provenance the npz carries); e.g. 40",
    )
    q.add_argument(
        "--refine-candidates", type=int, default=1, metavar="K",
        help="with --refine: refine each of the top-K candidates and keep the "
        "best NCC (K refinement passes; default: the result only)",
    )
    q.add_argument(
        "--ambiguity", default=None, metavar="OUT.npz",
        help="write the pseudo-symmetry diagnostic (per-pixel angle and score gap "
        "to the best genuinely different candidate) and report the ambiguous fraction",
    )
    q.add_argument(
        "--ambiguity-gap", type=float, default=0.02,
        help="cosine-score margin under which a rival counts as ambiguous "
        "(default: %(default)s)",
    )
    q.add_argument(
        "--hough-iq", action="store_true",
        help="measure the detector-side Hough/Radon IQ of the raw frames (before NLPAR): "
        "<out>_iq.npy, the .ang IQ and the .ctf Bands columns",
    )
    q.add_argument(
        "--nlpar", type=float, default=None, metavar="H",
        help="NLPAR-denoise the scan before indexing (needs --scan-grid); H "
        "is the smoothing strength in noise sigmas (1 conservative, 2-3 strong)",
    )
    q.add_argument("--nlpar-radius", type=int, default=1,
                   help="NLPAR search-window half-width (default 1 = 3x3)")
    q.add_argument(
        "--preprocess", default=None, metavar="SPEC",
        help="on-device pattern correction before the encoder, e.g. "
        "'hotpixels=5,static=auto,dynamic=auto,clip=3' (grammar: "
        "data.parse_preprocess_spec; static=auto is the scan's mean pattern)",
    )
    q.set_defaults(fn=cmd_query)
