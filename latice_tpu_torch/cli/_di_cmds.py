"""``python -m latice_tpu_torch.cli.index di``: zero-training pattern-space
dictionary indexing, the port of ``latice_tpu/cli/_di_cmds.py``."""

from __future__ import annotations

import json
import logging
import time

import numpy as np
import torch

from latice_tpu_torch.cli._common import (
    _load_phase_stacks,
    _load_raw_pattern_stack,
    mesh_from_flag,
)
from latice_tpu_torch.cli._db_cmds import _parse_preprocess, _resolve_static_auto
from latice_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)


def cmd_di(args) -> None:
    """NCC of a scan against the raw dictionary stack (`index.pattern_di`):
    ``sample`` → ``simulate`` → ``di`` indexes with no trained encoder.
    The scan is read whole: DI is bound by the dictionary, and
    ``static=auto`` needs the scan's mean anyway."""
    from latice_tpu_torch.data import prepare_patterns, write_ang, write_ctf
    from latice_tpu_torch.index import (
        PatternDictionaryIndexer,
        StreamedPatternDI,
        build_pattern_dictionary,
        candidate_ambiguity,
    )

    mesh = mesh_from_flag(args.devices, args.device, "DI")
    device = resolve_device(args.device)
    dict_stack, dict_angles, dict_phases, groups = _load_phase_stacks(
        args.dict_patterns, args.dict_angles, args.phase_groups
    )
    phase_kw = {}
    if dict_phases is not None:
        phase_kw = dict(dictionary_phases=dict_phases, phase_symmetries=groups)
    preprocess = _parse_preprocess(args)
    raw = _load_raw_pattern_stack(args)
    preprocess = _resolve_static_auto(preprocess, raw)
    x = prepare_patterns(raw)
    knobs = dict(
        bin_factor=args.bin,
        top_n=args.top_n,
        orientation_threshold=args.threshold,
        min_required_matches=args.min_matches,
        consensus_weight_power=args.weight_power,
        batch_size=args.batch_size,
        preprocess=preprocess,
        device=device,
        **phase_kw,
    )

    t0 = time.time()
    if args.streamed:
        # Host-resident rows streamed through the card in fixed chunks:
        # dictionaries beyond device memory.
        if mesh is not None:
            logger.warning(
                "--streamed ignores --devices: the streamed engine is the "
                "single-chip beyond-HBM path (shard via the resident "
                "engine instead)"
            )
        rows = build_pattern_dictionary(
            dict_stack,
            bin_factor=args.bin,
            as_numpy=True,
            dtype=torch.bfloat16 if args.search_dtype == "bfloat16" else torch.float32,
            device=device,
        )
        di = StreamedPatternDI(rows, dict_angles, **knobs)
    else:
        di = PatternDictionaryIndexer(
            dict_stack, dict_angles, engine=args.engine, search_dtype=args.search_dtype,
            mesh=mesh, **knobs
        )
    t_build = time.time() - t0
    t0 = time.time()
    result = di(x)
    dt = time.time() - t0
    n = len(x)
    logger.info(
        f"DI-indexed {n} patterns against {len(dict_stack)} dictionary entries in "
        f"{dt:.2f}s ({n / max(dt, 1e-9):,.0f}/s)"
    )
    np.save(args.out, result.best_orientation)
    summary = {
        "n_patterns": n,
        "n_dictionary": len(dict_stack),
        "success_rate": float(result.success.mean()),
        "mean_top_ncc": round(float(result.scores[:, 0].mean()), 4),
        "build_seconds": round(t_build, 2),
        "seconds": round(dt, 2),
        "out": args.out,
    }
    if result.phase is not None:
        phase_out = args.out.replace(".npy", "") + "_phase.npy"
        np.save(phase_out, result.phase)
        summary["phase_out"] = phase_out
        summary["phase_counts"] = np.bincount(result.phase).tolist()
    grid = tuple(args.scan_grid) if args.scan_grid else None
    if args.ang:
        write_ang(args.ang, result, grid=grid, step=args.step, phase_groups=groups)
        summary["ang_out"] = args.ang
    if args.ctf:
        write_ctf(args.ctf, result, grid=grid, step=args.step, phase_groups=groups)
        summary["ctf_out"] = args.ctf
    if args.ambiguity:
        amb = candidate_ambiguity(
            result, dict_angles, phase_groups=groups, dictionary_phases=dict_phases,
            device=device,
        )
        np.savez(
            args.ambiguity, angle_deg=amb.angle_deg, score_gap=amb.score_gap,
            has_rival=amb.has_rival,
        )
        flagged = amb.ambiguous(max_gap=args.ambiguity_gap)
        summary["ambiguity_out"] = args.ambiguity
        summary["ambiguous_frac"] = round(float(flagged.mean()), 4)
        logger.info(
            f"{flagged.sum()} / {len(flagged)} pixels ambiguous "
            f"(rival within {args.ambiguity_gap} NCC score)"
        )
    print(json.dumps(summary))


def register(sub, common) -> None:
    """Attach the di parser."""
    d = sub.add_parser("di", help="pattern-space dictionary indexing (NCC, no trained encoder)")
    d.add_argument(
        "--dict-patterns", required=True, action="append",
        help="simulated dictionary .npy stack ('simulate' output; repeat once per phase)",
    )
    d.add_argument(
        "--dict-angles", required=True, action="append",
        help="angle file paired with --dict-patterns (repeat per phase)",
    )
    d.add_argument(
        "--phase-groups", default=None,
        help="comma-separated point groups, one per phase (e.g. 432,622)",
    )
    d.add_argument(
        "--patterns", required=True,
        help=".npy stack, HDF5 scan or EDAX .up1/.up2 to index",
    )
    d.add_argument("--h5-dataset", default=None,
                   help="HDF5 dataset path (default: the detected pattern stack)")
    d.add_argument("--out", default="orientations.npy")
    d.add_argument(
        "--bin", type=int, default=1,
        help="mean-pool factor of dictionary AND queries before correlating "
        "(compute and residency drop by bin^2)",
    )
    d.add_argument(
        "--engine", default="exact", choices=("exact", "approx", "int8"),
        help="NCC search engine (the fused kernel assumes narrow features, so "
        "it is not offered here)",
    )
    d.add_argument(
        "--search-dtype", default="bfloat16", choices=("bfloat16", "float32"),
        help="dictionary storage dtype (bf16 halves residency; products in f32)",
    )
    d.add_argument("--batch-size", type=int, default=256)
    d.add_argument("--top-n", type=int, default=20)
    d.add_argument("--threshold", type=float, default=3.0)
    d.add_argument("--min-matches", type=int, default=18)
    d.add_argument(
        "--weight-power", type=float, default=None, metavar="P",
        help="NCC^P-weighted consensus mean (default: the uniform mean)",
    )
    d.add_argument(
        "--devices", type=int, default=None,
        help="data-parallel mesh: batch-sharded features + row-sharded "
        "dictionary NCC; ignored with a warning when fewer cards are "
        "attached, N CPU entries with --device cpu (default: single device)",
    )
    d.add_argument(
        "--preprocess", default=None, metavar="SPEC",
        help="correction of the QUERIES only, e.g. 'hotpixels=5,static=auto'; "
        "it must keep the frame shape (bin with --bin)",
    )
    d.add_argument("--ang", default=None, help="also write a TSL/OIM .ang result file")
    d.add_argument("--ctf", default=None, help="also write a Channel Text File (.ctf)")
    d.add_argument("--scan-grid", type=int, nargs=2, metavar=("ROWS", "COLS"), default=None)
    d.add_argument("--step", type=float, default=1.0, help="scan step (um)")
    d.add_argument(
        "--streamed", action="store_true",
        help="stream the dictionary rows from host RAM through the card in "
        "fixed chunks (beyond-memory dictionaries); --engine does not apply",
    )
    d.add_argument(
        "--ambiguity", default=None, metavar="OUT.npz",
        help="also write the pseudo-symmetry diagnostic (index.diagnostics)",
    )
    d.add_argument(
        "--ambiguity-gap", type=float, default=0.02,
        help="NCC margin below which a pixel is counted ambiguous",
    )
    d.add_argument("--device", default=None, help="torch device (default: cuda)")
    d.set_defaults(fn=cmd_di)
