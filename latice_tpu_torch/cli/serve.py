"""Serve the indexing plane over HTTP from the port, on the GPU by default.

    python -m latice_tpu_torch.cli.serve --db latent_index.npz \\
        --checkpoint vae-best.pt --engine fused &
    curl -s localhost:8800/healthz

    # pattern DI: NCC against a simulated stack, no checkpoint, no --db;
    # 4-D (R, C, H, W) bodies are NLPAR-denoised scans
    python -m latice_tpu_torch.cli.serve --di-dict dict.npy \\
        --di-angles grid.txt --nlpar 1 &

    # the zero-training band plane alone: /hough and /quality
    python -m latice_tpu_torch.cli.serve --hough --pc 0.5 0.5 0.7 &

    # dictionary-free spherical indexing alone: /sphere (?ambiguity=1)
    python -m latice_tpu_torch.cli.serve --sphere-master master.npy &

    # HR-EBSD strain against a held reference alone: /strain
    python -m latice_tpu_torch.cli.serve --strain-ref ref.npy --strain-stiffness ni &

``--checkpoint`` is a reference-layout ``.pt`` state dict (a JAX checkpoint
converts with `models.flax_params_to_state_dict` and ``torch.save``);
without one the weights are random, drawn from a fixed seed. The model
computes at ``16-mixed`` (bf16 autocast), the precision the JAX serve CLI
builds its model at. Clients POST raw ``.npy`` bytes to ``/index`` and
``/encode``, and ``{"checkpoint": path}`` to ``/reload``, which swaps in
the weights of a ``.pt`` under ``--checkpoint-root``. In pattern-DI mode
``/encode`` and ``/reload`` answer 400. ``/quality`` (the Hough IQ) answers
in every mode; ``--hough`` adds ``/hough`` (band indexing with cubic
reflectors at ``--pc``/``--tilt``, reduced in ``--group``),
``--sphere-master`` adds ``/sphere`` (spherical-harmonic indexing against
the master at ``--sphere-bandwidth``, same geometry and group) and
``--strain-ref`` adds ``/strain`` (HR-EBSD against that reference pattern
at ``--pc``/``--tilt``, with ``--strain-stiffness`` and
``--strain-remap``); with any of them the server may run without ``--db``
and ``--checkpoint``, the zero-training mode, where ``/index``, ``/encode``
and ``/reload`` answer 400. ``--shard-dictionary`` shards the dictionary and
each batch over every attached card (`parallel.make_mesh`); with one device
it is ignored with a warning.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os

import numpy as np
import torch

logger = logging.getLogger(__name__)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "--db", default=None,
        help="dictionary npz (cli.index build); omit when serving pattern DI via --di-dict",
    )
    p.add_argument(
        "--di-dict", action="append", default=None,
        help="serve pattern DI instead of the latent engine: a simulated "
        "dictionary .npy stack, repeated once per phase (no --db or "
        "--checkpoint; /encode and /reload answer 400)",
    )
    p.add_argument("--di-angles", action="append", default=None,
                   help="angle file paired with --di-dict (repeat per phase)")
    p.add_argument("--di-bin", type=int, default=1,
                   help="DI mean-pool factor (compute and residency drop bin^2-fold)")
    p.add_argument("--phase-groups", default=None,
                   help="comma-separated point groups for multi-phase --di-dict")
    p.add_argument(
        "--nlpar", type=float, default=None, metavar="H",
        help="treat 4-D (R, C, H, W) /index bodies as scans and NLPAR-denoise "
        "them before indexing; H is the smoothing strength in noise sigmas",
    )
    p.add_argument("--nlpar-radius", type=int, default=1,
                   help="NLPAR search-window half-width (default 1 = 3x3)")
    p.add_argument(
        "--shard-dictionary", action="store_true",
        help="shard the dictionary over all attached cards (1-D mesh; per-shard "
        "top-k merged on the first card); ignored with a warning on one device",
    )
    p.add_argument("--checkpoint", default=None, help="reference-layout .pt state dict")
    p.add_argument("--inplanes", type=int, default=32)
    p.add_argument("--latent-dim", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--top-n", type=int, default=20)
    p.add_argument("--threshold", type=float, default=3.0)
    p.add_argument("--min-matches", type=int, default=18)
    p.add_argument(
        "--engine", default="exact", choices=("exact", "fused", "approx", "int8"),
        help="candidate search: exact (matmul + top-k), fused (the CUDA "
        "top-k kernel, scores never in device memory), approx (binned "
        "maxima, ~0.95 recall@k) or int8 (quantized dictionary)",
    )
    p.add_argument(
        "--preprocess", default=None, metavar="SPEC",
        help="pattern correction before the encoder on /index and /encode, "
        "e.g. 'hotpixels=5,static=bg.npy,dynamic=auto' (grammar: "
        "data.parse_preprocess_spec); static=auto is refused, a server has "
        "no scan to take the mean of",
    )
    p.add_argument(
        "--checkpoint-root", default=None,
        help="directory /reload targets must lie under (default: the "
        "directory of --checkpoint; without either, any path)",
    )
    # The zero-training planes: no checkpoint, no dictionary.
    p.add_argument(
        "--pc", type=float, nargs=3, default=(0.5, 0.5, 0.7), metavar=("PCX", "PCY", "DD"),
        help="detector geometry of the /hough, /sphere and /strain planes (pattern "
        "center + distance, width units)",
    )
    p.add_argument("--tilt", type=float, default=0.0,
                   help="detector tilt (degrees) of the zero-training planes")
    p.add_argument("--group", default="432",
                   help="point group of /hough's and /sphere's FZ reduction")
    p.add_argument(
        "--hough", action="store_true",
        help="enable POST /hough: band-based orientation indexing with cubic reflectors at "
        "--pc (zero training; runs without --db)",
    )
    p.add_argument(
        "--sphere-master", default=None, metavar="MASTER.npy",
        help="enable POST /sphere: spherical-harmonic indexing against this master "
        "pattern (zero training; runs without --db)",
    )
    p.add_argument("--sphere-bandwidth", type=int, default=64,
                   help="spherical-harmonic band limit L of /sphere (default %(default)s)")
    p.add_argument(
        "--strain-ref", default=None, metavar="REF.npy",
        help="enable POST /strain: HR-EBSD strain/rotation of every POSTed pattern "
        "against this reference pattern (zero training; runs without --db)",
    )
    p.add_argument(
        "--strain-stiffness", default=None, metavar="PHASE|C11,C12,C44",
        help="cubic stiffness for /strain's traction-free closure and stress output "
        "(preset name or GPa triplet)",
    )
    p.add_argument("--strain-remap", type=int, default=1,
                   help="HR-EBSD iterative remapping passes of /strain (0 disables)")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument(
        "--host", default="127.0.0.1",
        help="bind address; the plane has no authentication (anyone who "
        "reaches it can index and, through /reload, swap in checkpoints "
        "under the root), so bind non-loopback interfaces only on trusted "
        "networks (default: %(default)s)",
    )
    p.add_argument("--port", type=int, default=8800)
    p.add_argument(
        "--max-body-mb", type=int, default=1024,
        help="reject request bodies larger than this with 413 (default: %(default)s MiB)",
    )
    return p.parse_args(argv)


def build_service(args: argparse.Namespace):
    """The `serve.IndexService` that ``main`` serves. Latent mode: the model
    from ``cli._common._load_model`` (``16-mixed``, eval mode, on the
    device, the precision the JAX CLI builds its model at) over the ``--db``
    dictionary, with a ``/reload`` loader (`models.load_checkpoint` at
    ``16-mixed``). Pattern-DI mode (``--di-dict``): the stacks and angles,
    no model. ``--hough`` adds an `index.HoughIndexer` and
    ``--sphere-master`` an `index.SphericalIndexer` and ``--strain-ref`` an
    HR-EBSD reference to either, or they serve alone without ``--db``
    (zero-training mode). ``--shard-dictionary`` serves over a mesh of every
    attached card. Binds no socket."""
    from latice_tpu_torch.cli._common import _load_model, _load_phase_stacks
    from latice_tpu_torch.cli._strain_cmds import _parse_stiffness
    from latice_tpu_torch.data import parse_preprocess_spec
    from latice_tpu_torch.device import resolve_device
    from latice_tpu_torch.index import (
        HoughIndexer,
        LatentVectorDatabaseConfig,
        SphericalIndexer,
        SphericalIndexerConfig,
        TorchLatentVectorDatabase,
    )
    from latice_tpu_torch.models import load_checkpoint
    from latice_tpu_torch.serve import IndexService
    from latice_tpu_torch.sim import DetectorGeometry, cubic_reflectors

    preprocess = None
    if args.preprocess:
        preprocess = parse_preprocess_spec(args.preprocess)
        if isinstance(preprocess.static_background, str):
            raise SystemExit(
                "--preprocess static=auto needs the full scan upfront; a server has "
                "none. Estimate the frame once (cli.index query does, or "
                "data.estimate_static_background) and pass static=<frame.npy>."
            )
    device = resolve_device(args.device)
    mesh = None
    if args.shard_dictionary:
        from latice_tpu_torch.parallel import make_mesh

        if device.type == "cuda" and torch.cuda.device_count() > 1:
            mesh = make_mesh()
            logger.info(f"sharding dictionary over {mesh.size} devices")
        else:
            logger.warning("--shard-dictionary ignored: one device attached")
    common = dict(
        top_n=args.top_n,
        orientation_threshold=args.threshold,
        min_required_matches=args.min_matches,
        batch_size=args.batch_size,
        max_body_bytes=args.max_body_mb << 20,
        engine=args.engine,
        preprocess=preprocess,
        nlpar_h=args.nlpar,
        nlpar_radius=args.nlpar_radius,
        mesh=mesh,
        device=device,
    )
    geometry = DetectorGeometry(pcx=args.pc[0], pcy=args.pc[1], dd=args.pc[2], tilt=args.tilt)
    if args.hough:
        common["hough_indexer"] = HoughIndexer(
            cubic_reflectors(), geometry, group=args.group, device=device
        )
    if args.sphere_master:
        common["sphere_indexer"] = SphericalIndexer(
            np.load(args.sphere_master), geometry,
            SphericalIndexerConfig(bandwidth=args.sphere_bandwidth, symmetry=args.group),
            device=device,
        )
    if args.strain_ref:
        ref = np.load(args.strain_ref)
        common["strain_config"] = dict(
            reference=ref,
            geometry=dataclasses.replace(geometry, shape=ref.shape),
            stiffness=_parse_stiffness(args.strain_stiffness, "--strain-stiffness"),
            remap_iterations=args.strain_remap,
        )
    if args.di_dict:
        if args.db:
            raise SystemExit("--di-dict and --db are mutually exclusive")
        stack, angles, phases, groups = _load_phase_stacks(
            args.di_dict, args.di_angles or [], args.phase_groups
        )
        return IndexService(
            None, None, di_dictionary=(stack, angles, phases, groups), di_bin=args.di_bin,
            **common,
        )
    if not args.db:
        if not (args.hough or args.sphere_master or args.strain_ref):
            raise SystemExit(
                "pass --db (latent engine), --di-dict (pattern DI), or at least one "
                "zero-training plane (--hough / --sphere-master / --strain-ref)"
            )
        return IndexService(None, None, **common)
    model = _load_model(args.checkpoint, args.inplanes, args.latent_dim, device)
    db = TorchLatentVectorDatabase(
        LatentVectorDatabaseConfig(npz_path=args.db, dimension=args.latent_dim)
    )
    if db.get_count() == 0:
        raise SystemExit(f"dictionary {args.db} is empty or missing: build it first")
    checkpoint_root = args.checkpoint_root
    if checkpoint_root is None and args.checkpoint is not None:
        checkpoint_root = os.path.dirname(os.path.abspath(args.checkpoint))

    def param_loader(checkpoint: str):
        model = load_checkpoint(checkpoint, args.inplanes, args.latent_dim, device=device)
        return model.set_precision("16-mixed").eval()

    return IndexService(
        model, db, param_loader=param_loader, checkpoint_root=checkpoint_root, **common
    )


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from latice_tpu_torch.serve import make_server

    service = build_service(args)
    warm_s = service.warmup()
    server = make_server(service, args.host, args.port)
    health = service.health()
    print(
        json.dumps(
            {
                "status": "serving",
                "mode": health["mode"],
                "addr": f"http://{args.host}:{server.server_address[1]}",
                "count": health["count"],
                "planes": health["planes"],
                "device": str(service.device),
                "engine": health["engine"],
                "warmup_s": round(warm_s, 1),
            }
        ),
        flush=True,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
