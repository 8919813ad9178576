"""Serve the indexing plane over HTTP from the port, on the GPU by default.

    python -m latice_tpu_torch.cli.serve --db latent_index.npz \\
        --checkpoint vae-best.pt --engine fused &
    curl -s localhost:8800/healthz

``--checkpoint`` is a reference-layout ``.pt`` state dict (a JAX checkpoint
converts with `models.flax_params_to_state_dict` and ``torch.save``);
without one the weights are random, drawn from a fixed seed. The model
computes at ``16-mixed`` (bf16 autocast), the precision the JAX serve CLI
builds its model at. Clients POST raw ``.npy`` bytes to ``/index`` and
``/encode``, and ``{"checkpoint": path}`` to ``/reload``, which swaps in
the weights of a ``.pt`` under ``--checkpoint-root``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--db", required=True, help="dictionary npz (index.py build)")
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
    """The `serve.IndexService` that ``main`` serves: the model from
    ``cli._common._load_model`` (``16-mixed``, eval mode, on the device,
    the precision the JAX CLI builds its model at) over the ``--db``
    dictionary, with a ``/reload`` loader (`models.load_checkpoint` at
    ``16-mixed``). Binds no socket."""
    from latice_tpu_torch.cli._common import _load_model
    from latice_tpu_torch.data import parse_preprocess_spec
    from latice_tpu_torch.device import resolve_device
    from latice_tpu_torch.index import LatentVectorDatabaseConfig, TorchLatentVectorDatabase
    from latice_tpu_torch.models import load_checkpoint
    from latice_tpu_torch.serve import IndexService

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
        model,
        db,
        top_n=args.top_n,
        orientation_threshold=args.threshold,
        min_required_matches=args.min_matches,
        batch_size=args.batch_size,
        max_body_bytes=args.max_body_mb << 20,
        engine=args.engine,
        preprocess=preprocess,
        param_loader=param_loader,
        checkpoint_root=checkpoint_root,
        device=device,
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
                "mode": "latent",
                "addr": f"http://{args.host}:{server.server_address[1]}",
                "count": health["count"],
                "device": str(service.pipeline.device),
                "engine": args.engine,
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
