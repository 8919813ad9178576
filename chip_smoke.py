"""Drive the port's serving path on one CUDA card and check every kernel.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits nonzero without its last line:

1. env: torch and CUDA versions, the card's name and power limit.
2. build: nvcc builds every kernel of ``latice_tpu_torch/ops/csrc`` afresh.
3. kernels: each kernel against its plain torch twin on the card at the
   serving path's shapes, and timed (CUDA events) beside the plain version,
   a library call and the card's bound.
4. serve: the full-width server (inplanes 32, latent 16, 5 stages, a
   100,000-entry dictionary, batch 256, fused engine) answers /healthz,
   /index and /encode over HTTP; the kernels' launch counters, zeroed just
   before, must show 10 InstanceNorm launches and 1 top-k launch per batch.
5. parity: 64 patterns through the card's service and through a CPU
   pipeline (the plain twins) built from the same files.
6. profile: torch.profiler over one /index call of two batches; device
   time by kernel group and the device's idle share of the wall time.

Then one ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi prints them, and last ``{"ok": true, "device": {...}}``.
TF32 is off throughout, so every f32 product is full f32.
"""

from __future__ import annotations

import io
import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth and
# FP32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

BATCH = 256
DICT_ROWS = 100_000
LATENT = 16
INPLANES = 32
TOP_N = 20
ENCODER_SHAPES = [  # (C, H, W) after each encoder conv at 128x128 input; two of each
    (INPLANES, 128, 128),
    (2 * INPLANES, 64, 64),
    (4 * INPLANES, 32, 32),
    (4 * INPLANES, 16, 16),
    (4 * INPLANES, 8, 8),
]
K2_ATOL = 1e-4  # reduction order differs from the plain twin's
K1_ATOL = 1e-6  # FP32 FMA order differs from the plain matmul's
NEAR_TIE = 1e-6


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_FP32_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    return smi


def phase_build() -> None:
    from latice_tpu_torch.ops import _build

    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)  # build from the sources, always
    t0 = time.perf_counter()
    per_source = _build.build()
    emit("build", seconds=time.perf_counter() - t0, per_source=per_source,
         flags=list(_build.NVCC_FLAGS))


def check_norm(gen: torch.Generator) -> dict:
    from latice_tpu_torch.ops import instance_norm_leaky_relu, instance_norm_leaky_relu_plain

    rows, totals = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0)
    max_err = 0.0
    for c, h, w in ENCODER_SHAPES:
        x = torch.randn((BATCH, c, h, w), device="cuda", generator=gen) * 3 + 1
        y, mean, rstd = instance_norm_leaky_relu(x)
        py, pmean, prstd = instance_norm_leaky_relu_plain(x)
        torch.cuda.synchronize()
        err = max((y - py).abs().max().item(), (mean - pmean).abs().max().item(),
                  (rstd - prstd).abs().max().item())
        if not err <= K2_ATOL:
            raise AssertionError(f"K2 at {(BATCH, c, h, w)}: max abs err {err} > {K2_ATOL}")
        max_err = max(max_err, err)
        times = dict(
            ms=cuda_ms(lambda: instance_norm_leaky_relu(x)),
            plain_ms=cuda_ms(lambda: instance_norm_leaky_relu_plain(x)),
            library_ms=cuda_ms(
                lambda: torch.nn.functional.leaky_relu(torch.nn.functional.instance_norm(x), 0.02)
            ),
        )
        n_bytes = 8.0 * x.numel() + 8.0 * BATCH * c  # x in, y out, mean and rstd out
        n_ops = 7.0 * x.numel()  # square, two sums, subtract, scale, compare, slope
        rows.append(dict(shape=[BATCH, c, h, w], max_abs_err=err,
                         bound_ms=bound_ms(n_bytes, n_ops)[0], **times))
        for key in ("ms", "plain_ms", "library_ms"):
            totals[key] += 2 * times[key]  # two blocks per encoder stage
        totals["bytes"] += 2 * n_bytes
        totals["ops"] += 2 * n_ops
        del x, y, py
    b_ms, b_by = bound_ms(totals["bytes"], totals["ops"])
    emit("kernels", kernel="instance_norm_leaky_relu", per_shape=rows)
    return dict(
        name="instance_norm_leaky_relu", route="cuda",
        source="latice_tpu_torch/ops/csrc/fused_norm.cu",
        replaces="latice_tpu/ops/fused_norm.py:149",
        max_abs_err=max_err, ms=totals["ms"], plain_ms=totals["plain_ms"],
        bound_ms=b_ms, bound_by=b_by, library_ms=totals["library_ms"],
        timed_as="the 10 encoder launches of one batch of 256",
    )


def _topk_case(q, d, k, n_valid=None) -> tuple[float, int, torch.Tensor]:
    """Kernel vs plain top-k; returns (max abs score error, near-tie rows,
    the kernel's indices).

    Near ties tolerate a different FP32 summation order: the kernel's
    scores must match the plain scores at the kernel's own indices, its
    k-th score must reach the plain k-th, and indices must be equal on
    every row without two of its first k+1 plain scores within 1e-6.
    """
    from latice_tpu_torch.index.knn import l2_normalize
    from latice_tpu_torch.ops import cosine_topk_fused, cosine_topk_fused_plain

    v, i = cosine_topk_fused(q, d, k, n_valid=n_valid)
    pv, pi = cosine_topk_fused_plain(q, d, k, n_valid=n_valid)
    full = l2_normalize(q) @ d.T
    if n_valid is not None:
        full[:, n_valid:] = float("-inf")
    torch.cuda.synchronize()
    own = full.gather(1, i)
    err = (v - own).abs().max().item()
    if not err <= K1_ATOL:
        raise AssertionError(f"K1 {tuple(q.shape)}x{tuple(d.shape)} k={k}: score err {err}")
    if not bool((v[:, -1] >= pv[:, -1] - K1_ATOL).all()):
        raise AssertionError(f"K1 {tuple(q.shape)} k={k}: k-th score below the plain k-th")
    head = torch.sort(full, dim=1, descending=True, stable=True).values[:, : k + 1]
    near = (head[:, :-1] - head[:, 1:] <= NEAR_TIE).any(dim=1)
    bad = (i != pi).any(dim=1) & ~near
    if bool(bad.any()):
        raise AssertionError(f"K1 {tuple(q.shape)} k={k}: {int(bad.sum())} rows differ")
    return err, int(near.sum()), i


def _unit_rows(n, d, gen):
    x = torch.randn((n, d), device="cuda", generator=gen)
    return x / x.norm(dim=1, keepdim=True)


def check_topk(gen: torch.Generator) -> dict:
    from latice_tpu_torch.index.knn import l2_normalize
    from latice_tpu_torch.ops import cosine_topk_fused, cosine_topk_fused_plain

    dic = _unit_rows(DICT_ROWS, LATENT, gen)
    cases = {}
    q = torch.randn((BATCH, LATENT), device="cuda", generator=gen)
    cases["b256_n100k_k20"] = _topk_case(q, dic, TOP_N)
    cases["b1024_n100k_k10"] = _topk_case(
        torch.randn((1024, LATENT), device="cuda", generator=gen), dic, 10
    )
    cases["ragged_b13_n3001"] = _topk_case(
        torch.randn((13, LATENT), device="cuda", generator=gen), dic[:3001].contiguous(), TOP_N
    )
    base = _unit_rows(7000, LATENT, gen)
    cases["tied_duplicates"] = _topk_case(base[:37].contiguous(), base.repeat(3, 1), 6)
    # Identical rows score bit-identically in the kernel, so its own order
    # must put each row's three copies first, lowest index first.
    copies = torch.arange(37, device="cuda")[:, None] + 7000 * torch.arange(3, device="cuda")
    if not torch.equal(cases["tied_duplicates"][2][:, :3], copies):
        raise AssertionError("K1 tied duplicates: copies not in ascending index order")
    neg = -(_unit_rows(5000, LATENT, gen).abs() + 0.1)
    neg = torch.cat([neg / neg.norm(dim=1, keepdim=True),
                     torch.zeros((1000, LATENT), device="cuda")])
    cases["n_valid_all_negative"] = _topk_case(
        torch.ones((9, LATENT), device="cuda"), neg, TOP_N, n_valid=5000
    )
    cases["k1"] = _topk_case(q, dic, 1)
    cases["k64"] = _topk_case(q, dic, 64)
    cases["d64"] = _topk_case(
        torch.randn((100, 64), device="cuda", generator=gen), _unit_rows(20000, 64, gen), 17
    )
    max_err = max(e for e, _, _ in cases.values())

    qn = l2_normalize(q)
    times = dict(
        ms=cuda_ms(lambda: cosine_topk_fused(q, dic, TOP_N)),
        plain_ms=cuda_ms(lambda: cosine_topk_fused_plain(q, dic, TOP_N)),
        library_ms=cuda_ms(lambda: torch.topk(qn @ dic.T, TOP_N)),
    )
    n_bytes = 4.0 * (q.numel() + dic.numel()) + 12.0 * BATCH * TOP_N
    n_ops = (2.0 * LATENT + 1.0) * BATCH * DICT_ROWS  # one FMA per element, one compare per score
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    emit("kernels", kernel="cosine_topk_fused",
         cases={k: dict(max_abs_err=e, near_tie_rows=n) for k, (e, n, _) in cases.items()},
         shape=dict(B=BATCH, N=DICT_ROWS, D=LATENT, k=TOP_N), **times)
    return dict(
        name="cosine_topk_fused", route="cuda", source="latice_tpu_torch/ops/csrc/topk_fused.cu",
        replaces="latice_tpu/ops/topk_fused.py:220", max_abs_err=max_err,
        bound_ms=b_ms, bound_by=b_by, **times,
        timed_as="B=256, N=100,000, D=16, k=20, dictionary warm in L2",
    )


def _npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _request(url: str, body: bytes | None = None) -> dict:
    def reject(token):
        raise AssertionError(f"non-strict JSON token {token!r}")

    with urllib.request.urlopen(url, data=body, timeout=300) as r:
        if r.status != 200:
            raise AssertionError(f"{url}: HTTP {r.status}")
        return json.loads(r.read(), parse_constant=reject)


def phase_serve(workdir: str) -> tuple[dict, dict, object, str, str]:
    from latice_tpu_torch.index import LatentVectorDatabaseConfig, TorchLatentVectorDatabase
    from latice_tpu_torch.models import VariationalAutoEncoderRawData, load_checkpoint
    from latice_tpu_torch.ops import cosine_topk_fused, instance_norm_leaky_relu
    from latice_tpu_torch.serve import IndexService, make_server

    ckpt, npz = f"{workdir}/vae.pt", f"{workdir}/latent_index.npz"
    model = VariationalAutoEncoderRawData(INPLANES, LATENT)
    torch.save(model.init_weights(torch.Generator().manual_seed(0)).state_dict(), ckpt)
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(DICT_ROWS, LATENT)).astype(np.float32)
    orients = rng.uniform([0, 20, 0], [340, 140, 340], size=(DICT_ROWS, 3))
    db = TorchLatentVectorDatabase(LatentVectorDatabaseConfig(npz_path=npz, dimension=LATENT))
    db.add_vectors(vecs, orients)
    db.save()

    service = IndexService(
        load_checkpoint(ckpt, INPLANES, LATENT, device="cuda"),
        TorchLatentVectorDatabase(LatentVectorDatabaseConfig(npz_path=npz, dimension=LATENT)),
        top_n=TOP_N, batch_size=BATCH, engine="fused", device="cuda",
    )
    warm_s = service.warmup()
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    counters = (instance_norm_leaky_relu, cosine_topk_fused)
    try:
        health = _request(f"{url}/healthz")
        if health["count"] != DICT_ROWS or health["platform"] != "cuda":
            raise AssertionError(f"bad /healthz: {health}")
        for fn in counters:
            fn.launches = 0
        requests = [("index", rng.integers(0, 256, (512, 128, 128), dtype=np.uint8))] * 3
        requests += [("index", rng.uniform(size=(256, 128, 128)).astype(np.float32)),
                     ("encode", rng.integers(0, 256, (64, 128, 128), dtype=np.uint8))]
        index_s, index_n, log = 0.0, 0, []
        for route, x in requests:
            before = [fn.launches for fn in counters]
            t0 = time.perf_counter()
            out = _request(f"{url}/{route}", _npy(x))
            dt = time.perf_counter() - t0
            batches = -(-len(x) // BATCH)
            delta = [fn.launches - b for fn, b in zip(counters, before)]
            want = [10 * batches, batches if route == "index" else 0]
            if delta != want:
                raise AssertionError(f"/{route} of {len(x)}: launches {delta}, want {want}")
            if out["n"] != len(x):
                raise AssertionError(f"/{route}: n={out['n']}")
            if route == "index":
                orient = np.asarray(out["orientations"])
                if orient.shape != (len(x), 3) or not np.all(np.isfinite(orient)):
                    raise AssertionError(f"/index orientations {orient.shape}")
                if len(out["success"]) != len(x) or out["input_dtype"] != str(x.dtype):
                    raise AssertionError("/index success or input_dtype")
                index_s += dt
                index_n += len(x)
            else:
                lat = np.asarray(out["latents"])
                if lat.shape != (len(x), LATENT) or not np.all(np.isfinite(lat)):
                    raise AssertionError(f"/encode latents {lat.shape}")
            log.append(dict(route=route, n=len(x), dtype=str(x.dtype), seconds=dt,
                            launches=delta))
        launches = {fn.__name__: fn.launches for fn in counters}
        batches = {
            "instance_norm_leaky_relu": sum(-(-len(x) // BATCH) for _, x in requests),
            "cosine_topk_fused": sum(-(-len(x) // BATCH) for r, x in requests if r == "index"),
        }
        per_batch = {name: launches[name] / batches[name] for name in launches}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    emit("serve", warmup_s=warm_s, requests=log, index_patterns=index_n,
         index_patterns_per_s=index_n / index_s, launches=launches,
         launches_per_batch=per_batch)
    return launches, per_batch, service, ckpt, npz


def phase_parity(service, ckpt: str, npz: str) -> None:
    """The card's service path against a CPU pipeline over the same files."""
    from latice_tpu_torch.index import (
        IndexPipeline,
        LatentVectorDatabaseConfig,
        TorchLatentVectorDatabase,
        l2_normalize,
    )
    from latice_tpu_torch.models import load_checkpoint

    db = TorchLatentVectorDatabase(LatentVectorDatabaseConfig(npz_path=npz, dimension=LATENT))
    cpu = IndexPipeline(load_checkpoint(ckpt, INPLANES, LATENT), db._vectors, db._orientations,
                        top_n=TOP_N, batch_size=64, engine="fused", device="cpu")
    x = np.random.default_rng(1).integers(0, 256, (64, 128, 128), dtype=np.uint8)
    lat_gpu, lat_cpu = service.encode(x)["latents"], cpu.encode(x)
    lat_err = float(np.abs(np.asarray(lat_gpu, np.float32) - lat_cpu).max())
    if not lat_err <= 1e-4:
        raise AssertionError(f"latents differ by {lat_err}")
    res_gpu, res_cpu = service.pipeline(x), cpu(x)
    scores = l2_normalize(torch.from_numpy(lat_cpu)) @ torch.from_numpy(db._vectors).T
    head = torch.sort(scores, dim=1, descending=True).values[:, : TOP_N + 1]
    # Latents agree to 1e-4, so scores closer than that may swap places.
    near = (head[:, :-1] - head[:, 1:] <= 1e-4).any(dim=1).numpy()
    same = (res_gpu.indices == res_cpu.indices).all(axis=1) & (
        res_gpu.success == res_cpu.success
    )
    if not np.all(same | near):
        raise AssertionError(f"{int((~same & ~near).sum())} rows differ without a near tie")
    emit("parity", rows=len(x), latent_max_abs_err=lat_err, near_tie_rows=int(near.sum()),
         equal_rows=int(same.sum()), success_rows=int(res_cpu.success.sum()))


def _kernel_group(name: str) -> str:
    if "instance_norm_lrelu" in name:
        return "instance_norm_leaky_relu"
    if "topk_partial" in name or "topk_merge" in name:
        return "cosine_topk_fused"
    if any(s in name for s in ("xmma", "fft", "conv", "pointwise_mult_and_sum", "gemm")):
        return "convolution"
    if "max_pool" in name:
        return "max_pool"
    if "Memcpy" in name:
        return "copy"
    return "other"


def phase_profile(service) -> None:
    """Where the device time of one /index call of two batches goes."""
    from torch.profiler import ProfilerActivity, profile

    x = np.random.default_rng(2).integers(0, 256, (2 * BATCH, 128, 128), dtype=np.uint8)
    service.pipeline(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        service.pipeline(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        dev_ms = getattr(evt, "self_device_time_total", 0) / 1e3
        if dev_ms > 0 and evt.self_cpu_time_total == 0:  # device work, not a host op
            kernels.append((evt.key, dev_ms, evt.count))
    groups: dict[str, float] = {}
    for name, dev_ms, _ in kernels:
        groups[_kernel_group(name)] = groups.get(_kernel_group(name), 0.0) + dev_ms
    busy = sum(groups.values())
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    emit("profile", patterns=len(x), wall_ms=wall_ms, device_busy_ms=busy,
         idle_share=1.0 - busy / wall_ms, device_ms=groups,
         top=[dict(kernel=n[:80], ms=t, calls=c) for n, t, c in top])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    import latice_tpu_torch  # noqa: F401  (fail before any output outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_env()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [check_norm(gen), check_topk(gen)]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        launches, per_batch, service, ckpt, npz = phase_serve(workdir)
        phase_parity(service, ckpt, npz)
        phase_profile(service)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_per_batch"] = per_batch[k["name"]]
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was never launched on the main path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
