"""Drive the port's serving and training paths on one CUDA card and check
every kernel.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits nonzero without its last line (phases 12 and 13 run after 6, then
10, 11, 14, 22, 23, 15, 16, 17, 18, 19, 21 and 24, on the serve phase's
files, before 7, and 20 after 7):

1. env: torch and CUDA versions, the card's name and power limit.
2. build: nvcc builds every kernel of ``latice_tpu_torch/ops/csrc`` afresh.
3. kernels: each kernel against its plain torch twin on the card at the
   shapes its paths give it (serving: B=256 encoder in f32 and bf16 and
   top-k, the top-k also over 1,000,000 rows; training: B=64, the 19
   InstanceNorm shapes of encoder and decoder, f32 and bf16; K3 at B=256,
   C=32, 128x128, at C=16 and C=64, at B=1 and B=257, and at 40x24 and
   64x64; the consensus K4 at B=256, k=20, 3 trials over a 100,000-row
   dictionary, with the cubic table and with 432 + 622; the DI search K5
   at B=256 and B=1 over 333,227 x 16,384 bf16 rows, k=20), and timed
   (CUDA events) beside the plain version, a library call and the card's
   bound.
4. serve: the full-width server as ``python -m latice_tpu_torch.cli.serve``
   builds it (`cli.serve.build_service`: inplanes 32, latent 16, 5 stages,
   16-mixed, a 100,000-entry dictionary, batch 256, fused engine) answers
   /healthz (``"platform": "gpu"``), /index and /encode over HTTP; the
   kernels' launch counters, zeroed just before, must show 10 InstanceNorm
   launches and 1 top-k launch per batch.
5. parity: 64 patterns through the card's service and through the same
   service built on the CPU (the plain twins), both 16-mixed; then the f32
   model on the card against an f32 CPU pipeline built from the same files
   (success may differ only where a trial misorientation lies within 1e-4
   degrees of the threshold).
6. profile: torch.profiler over one /index call of two batches; device
   time by kernel group and the device's idle share of the wall time.
7. train: ``latice_tpu_torch.cli.train``'s path on the ``conf/`` tree at
   its defaults (full width, batch 64, 16-mixed, AMSGrad) for 2 epochs over
   704 seeded synthetic patterns; the counters, zeroed just before, must
   show 19 forward and 19 backward InstanceNorm launches per train step and
   19 forward, 0 backward per eval step; ``last.pt`` must load and encode
   as the trained model does. The decoder is the fused one (each upsample
   folded into the next transposed convolution, the default); the progress
   bar draws each epoch (its last state printed on stderr, one line per
   epoch), and the reconstruction figure is logged or, without
   matplotlib, skipped with the trainer's warning, as the logger shows.
8. train_parity: one f32 train step at full width on the card (kernels)
   and on the CPU (plain twins) from the same weights and noise; each
   gradient leaf of the card must be as close to a float64 reference as
   the CPU's is, and the same step with a wrong norm backward must not.
   Then the fused decoder against the materialized one on the card, f32
   with TF32 off, same weights and input: output and every gradient
   within 5e-5 (tests/models/test_fused_upsample.py's bound).
9. train_profile: torch.profiler over 3 steady train steps of the
   trainer's own epoch loop, with the fused decoder and with
   ``LATICE_TPU_FUSED_UPSAMPLE=0`` from the same weights, in turns (fused,
   materialized, materialized, fused); then the wall per step of each
   without the profiler, 10 pairs of 10 steps, the first of each pair
   alternating.
10. stage0_path: an ``IndexPipeline`` with no model and a ``feature_fn``
    that runs the encoder's stage 0 through K3 (``fused_stage0_apply``)
    and the rest of the encoder and the mu head under bf16 autocast, over
    the serve phase's dictionary (fused engine, 512 patterns); the
    counters, zeroed just before, must show 1 K3, 8 InstanceNorm and 1
    top-k launch per batch, and each latent must be no farther from the
    f32 model's than twice the 16-mixed model's own distance.
11. index_cli: ``latice_tpu_torch.cli.index`` ``build``, ``export`` and
    ``query --engine fused --ang --ctf --ambiguity`` in this process at
    full width with the serve phase's checkpoint, over 16,384 seeded
    synthetic uint8 patterns (the query takes the first 4,096); the
    counters must show 10 InstanceNorm launches per encode batch and 1
    top-k launch per query batch, every query's top-1 must be its own
    dictionary row, and the ``.ang`` file must read back.
12. reload: ``POST /reload`` on the serve phase's service swaps in a second
    seeded checkpoint under its root (``model_version`` 1); ``/index`` and
    ``/encode`` must then answer as the same service built on the CPU from
    that checkpoint (phase 5's rule), with 10 InstanceNorm launches per
    batch and 1 top-k launch per ``/index`` batch; a path outside the root
    answers 400.
13. engines: the served model on 512 patterns through ``IndexPipeline`` with
    each engine (exact, fused, approx, int8, bf16 search): 10 InstanceNorm
    launches per batch, 1 top-k launch per batch on fused only; then each
    search alone at B=256 over 100,000 and 1,000,000 rows, with the blocked
    and streamed (pinned host rows) searches beside them, timed; blocked,
    streamed and fused must give exact's indices (near ties aside), int8 its
    CPU twin's bitwise, approx a recall@10 of 0.9 or more, bf16 exact's
    top-1 on near-duplicate queries.
14. preprocess: ``hotpixels=6,static=auto,dynamic=auto,clip=3,equalize`` on
    256 patterns on the card against the CPU (1e-5 before equalization, the
    equalization bitwise on the same input); then ``cli.index query
    --preprocess`` over phase 11's files: 10 InstanceNorm and 1 top-k
    launch per batch.
15. dictionary: the native dictionary loop at full width. ``cli.index
    sample --group 432 --resolution 2`` (18,467 orientations) and
    ``simulate --uint8`` on the card, timed; 256 of its patterns against
    the CPU render (1e-5 in f32, at most 1 uint8 level in at most 0.1% of
    pixels), again under ``torch.set_float32_matmul_precision("high")``; a
    64x64 scan of 256 seeded grains rendered on the card plus seeded noise;
    NLPAR of it, timed, its first 8 rows against the CPU at relative 1e-5;
    pattern DI (exact, bf16) of the clean, noisy and denoised scans, timed,
    each median disorientation to the truth under the grid's 2 degrees,
    with 1 K5 launch per batch, ``StreamedPatternDI`` equal to the resident
    indexer with none, and the server's DI mode (`IndexService` over the
    same stack) with 1 K5 launch per batch and the resident answers; refinement at
    40 steps, timed: at the default rate from the truth turned 1.5 degrees
    (tests/sim/test_refine.py's setting), median under 0.15 degrees, each
    error under a third of its start and every NCC above 0.95; and from the
    DI result, at the default rate (reported) and at 6e-3 (median under
    0.15 degrees); then ``cli.index build`` of the grid's patterns and
    ``query --engine fused --nlpar 1 --scan-grid 64 64 --refine 10`` of the
    noisy scan: 10 InstanceNorm launches per build and query batch and 1
    top-k launch per query batch.
16. bands: the band plane at full width. 1,024 fcc renders (and a noisy
    copy); `BandDetector` on the card against the CPU on 256, slot by slot
    up to the first near tie; `HoughIndexer` against the CPU on 64, and
    over all held to tests/index/test_hough_indexing.py's median bound and
    to the JAX package's own share within its per-pattern bounds on the same
    inputs (examples/hough_jax_reference.py); multi-phase fcc + hcp against
    the true phases, as JAX places them; ``quality``, ``hough --ang`` and
    ``hough --refine 20`` (the refined median below the raw) through the
    CLI; ``query --hough-iq --engine fused`` over phase 11's files (10
    InstanceNorm and 1 top-k launch per batch, the IQ the detector's);
    ``calibrate --pin`` at 128x128, shared and affine, held to
    tests/sim/test_calibrate.py's bounds; ``cli.serve --hough`` with no
    dictionary (``/healthz``, ``/quality``, ``/hough`` against direct
    calls); and the times of detection (with its product's alternatives),
    vote, refinement and a calibration step.
17. sphere: the master-pattern plane at full width (master 513, 128x128,
    L=64, bin 2, chunk 64, 432, Newton 8 steps). 1,024 fcc renders from
    the kinematical master on the card against the CPU's (1e-5);
    `SphericalIndexer` in the grid, parabolic and Newton modes over one
    shared table build, timed (CUDA events), split by stage per chunk
    (projection, l-contraction, α-DFT, γ-DFT, argmax, Newton) with each
    stage's bound, held to the JAX package's accuracy on the same inputs
    (examples/sphere_jax_reference.py) and per pattern to the port's CPU
    path on 64; the ambiguity diagnostic on 256 and multi-phase fcc + hcp,
    held to JAX's; ``simulate --master --fit-bands`` over the 2-degree
    grid, ``build`` and ``query --engine fused --refine 10`` of 4,096 (10
    InstanceNorm launches per build and query batch, 1 top-k launch per
    query batch), ``learn-master`` from 4,096 (its NCC to the source
    master), ``sphere --ang`` of 1,024 (equal to the library's Newton); a
    ``cli.serve --sphere-master`` server's ``/sphere`` of 256 with and
    without ``?ambiguity=1``.
18. strain: HR-EBSD and the scan readers at bench.py's hrebsd row
    (128x128, the 21 default ROIs of 64x64, kappa 20, chunk 128).
    `hrebsd_map` on 512 seeded truth patterns (strains to 2e-3, rotations
    to 3 degrees) with 0 and 1 remap passes, without and with the Ni
    stiffness, held to the JAX package's readings on the same inputs
    (examples/hrebsd_jax_reference.py) and, on 64, to the port's CPU path
    stage by stage; the JAX suite's two anchors at 256x256 at 1e-4; the
    warp, `_xcorr_shifts` and the solve of one chunk timed (CUDA events,
    profiler) with their bounds, and `hrebsd_map` over a 64x64 uint8 scan
    (patterns/s, idle share); then ``strain --patterns scan.up2 --ref 0
    --stiffness ni --remap 1`` (equal to the library on its frames), a
    ``cli.serve --strain-ref`` server's ``/strain`` of 256 (equal to the
    library), and ``build`` + ``query --engine fused`` of the ``.up2`` scan
    (10 InstanceNorm launches per build and query batch, 1 top-k launch
    per query batch, the header's 64x64 grid in the ``.ang``).

19. master: the dynamical master at ``cli.index master``'s defaults
    (201x201, 64 beams). 1,024 seeded generic directions on the real path
    (fcc Ni), the 2N embedding (zincblende GaAs) and the measured-depth
    quadrature, each traced and held to the port's CPU path and to the JAX
    package's readings (examples/dynamical_jax_reference.py) at 1e-3
    relative; ``eigh`` alone on one chunk of 2,048, real and embedded (and
    MAGMA's on the real one), beside its bound; ``master`` for both
    structures through the CLI, the fcc master held to the port's CPU
    master by its median and 99th-percentile error; the Monte-Carlo
    simulation at its defaults (200,000 electrons, tilt 70 degrees),
    traced, its yield, energy weights and depth percentiles held to the
    JAX package's statistics; ``master --mc`` with its energy bins cut (the
    cut is printed); then ``simulate --master --fit-bands`` of the 2-degree
    grid from the master's sidecar, ``build`` and ``query --engine fused``
    of 4,096 (10 InstanceNorm launches per build and query batch, 1 top-k
    launch per query batch).
20. train_robust: ``cli.train trainer=robust data_module=streamed`` at
    full width (16-mixed, batch 64, the conf's augmentation, denoising)
    for 2 epochs over a seeded ``.up2`` scan of 2,048 patterns, streamed:
    19 forward and 19 backward InstanceNorm launches per train step, 19
    and 0 per eval step; the augmentation's application on the card
    against the CPU on the same draws (1e-6); one step's gradients with
    ``remat=stage`` against ``remat=none`` (18 more forward launches for
    the recompute), with the peak memory of each.
21. analyze: the orientation-map analysis plane. The chain: ``query
    --engine fused --ang scan.ang --scan-grid 64 64`` of the dictionary
    phase's scan (10 InstanceNorm and 1 top-k launch per batch), then
    ``analyze --orientations scan.ang`` with ANALYZE_FLAGS (grain
    statistics, CSL, Schmid, Taylor, Young's modulus, GND, components,
    texture index, cleanup). A seeded 1024x1024 map of 4,096 grains with
    planted Σ3 twins and Cube and Goss grains through the same command,
    traced (wall, device busy, idle share, peak memory) and held to its
    truth: its grains equal the noise-free map's, every planted twin edge
    is Σ3, and the Σ3, Cube and Goss shares are at least the planted ones
    and exceed them by no more than the maps with nothing planted give;
    each stage alone (events, device busy, host, launches, peak memory,
    bound); its top-left 128x128 crop through the command on the card and
    on the CPU, every output held (labels equal but at an angle within
    0.05 degrees of a limit, angle fields through cos(θ/2) or 0.05 degrees,
    factors and densities at 1e-4 relative), and its readings held to the
    JAX package's (examples/analyze_jax_reference.py); and ``analyze
    --parent ks`` of a 512x512 forward-simulated martensite map of 16
    parents, every planted parent recovered within 0.5 degrees.
22. tools: the host runtime and the utilities, under a minute. The
    native engine (``engine="native"``, g++-built) over the serve phase's
    100,000 rows, 256 queries host-timed, its indices equal to the exact
    engine's on the card but at near ties; ``write_ang`` and ``write_ctf``
    of 262,144 points through the native formatter and the Python loop,
    byte-equal, each timed; one ``IndexPipeline`` call of 512 patterns
    under ``utils.trace``, read back by ``utils.summarize_trace`` (its
    kernel and copy total within 2% of the profiler's own sum, the
    InstanceNorm and top-k kernels named among its ops); ``get_platform()``
    is ``"gpu"`` and ``PhaseTimer(sync=True)`` times one encode.
23. mesh: every multi-device path on a mesh that names the card four
    times (``make_mesh(devices=["cuda:0"] * 4)``; with more cards attached
    the search and the pipeline run again over ``make_mesh()``), each
    against the same path on one device. The DP train step at full width,
    f32 with TF32 off: at B=64 the loss (rtol 1e-5) and the first parameter
    leaf after the update (1e-5), at B=8 every gradient leaf by phase 8's
    rule against a float64 CPU step (B=64's gradients reported: an f32
    full-width gradient is conditioned at ~1e-2, see phase 8); then
    ``Trainer.fit`` for one epoch over 3*4+1 rows at batch 8 (the tail
    padded). The counters must show 19 forward and 19 backward
    InstanceNorm launches per replica and train step, 19 forward per
    replica and eval step. ``IndexPipeline`` over the serve phase's files
    with the exact and the fused engine on 512 patterns: the f32 model's
    indices equal one device's but where two scores lie within twice the
    row's latent distance; 10 InstanceNorm launches per shard and batch and
    1 top-k launch per shard and batch on fused; timed at 16-mixed. The
    sharded search alone at B=256 over 1,000,000 rows: exact, fused and
    int8 bit for bit their unsharded selves, approx at recall@10 >= 0.9,
    each timed beside one device. `DiffractionPatternIndexer` (latents
    1e-5), the service (``/healthz`` ``mesh_devices`` 4; ``/index`` and
    ``/encode``), pattern DI, `HoughIndexer` (band score at least one
    device's minus 0.01; pattern DI's bf16 search against the CPU's mesh
    path over the card's table, 1e-5), `SphericalIndexer` and its
    ambiguity (1e-5),
    ``hrebsd_map`` (``a`` within 1e-6, 0 and 1 remap passes), the dynamical
    master and the Monte Carlo (bit for bit); ``index build|query
    --devices 4``, ``serve --shard-dictionary`` and ``master --devices 2``
    on one card log the JAX CLI's warning and run on one device.
24. examples: the twins of ``examples/`` at their scripts' sizes. The
    accuracy gate (``examples/accuracy_benchmark_torch.py``: 600 train steps
    at B=256 over the 4,096-entry resident dictionary, inplanes 32,
    16-mixed) in the default and ``--kinematical`` modes, its rows held
    to `EXAMPLES_BANDS` (their sources are given there) and its K2f
    and K2b launches to `_gate_launches`; then the six demos
    (``examples/*_demo_torch.py``) at their defaults, each holding its own
    asserts, with their figures, walls and launches reported.

Every path that indexes also counts the consensus kernel K4: 1 launch per
indexed batch, whatever the engine (on a mesh, once a batch on its first
device); a path's counts are zeroed just before it runs.

Then one ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi prints them, and last ``{"ok": true, "device": {...}}``.
``--topk-only`` runs phases 1 and 2, the top-k kernel's checks and times
and a sweep of its launch plan, and prints no verdict line;
``--stage0-only`` runs phases 1 and 2 and the stage-0 kernel's checks and
times, and prints no verdict line; ``--sphere-only``, ``--strain-only``,
``--master-only`` and ``--analyze-only`` run phases 1, 2 and 17, 18, 19
or 21 (with a seeded checkpoint of their own; ``--analyze-only`` builds
the dictionary and scan it needs), and print no verdict line;
``--mesh-only`` runs phases 1, 2 and 23 on the serve phase's seeded files
and prints the mesh path's launches and no verdict line; ``--examples-only``
runs phases 1, 2 and 24 and prints the examples path's launches and no
verdict line.
Nothing here sets TF32: cuDNN's flag stays at PyTorch's default (True),
and the port's f32 models turn it off around their own forward and
backward (``device.no_tf32``), which phases 5 and 8 check from hooks on
every convolution. K3's twin convolves bf16-valued operands, which TF32
represents exactly.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import importlib.util
import io
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bandwidth,
# FP32 outside the tensor cores and dense bf16 on the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12

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
SCALED_ENCODER_SHAPES = [  # the same at vae_scaled's widths (inplanes 64, 6 stages)
    (64, 128, 128), (128, 64, 64), (256, 32, 32), (256, 16, 16), (256, 8, 8), (256, 4, 4),
]
TRAIN_BATCH = 64
DECODER_SHAPES = [  # (C, H, W) after each decoder transposed conv, in order
    (4 * INPLANES, 8, 8), (4 * INPLANES, 8, 8),
    (4 * INPLANES, 16, 16), (4 * INPLANES, 16, 16),
    (4 * INPLANES, 32, 32), (2 * INPLANES, 32, 32),
    (2 * INPLANES, 64, 64), (INPLANES, 64, 64),
    (INPLANES, 128, 128),
]
TRAIN_SHAPES = [s for s in ENCODER_SHAPES for _ in range(2)] + DECODER_SHAPES  # the 19 norms
TRAIN_PATTERNS = 704  # 634 training rows: 10 batches of 64, the last masked
# train_robust: `trainer=robust data_module=streamed` over a seeded .up2 scan
# of 2,048 patterns (a 32x64 grid): 1,844 training rows, 29 batches of 64.
ROBUST_PATTERNS, ROBUST_GRID = 2048, (32, 64)
AUGMENT_ATOL = 1e-6  # the augmentation's application, card against CPU on the same draws
# remat=stage against remat=none at 16-mixed: each gradient leaf within twice
# the difference of two remat=none steps plus REMAT_RTOL, both over the
# leaf's largest |gradient| (a wrong recompute is off by O(1)).
REMAT_RTOL = 1e-3
EXPORT_ROWS = 262_144  # a 512x512 map through write_ang and write_ctf
# mesh: every multi-device path on a mesh naming the card MESH_SHARDS times.
MESH_SHARDS = 4
MESH_PATTERNS = 512  # pipeline, indexer: two batches of 256, 64 rows per shard
MESH_FIT_PATTERNS, MESH_FIT_BATCH = 14, 8  # 3*4+1 training rows after the 0.1 split
MESH_STEP_TIMED = 10  # DP and one-device steps timed, each
MESH_LOSS_RTOL, MESH_PARAM_ATOL = 1e-5, 1e-5  # DP step vs one device
MESH_GRAD_BATCH = 8  # the DP gradients held against f64 (train_parity's rule), 2 rows a replica
MESH_LATENT_ATOL, MESH_SCORE_ATOL = 1e-5, 1e-5  # f32 latents; DI and sphere scores
MESH_HOUGH_SLACK = 0.01  # band score at least one device's minus this (dryrun_multichip)
MESH_CLI_PATTERNS = 512
MESH_DI_ROWS, MESH_DI_QUERIES, MESH_HOUGH_PATTERNS = 2048, 256, 256
MESH_SPHERE_L, MESH_SPHERE_PATTERNS = 32, 256
MESH_STRAIN_PATTERNS = 256
MESH_MASTER_SIZE = 45  # 2,025 directions: one chunk of 2,048, 512 per shard
MESH_MC_ELECTRONS, MESH_MC_CHUNK = 262_144, 65_536  # one walker chunk per shard
FUSED_ATOL = 5e-5  # fused against materialized decoder, f32: tests/models/test_fused_upsample.py
# examples: the accuracy gate (examples/accuracy_benchmark_torch.py) in two
# modes and the six demo twins, at their scripts' sizes. The gate's bands:
# (least success, most median error in degrees) per printed row; the sphere
# and the refinements print no success. From the JAX script's readings
# (examples/accuracy_benchmark.py:7-13, 34-36: 100% success, 1.95/1.85
# degrees; --kinematical 2.35/2.79, DI 0.335, refined 1.13), set before the
# first card run but for the sphere's and the top-10 refinement's, which
# the script does not read out: those two are about four times the card's
# first readings (0.117 and 0.132 degrees, NVIDIA H100 80GB HBM3, 700 W).
EXAMPLES_GATE_MODES = ("cosine", "kinematical")
OFF_GRID_ROWS = tuple(f"off-grid power={p}" for p in (None, 16, 64, 256))
EXAMPLES_BANDS = {
    "cosine": {"trained": (0.99, 2.5), **{row: (0.99, 2.5) for row in OFF_GRID_ROWS}},
    "kinematical": {"trained": (0.99, 3.0), **{row: (0.99, 3.5) for row in OFF_GRID_ROWS},
                    "off-grid DI": (0.99, 0.6), "spherical": (None, 0.5),
                    "refined (consensus init)": (None, 1.5), "refined (candidates)": (None, 0.5)},
}
EXAMPLES_GATE = dict(grid=16, steps=600, batch=256, n_query=512, pipe_batch=512)
EXAMPLES_DEMOS = ("end_to_end", "orientation_map", "multiphase", "raw_data", "full_workflow",
                  "parent_reconstruction")
K2_ATOL = 1e-4  # reduction order differs from the plain twin's
K2_BF16_ATOL = 1e-2  # bf16 outputs: 1e-2 plus one bf16 ulp of the value (K2_BF16_RTOL),
K2_BF16_RTOL = 2.0**-7  # since kernel and twin may round an f32 value near a tie apart
GRAD_RATIO, GRAD_FLOOR = 2.0, 1e-4  # train_parity's limit per leaf (see there)
K1_ATOL = 1e-6  # FP32 FMA order differs from the plain matmul's
NEAR_TIE = 1e-6
STAGE0_PATTERNS = 512  # stage0_path: two batches
CLI_DICT, CLI_QUERY = 16_384, 4_096  # index_cli: dictionary and query patterns
BIG_DICT_ROWS = 1_000_000  # K1's second timed shape: 64 MB, beyond the L2
# K4 at the index path's shapes (B=256, k=TOP_N) over a dictionary of
# K4_ROWS rows in clusters of K4_CLUSTER, at the CLIs' consensus defaults.
K4_ROWS, K4_CLUSTER = 100_000, 250
K4_THRESHOLD, K4_MIN_MATCHES, K4_ITERS = 3.0, 18, 3
# f32 rounding may decide a trial match apart nearer the threshold than
# K4_MARGIN_DEG; orientations within K4_ORIENT_DEG (tests/test_torch_consensus_fused.py).
K4_MARGIN_DEG, K4_ORIENT_DEG = 1e-4, 1e-3
# K5 at the DI cell's shapes: EMsoft's cubochoric N = 100 dictionary in 432,
# unbinned 128x128 NCC features. The tensor cores' f32 sums drop each
# step's bits below the running sum's last place: over 1,024 steps a score
# near 1 drifts up to ~1e-4 from cuBLAS's (tests/test_torch_topk_wide.py).
K5_ROWS, K5_DIM, K5_TIE = 333_227, 16_384, 2e-4
ENGINE_PATTERNS = 512  # engines: two batches through each engine's pipeline
BLOCK_ROWS = 131_072  # blocked and streamed engines: rows per block or chunk
ENGINE_RECALL_MIN = 0.9  # approx's recall@10 against exact
DB_ENGINES = ("device", "fused", "approx", "int8", "native")  # the latent database's engines
PREPROCESS_RECIPE = "hotpixels=6,static=auto,dynamic=auto,clip=3,equalize"
PREPROCESS_PATTERNS = 256
PREPROCESS_ATOL = 1e-5  # card vs CPU before equalization (blur sums in another order)
RELOAD_PATTERNS = 32
DICT_GROUP, DICT_RESOLUTION, GRID_ROWS = "432", 2.0, 18_467  # dictionary: the 2-degree grid
SCAN_SIDE, SCAN_GRAINS, SCAN_NOISE = 64, 256, 0.1  # a 64x64 scan of 256 grains, noise sigma
SIM_HOLD = 256  # rendered patterns held against the CPU render
SIM_ATOL, SIM_UINT8_SHARE = 1e-5, 1e-3  # test_torch_sim.py's limits
NLPAR_HOLD_ROWS, NLPAR_RTOL = 8, 1e-5  # the first slab of 8 scan rows against the CPU
DI_MEDIAN_MAX_DEG = 2.0  # the grid's spacing
REFINE_PATTERNS, REFINE_STEPS, REFINE_MEDIAN_MAX_DEG = 256, 40, 0.15  # tests/sim/test_refine.py
REFINE_TURN_DEG, REFINE_NCC_MIN = 1.5, 0.95  # tests/sim/test_refine.py's start and NCC floor
# 40 Adam steps at the default lr 2e-3 travel at most ~1.3 degrees per axis
# (the decayed rates sum to ~11.6 lr), short of the 2-degree grid's DI
# error (the phase reports the default rate's result from DI); at 6e-3
# they travel ~4.
REFINE_LR = 6e-3
# bands: 1,024 fcc renders at full width (Radon 90x96, the 3-degree 432 grid,
# batch 256), 256 fcc + 256 hcp for the multi-phase run, and a noisy copy.
BANDS_PATTERNS, BANDS_HOLD, HOUGH_HOLD, MULTI_PER_PHASE = 1024, 256, 64, 256
BANDS_NOISE = 0.05
BANDS_SEEDS = dict(fcc=30, multi_fcc=31, multi_hcp=32, noise=33, calibrate=34)
HCP = dict(a=2.95, c=4.68)  # titanium
MULTI_BANDS = 10  # vendors run 9-12 bands for hexagonal phases
# tests/index/test_hough_indexing.py's accuracy bounds (set at 64x64 on a
# 4-degree grid over 14 patterns): median and largest disorientation, fit,
# matched bands, all successful.
HOUGH_MEDIAN_MAX_DEG, HOUGH_MAX_DEG, HOUGH_FIT_MAX_DEG, HOUGH_MIN_MATCHED = 1.5, 4.0, 3.0, 5
# The JAX package's readings on this phase's inputs, on the CPU
# (examples/hough_jax_reference.py): at full width over 1,024 random
# orientations its own share of patterns within every per-pattern bound
# above is 97.5%, not all, and 15 of the 512 multi-phase patterns land in
# the wrong phase. The port is held to the median bound and to these
# shares, less `HOUGH_SHARE_SLACK` (10 of 1,024 patterns; the card's renders
# differ from JAX's by ~2e-6 and near-tied bands may tip a marginal one).
JAX_HOUGH_WITHIN, JAX_MULTI_WITHIN = 0.974609375, {"432": 0.953125, "622": 0.921875}
JAX_MULTI_PHASE_WRONG = 15
HOUGH_SHARE_SLACK = 0.01
HOUGH_HOLD_DEG = 0.01  # card vs CPU where both detected the same bands
# Card vs CPU detector: the GEMM and the sums run in another order (measured
# 1.9e-5 on strengths ~1); two bands closer than twice that may swap.
BAND_STRENGTH_ATOL, BAND_TIE = 1e-4, 2e-4
CAL_PATTERNS, CAL_STEPS = 32, 300  # tests/sim/test_calibrate.py's pinned setting
CAL_PC_TRUE = (0.52, 0.47, 0.68)
# The affine model per scan step over a 4x8 raster: pcx -0.03 across x,
# pcy +0.02 and dd +0.01 across y, as tests/sim/test_calibrate.py's scan.
CAL_GRID = (4, 8)
CAL_GRADIENT = ((-0.03 / 7, 0.0), (0.0, 0.02 / 3), (0.0, 0.01 / 3))
# sphere: the master-pattern plane at full width (bench.py's sphere row): a
# kinematical fcc master of 513, 128x128 detector, L=64, bin 2, chunk 64,
# 432, Newton 8 steps; 1,024 renders, 256 for the ambiguity diagnostic,
# 256 fcc + 256 hcp for the multi-phase run, 64 held against the CPU path.
SPHERE_MASTER, SPHERE_L, SPHERE_BIN, SPHERE_CHUNK = 513, 64, 2, 64
SPHERE_PATTERNS, SPHERE_AMBIGUITY, SPHERE_MULTI, SPHERE_HOLD = 1024, 256, 256, 64
SPHERE_SEEDS = dict(fcc=40, multi_fcc=41, multi_hcp=42)
# Cells the ambiguity diagnostic ranks: at L=64 the winner's own basin
# (2 x 180/64 degrees) covers the default 32, and no rival is ever found.
SPHERE_AMB_CELLS = 256
SPHERE_MODES = ("grid", "parabolic", "newton")
SPHERE_RENDER_ATOL = 1e-5  # test_torch_master.py's bound, card vs CPU render
# Card (bf16 tables, f32 sums) against the port's CPU path (f32 tables and
# products) per pattern on SPHERE_HOLD patterns: each orientation within
# SPHERE_HOLD_DEG, but for SPHERE_HOLD_OUTLIERS (a peak near-tied between
# two grid cells may take the other under bf16 rounding), each score within
# SPHERE_SCORE_ATOL. The first run on an H100 80GB HBM3 (700 W) measured
# at most 0.069 (grid), 0.037 (parabolic), 0.036 (Newton) degrees, none
# beyond 0.1, and scores within 7.0e-4.
SPHERE_HOLD_DEG, SPHERE_HOLD_OUTLIERS, SPHERE_SCORE_ATOL = 0.1, 2, 2e-3
# Against the JAX package's readings on the CPU (float32 tables): the
# median at most SPHERE_MEDIAN_SLACK_DEG above, each share within 1/2/4
# degrees (and the ambiguity shares) at most SPHERE_SHARE_SLACK off, the
# median ambiguity gap within SPHERE_GAP_ATOL. That run: medians within
# 0.0026 degrees, shares within 0.003, the gap within 2.6e-5.
SPHERE_MEDIAN_SLACK_DEG, SPHERE_SHARE_SLACK, SPHERE_GAP_ATOL = 0.02, 0.01, 1e-3
# The band fit of the kinematical master and the master learned back from
# 4,096 of its renders (that run: 1.0 and 0.9990).
SPHERE_FIT_NCC_MIN, SPHERE_LEARN_NCC_MIN = 0.99, 0.99
# The JAX package's readings on this phase's inputs, on the CPU
# (examples/sphere_jax_reference.py: its own renders, f32 tables).
JAX_SPHERE = {
    "grid": {"median_deg": 0.7880949152771654, "max_deg": 2.0095843454956492,
        "within_1deg": 0.712890625, "within_2deg": 0.9990234375, "within_4deg": 1.0,
        "mean_score": 0.31836211681365967},
    "parabolic": {"median_deg": 0.28657672947555923, "max_deg": 2.090086860481747,
        "within_1deg": 0.9853515625, "within_2deg": 0.9990234375, "within_4deg": 1.0,
        "mean_score": 0.31836211681365967},
    "newton": {"median_deg": 0.07665966734540368, "max_deg": 1.1264578705558592,
        "within_1deg": 0.9990234375, "within_2deg": 1.0, "within_4deg": 1.0,
        "mean_score": 0.32425588369369507},
    "ambiguity": {"has_rival": 0.99609375, "median_gap": 0.09188304841518402,
        "median_angle_deg": 5.797980290656368, "ambiguous": 0.0},
    "multi": {
        "phase_wrong": 0,
        "432": {"median_deg": 0.06776943573600629, "max_deg": 0.6929841411398863,
            "within_1deg": 1.0, "within_2deg": 1.0, "within_4deg": 1.0},
        "622": {"median_deg": 0.09402958468455046, "max_deg": 0.6265292036499522,
            "within_1deg": 1.0, "within_2deg": 1.0, "within_4deg": 1.0},
    },
}


# strain: HR-EBSD at bench.py's `bench_hrebsd_throughput` configuration (a
# 128x128 detector, the 21 default ROIs of 64x64, kappa 20, chunk 128) on
# synthetic patterns from tests/test_hrebsd.py's direction-function oracle:
# 512 truth patterns (strains up to 2e-3, rotations up to 3 degrees, f32),
# a 64x64 scan of 4,096 uint8 patterns (the truth set tiled) for timing, 64
# held against the port's CPU path, 256 POSTed to /strain.
STRAIN_SIZE, STRAIN_ROI, STRAIN_UPSAMPLE, STRAIN_CHUNK = 128, 64, 20, 128
STRAIN_TRUTH, STRAIN_SCAN_SIDE, STRAIN_HOLD, STRAIN_SERVE = 512, 64, 64, 256
STRAIN_SEED, STRAIN_MAX, STRAIN_ROT_MAX_DEG = 50, 2e-3, 3.0
STRAIN_CONFIGS = {  # hrebsd_map's remap passes and stiffness (crystal frame = detector frame)
    "remap0": dict(remap_iterations=0, stiffness=None),
    "remap1": dict(remap_iterations=1, stiffness=None),
    "remap0_ni": dict(remap_iterations=0, stiffness="ni"),
    "remap1_ni": dict(remap_iterations=1, stiffness="ni"),
}
# Card against the port's CPU path on STRAIN_HOLD truth patterns
# (tests/test_torch_hrebsd.py's tolerances), stage by stage: the first pass
# and the closure end to end, and the remap pass on the same deformation
# (the CPU's first-pass A). The JAX suite's two anchors against the truth
# (tests/test_hrebsd.py:180 and :353, 256x256, kappa 50).
STRAIN_A_ATOL, STRAIN_SHIFT_ATOL, STRAIN_ANCHOR_ATOL = 1e-6, 1e-3, 1e-4
# The remap pass end to end starts from each device's own first-pass A,
# which differ by ~4e-7 (cuFFT against pocketFFT). On the CPU alone a 4e-7
# change of A moves the remap pass's shifts by up to 1.3e-3 px (a fine-grid
# argmax tie: the parabolic peak jumps) and its A by up to 3.1e-6, so the
# end-to-end hold is this bound (30x under the configuration's median
# error), with the acceptance decisions equal where their margin exceeds
# STRAIN_ACCEPT_MARGIN_PX.
STRAIN_REMAP_A_ATOL, STRAIN_REMAP_SHIFT_ATOL, STRAIN_ACCEPT_MARGIN_PX = 1e-4, 5e-3, 1e-3
# Against the JAX package's readings on the same inputs: the median error at
# most STRAIN_MEDIAN_SLACK above, the largest at most STRAIN_MAX_SLACK above,
# each share at most STRAIN_SHARE_SLACK below, the mean quality and median
# residual within STRAIN_QUALITY_ATOL and STRAIN_RESIDUAL_ATOL px.
STRAIN_MEDIAN_SLACK, STRAIN_MAX_SLACK, STRAIN_SHARE_SLACK = 1e-5, 1e-4, 0.01
STRAIN_QUALITY_ATOL, STRAIN_RESIDUAL_ATOL = 1e-4, 1e-3
# The JAX package's readings on this phase's truth patterns, on the CPU
# (examples/hrebsd_jax_reference.py). No pattern lands within 1e-4 at this
# configuration: the 64x64 ROIs' rings reach only 30 px from the pattern
# center, where the projective a31/a32 terms move features by ~0.02 px, under
# the kappa-20 grid's 0.05 px; those two components carry most of the error
# (the port's CPU path on 128 of these patterns, one remap pass: median
# 2.2e-3 and 1.7e-3 against 2.4e-4 to 6.2e-4 in-plane).
JAX_STRAIN = {
    "remap0": {"median_err": 0.004156158473969296, "max_err": 0.026091787329571396,
        "within_1e4": 0.0, "within_5e4": 0.0,
        "mean_quality": 0.7401827876650108, "median_residual_px": 0.06322850659489632},
    "remap1": {"median_err": 0.0028495291795351337, "max_err": 0.008708042310502725,
        "within_1e4": 0.0, "within_5e4": 0.01171875,
        "mean_quality": 0.8701650694267646, "median_residual_px": 0.015380018390715122},
    "remap0_ni": {"median_err": 0.004156158473969296, "max_err": 0.026091787329571396,
        "within_1e4": 0.0, "within_5e4": 0.0,
        "mean_quality": 0.7401827876650108, "median_residual_px": 0.06322850659489632},
    "remap1_ni": {"median_err": 0.0028495289273362105, "max_err": 0.008708041627202944,
        "within_1e4": 0.0, "within_5e4": 0.01171875,
        "mean_quality": 0.8701650694267646, "median_residual_px": 0.015380018390715122},
}


# master: the dynamical master at `cli.index master`'s defaults (201x201,
# 64 beams, max_hkl 5, min_d 0.4, 20 kV, depth 50 nm, kappa 0.1, Debye-Waller
# 0.35): fcc Ni on the real path, zincblende GaAs on the 2N embedding; the
# Monte-Carlo weighting at 200,000 electrons, tilt 70 degrees, 400 steps,
# seed 0. 1,024 seeded generic directions are held card against the port's
# CPU path and against the JAX package's readings; MASTER_SHOWN of them per
# direction, the rest by their spread.
MASTER_SIZE, MASTER_BEAMS, MASTER_CHUNK = 201, 64, 2048
MASTER_DIRS, MASTER_SEED, MASTER_SHOWN = 1024, 60, 64
MASTER_TRACED = 64  # directions of the traced chunk
MASTER_CASES = {  # `master` flags: --structure, --element, --lattice
    "fcc": ("fcc", "ni", 3.52),
    "zincblende": ("zincblende", "ga,as", 5.65),
}
MASTER_DEBYE_WALLER = 0.35  # the CLI's default
# The measured-depth quadrature on fcc: a 40-bin histogram of the
# exponential profile over 0-400 nm.
MASTER_QUAD_BINS, MASTER_QUAD_DEPTH_NM = 40, 400.0
MC_ELECTRONS, MC_TILT_DEG, MC_DEPTH_BINS = 200_000, 70.0, 40
MC_ENERGY_BINS = 8  # the CLI's default, which the direct simulation keeps
# The `master --mc` run keeps MC_ENERGY_BINS_RUN exit-energy bins, not the
# default 8: each kept bin is one more full 201x201 Bloch solve (about 18 s
# on the card, `eigh` looping over matrices of more than 32 rows), which
# would take the whole script past six minutes.
MC_ENERGY_BINS_RUN = 2
# Card against the port's CPU path and against the JAX package's readings at
# generic directions, relative: cuSOLVER and LAPACK return eigenvectors that
# differ by f32 roundoff over the eigengaps (the port's CPU path against the
# JAX package on the CPU: at most 1.6e-5 at 27 beams).
MASTER_RTOL = 1e-3
# The whole fcc master, card against the port's CPU path: along zone axes
# and mirror lines the Bloch states are degenerate and the intensity depends
# on the basis each solver returns, so the median and the 99th percentile of
# the relative error are held, and the count above MASTER_RTOL reported.
MASTER_MEDIAN_RTOL, MASTER_P99_RTOL = 1e-4, 1e-2
# The Monte-Carlo statistics against the JAX package's at the same settings
# (other draws): the yield and each energy bin's weight within
# MC_SIGMAS standard errors of the difference of two binomial estimates, the
# depth percentiles within MC_DEPTH_RTOL (the JAX package's own spread over
# its two seeds in JAX_MASTER: at most 1.5%, the 10th percentile).
MC_SIGMAS, MC_DEPTH_RTOL = 4.0, 0.06
# The Monte-Carlo-weighted master from the phase's simulation (all 8 bins),
# card against the port's CPU path, at this edge (largest difference of the
# normalized images within MASTER_RTOL).
MC_HOLD_SIZE = 33
MASTER_QUERY = 4096  # the chain's query: patterns rendered from the fcc master


def master_structure(sim, name: str):
    """The structure ``cli.index master`` builds for case ``name`` of
    `MASTER_CASES`, from ``sim`` (the port's ``sim`` package, or the JAX
    package's in examples/dynamical_jax_reference.py)."""
    structure, element, lattice = MASTER_CASES[name]
    if structure == "zincblende":
        cation, anion = element.split(",")
        return sim.zincblende_structure(cation, anion, a=lattice,
                                        debye_waller=MASTER_DEBYE_WALLER)
    return sim.cubic_structure(structure, element, a=lattice, debye_waller=MASTER_DEBYE_WALLER)


def master_directions(n: int = MASTER_DIRS, seed: int = MASTER_SEED) -> np.ndarray:
    """``(n, 3)`` seeded generic unit directions of the north hemisphere."""
    d = np.random.default_rng(seed).normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:, 2] = np.abs(d[:, 2])
    return d


def master_quad_histogram() -> tuple[np.ndarray, np.ndarray]:
    """The quadrature case's depth centers (nm) and weights."""
    zc = (np.arange(MASTER_QUAD_BINS) + 0.5) * (MASTER_QUAD_DEPTH_NM / MASTER_QUAD_BINS)
    return zc, np.exp(-zc / 50.0)


def master_readings(values: np.ndarray) -> dict:
    """What `JAX_MASTER` keeps of 1,024 intensities: their spread and the
    first `MASTER_SHOWN`."""
    v = np.asarray(values, np.float64)
    return {"mean": float(v.mean()), "median": float(np.median(v)),
            "p01": float(np.percentile(v, 1)), "p99": float(np.percentile(v, 99)),
            "shown": [float(x) for x in v[:MASTER_SHOWN]]}


def mc_readings(mc) -> dict:
    """What `JAX_MASTER` keeps of a `MonteCarloBSE`: the yield, the count of
    backscattered electrons, the energy weights and the depth percentiles."""
    p10, p50, p90 = np.percentile(mc.max_depth_nm, [10, 50, 90])
    return {"bse_yield": float(mc.bse_yield), "n_bse": int(len(mc.exit_energy_kev)),
            "energy_weights": [float(w) for w in mc.energy_weights],
            "depth_p10_nm": float(p10), "depth_p50_nm": float(p50), "depth_p90_nm": float(p90)}


# The JAX package's readings on this phase's inputs, on the CPU
# (examples/dynamical_jax_reference.py; Monte Carlo at seeds 0 and 1).
JAX_MASTER = {
    "fcc": {
        "n_beams": 59, "u0": 0.07635882844995204, "mean": 0.4326032644021325,
        "median": 0.4327742010354996, "p01": 0.21233814999461173, "p99": 0.6475464063882826,
        "shown": [
            0.3741886615753174, 0.47628307342529297, 0.47974035143852234, 0.43524786829948425,
            0.4345126748085022, 0.49233290553092957, 0.5054990649223328, 0.6772767305374146,
            0.2987234890460968, 0.186101496219635, 0.43388882279396057, 0.5332418084144592,
            0.5190032124519348, 0.3222285807132721, 0.46611160039901733, 0.31651046872138977,
            0.5670694708824158, 0.5244373083114624, 0.38876694440841675, 0.43674561381340027,
            0.2812097370624542, 0.5767378211021423, 0.48033201694488525, 0.4309259057044983,
            0.33485496044158936, 0.40571320056915283, 0.3462693989276886, 0.48633843660354614,
            0.42166605591773987, 0.43697795271873474, 0.3962109684944153, 0.4077100157737732,
            0.5622326731681824, 0.44141560792922974, 0.47652876377105713, 0.38823240995407104,
            0.46181929111480713, 0.5779234766960144, 0.28930380940437317, 0.45952659845352173,
            0.6010321974754333, 0.5186882615089417, 0.39850422739982605, 0.46400919556617737,
            0.4702208638191223, 0.4932377338409424, 0.5262046456336975, 0.3871712386608124,
            0.5018037557601929, 0.2805286943912506, 0.25443193316459656, 0.5152101516723633,
            0.5887923240661621, 0.6246814131736755, 0.4068225920200348, 0.25162845849990845,
            0.5440329313278198, 0.501380980014801, 0.29310256242752075, 0.4695705771446228,
            0.6113404035568237, 0.5398003458976746, 0.4872226119041443, 0.3190244138240814],
    },
    "zincblende": {
        "n_beams": 51, "u0": 0.038606053179651045, "mean": 0.6141994917124975,
        "median": 0.6128090620040894, "p01": 0.3185083842277527, "p99": 0.9130226987600326,
        "shown": [
            0.5963388085365295, 0.7319161295890808, 0.40246519446372986, 0.5241627097129822,
            0.706078290939331, 0.3800866901874542, 0.4045335352420807, 1.1644235849380493,
            0.455678790807724, 0.5911069512367249, 0.8542177677154541, 0.7044594287872314,
            0.48467329144477844, 0.5966430902481079, 0.7955141663551331, 0.5549918413162231,
            0.6768273711204529, 0.6398546099662781, 0.6700869202613831, 0.6066979169845581,
            0.8142176866531372, 0.7204343676567078, 0.6333930492401123, 0.3687081038951874,
            0.7154538035392761, 0.6154752969741821, 0.6671916842460632, 0.44486910104751587,
            0.6844344735145569, 0.6082969903945923, 0.5606794953346252, 0.8027459383010864,
            0.7417032718658447, 0.7302408814430237, 0.7337235808372498, 0.6365844011306763,
            0.5781933665275574, 0.8069823980331421, 0.7439938187599182, 0.6922388672828674,
            0.33996835350990295, 0.8198351860046387, 0.5943222641944885, 0.7815369963645935,
            0.5821400880813599, 0.7012639045715332, 0.6136962175369263, 0.5679304599761963,
            0.8059971332550049, 0.6154775023460388, 0.5586945414543152, 0.8308923840522766,
            0.7282823324203491, 0.4005658030509949, 0.7110006809234619, 0.6172835826873779,
            0.7378104329109192, 0.7009915709495544, 0.6606332063674927, 0.7635732293128967,
            0.6225683093070984, 0.3474736511707306, 0.6606666445732117, 0.49975574016571045],
    },
    "fcc_quad": {
        "n_beams": 59, "u0": 0.07635882844995204, "mean": 0.42939041553472634,
        "median": 0.43129318952560425, "p01": 0.20984234482049943, "p99": 0.6369503289461135,
        "shown": [
            0.3731001913547516, 0.47416678071022034, 0.4775804877281189, 0.43373435735702515,
            0.43298569321632385, 0.48994457721710205, 0.5028544068336487, 0.6464649438858032,
            0.29642120003700256, 0.1855034977197647, 0.4323909282684326, 0.5296003222465515,
            0.5106677412986755, 0.32149991393089294, 0.4641728103160858, 0.3158050775527954,
            0.5627171993255615, 0.5213133096694946, 0.387726753950119, 0.43511462211608887,
            0.27855637669563293, 0.5718136429786682, 0.47816193103790283, 0.4294452667236328,
            0.3340395390987396, 0.4044567346572876, 0.3444976806640625, 0.4792436957359314,
            0.4203079342842102, 0.4354459047317505, 0.3951125741004944, 0.4064641296863556,
            0.5567660927772522, 0.43980783224105835, 0.47441962361335754, 0.3871428668498993,
            0.4599345624446869, 0.5731915235519409, 0.28853821754455566, 0.4553855061531067,
            0.5946422815322876, 0.5157472491264343, 0.3973213732242584, 0.46208953857421875,
            0.4681597352027893, 0.49080556631088257, 0.5230585336685181, 0.3859916627407074,
            0.49921995401382446, 0.2781328558921814, 0.2531610429286957, 0.5123493671417236,
            0.5814797282218933, 0.6152525544166565, 0.4013982117176056, 0.24958987534046173,
            0.5402905344963074, 0.4988073706626892, 0.2923486828804016, 0.46757805347442627,
            0.6043103933334351, 0.5362047553062439, 0.4843272566795349, 0.31491225957870483],
    },
    "mc_seed0": {
        "bse_yield": 0.59772, "n_bse": 119544,
        "energy_weights": [
            0.0, 0.0019908987485779293, 0.02173258381851034, 0.04063775680920832,
            0.06606772401793481, 0.10951616141337081, 0.2087432242521582, 0.5513116509402396],
        "depth_p10_nm": 5.1277721405029295, "depth_p50_nm": 36.167348861694336,
        "depth_p90_nm": 181.68867492675773,
    },
    "mc_seed1": {
        "bse_yield": 0.596405, "n_bse": 119281,
        "energy_weights": [
            0.0, 0.0019449870473922921, 0.02221644687754127, 0.04037524836310896,
            0.06581098414667885, 0.10963187766702157, 0.20849925805450994, 0.5515211978437471],
        "depth_p10_nm": 5.054355621337891, "depth_p50_nm": 36.17298889160156,
        "depth_p90_nm": 182.76637268066406,
    },
}


# analyze: the orientation-map analysis plane. A seeded 1024x1024 Voronoi
# map of 4,096 grains, each pixel turned by 0.3-0.5 degrees (RMS, drawn per
# grain); a share of adjacent grain pairs planted as Σ3 twins and a share of
# grains at the Cube and at the Goss component. Every boundary is drawn at
# least ANALYZE_MIN_RANDOM_DEG as the maps reduce it (over sample-side
# images, as the JAX package does), and every random one that far by its
# crystal-side disorientation and ANALYZE_SIGMA3_CLEAR_DEG from Σ3 (beyond
# its 8.66-degree Brandon limit, noise included), so labels are decided by
# the plants, not by an edge at a limit. The `analyze` flags are
# the chain's; the parent map is 512x512, 16 KS parent squares of 12
# children each (distinct variants); the card is held to its CPU path and to
# the JAX package's readings (examples/analyze_jax_reference.py) on the
# top-left 128x128 crop.
ANALYZE_SIDE, ANALYZE_GRAINS, ANALYZE_SEED = 1024, 4096, 70
ANALYZE_NOISE_DEG = (0.3, 0.5)
ANALYZE_TWIN_SHARE = 0.2  # of the grains, in planted Σ3 pairs
ANALYZE_COMPONENT_SHARE = 0.05  # of the grains at Cube, and as many at Goss
ANALYZE_MIN_RANDOM_DEG, ANALYZE_SIGMA3_CLEAR_DEG = 8.0, 10.5
ANALYZE_CROP = 128
ANALYZE_FLAGS = ["--grain-stats", "--csl", "--schmid", "0", "0", "1", "--taylor", "--youngs",
                 "ni", "--gnd", "0.25", "--components", "all", "--texture-index", "--clean", "4"]
ANALYZE_PARENT_SIDE, ANALYZE_PARENTS, ANALYZE_CHILDREN = 512, 16, 12
ANALYZE_PARENT_SEED, ANALYZE_PARENT_NOISE_DEG = 71, 0.1
ANALYZE_PARENT_HOLD_DEG = 0.5  # tests/crystal/test_reconstruction.py's bound
ANALYZE_PARENT_STRAY_SHARE = 0.05  # child grains that may join a neighbouring parent
# Card against CPU and JAX: an angle within 0.05 degrees of a threshold,
# Brandon limit or component radius may fall on either side (one f32 ulp of
# a dot near 1 moves an angle by up to 0.04 degrees).
ANALYZE_NEAR_DEG = 0.05
ANALYZE_RTOL = 1e-4
JAX_ANALYZE = {  # examples/analyze_jax_reference.py on the CPU (JAX 0.9.0)
    "input_sha": "5a628ee9a09275ac",
    "readings": {
        "n_grains": 67,
        "cleaned_px": 2,
        "grains_sha": "b266c8029933b9ab",
        "boundaries_sha": "4aeb9d346c8ee971",
        "sizes_sha": "08eeac1b1b2ad2d0",
        "mean_kam_deg": 0.5226346254348755,
        "mean_gos_deg": 0.3692922592163086,
        "mean_orientation_first":
            [[154.57041931152344, 67.52385711669922, 114.4515151977539], [-143.5961456298828,
            161.94813537597656, 62.918678283691406], [-167.30667114257812, 121.58329772949219,
            -56.13736343383789], [-0.011110961437225342, 44.994781494140625, 0.001624495955184102],
            [-102.40628814697266, 32.559532165527344, 11.677436828613281], [-85.30545043945312,
            130.53656005859375, 86.69692993164062], [161.25271606445312, 70.31146240234375,
            152.34617614746094], [-82.38780212402344, 69.72297668457031, 16.742822647094727]],
        "csl_counts":
            {-2: 30521, -1: 1838, 0: 57, 1: 23, 3: 29, 4: 52, 5: 14, 6: 27, 7: 84, 8: 2, 9: 16, 10:
            12, 13: 17, 14: 11, 16: 24, 18: 10, 20: 31},
        "component_counts": {-1: 11791, 0: 279, 1: 249, 2: 994, 3: 895, 5: 1099, 6: 271, 7: 806},
        "mean_schmid": 0.4440588093784754,
        "mean_taylor": 3.180317943729106,
        "mean_youngs_gpa": 222.71746201219108,
        "mean_gnd_per_m2": 52773837688035.25,
        "gnd_valid": 14246,
        "texture_index": 1.4994,
    },
    "seconds": {"map": 8.4, "analyze": 39.1},
}


def _grain_pairs(owner: np.ndarray) -> np.ndarray:
    """Unique adjacent (smaller, larger) grain-id pairs of an id map."""
    pairs = np.concatenate([np.stack([owner[:, :-1].ravel(), owner[:, 1:].ravel()], 1),
                            np.stack([owner[:-1].ravel(), owner[1:].ravel()], 1)])
    pairs = np.sort(pairs[pairs[:, 0] != pairs[:, 1]], axis=1)
    return np.unique(pairs, axis=0)


def _pair_deviation_deg(qa: np.ndarray, qb: np.ndarray, orbit: np.ndarray) -> np.ndarray:
    """Deviation (degrees, f64) of each misorientation qa⁻¹ ⊗ qb from a CSL
    orbit; the identity's orbit gives the disorientation."""
    from latice_tpu_torch.crystal.csl import _qmul_np

    d = _qmul_np(qa * np.asarray([1.0, -1.0, -1.0, -1.0]), qb)
    return 2 * np.degrees(np.arccos(np.clip(np.abs(d @ orbit.T).max(axis=1), 0.0, 1.0)))


def _sample_side_deg(qa: np.ndarray, qb: np.ndarray) -> np.ndarray:
    """``min_s angle(qa, s ⊗ qb)`` in degrees (f64), the cubic reduction
    that `crystal.misorientation_maps` (and so grains and KAM) applies, as
    the JAX package's does: it takes the sample-side images of ``qb``, so
    two grains far apart by their crystal-side disorientation can still
    read a few degrees there."""
    from latice_tpu_torch.crystal import symmetry_quats
    from latice_tpu_torch.crystal.csl import _qmul_np

    imgs = _qmul_np(symmetry_quats("432").double().numpy()[None], qb[:, None, :])
    dots = np.abs((qa[:, None, :] * imgs).sum(-1)).max(axis=1)
    return 2 * np.degrees(np.arccos(np.clip(dots, 0.0, 1.0)))


def _euler_map(q: np.ndarray, owner: np.ndarray, noise) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    import warnings

    rot = Rotation.from_quat(np.roll(q[owner.ravel()], -1, axis=-1))  # scipy: scalar last
    if noise is not None:
        rot = rot * noise
    with warnings.catch_warnings():  # the noise-free Cube grains are gimbal-locked
        warnings.simplefilter("ignore", UserWarning)
        return rot.as_euler("zxz", degrees=True).reshape(*owner.shape, 3)


def analyze_truth(side: int = ANALYZE_SIDE, n_grains: int = ANALYZE_GRAINS,
                  seed: int = ANALYZE_SEED) -> dict:
    """The phase's seeded map, as zxz Euler degrees ``(side, side, 3)``:
    ``euler`` (planted, with noise), ``clean`` (planted, no noise),
    ``no_twins`` (every twin partner at its own random draw) and
    ``no_components`` (every component grain at its own random draw), the
    last two with the same noise; and ``owner`` (grain id per pixel),
    ``twins`` (planted pairs), ``cube`` and ``goss`` (grain ids)."""
    from scipy.spatial import cKDTree
    from scipy.spatial.transform import Rotation

    from latice_tpu_torch.crystal import TEXTURE_COMPONENTS, csl_orbit, csl_rotation
    from latice_tpu_torch.crystal.csl import _qmul_np

    rng = np.random.default_rng(seed)
    seeds = rng.uniform(0, side, (n_grains, 2))
    yy, xx = np.mgrid[0:side, 0:side]
    owner = cKDTree(seeds).query(np.stack([yy.ravel(), xx.ravel()], 1))[1].reshape(side, side)
    pairs = _grain_pairs(owner)
    order = rng.permutation(n_grains)
    n_comp = int(ANALYZE_COMPONENT_SHARE * n_grains)
    cube, goss = order[:n_comp], order[n_comp:2 * n_comp]
    used = np.zeros(n_grains, bool)
    used[order[:2 * n_comp]] = True
    twins = []
    for a, b in pairs[rng.permutation(len(pairs))]:
        if len(twins) >= ANALYZE_TWIN_SHARE * n_grains / 2:
            break
        if not (used[a] or used[b]):
            twins.append((a, b))
            used[a] = used[b] = True
    twins = np.asarray(twins)
    comp = np.zeros(n_grains, np.int64)  # 1 cube, 2 goss
    comp[cube], comp[goss] = 1, 2
    partner = np.full(n_grains, -1)  # the other member of a grain's twin pair
    partner[twins[:, 0]], partner[twins[:, 1]] = twins[:, 1], twins[:, 0]

    def draw(n):  # Haar-uniform unit quaternions, scalar-first
        q = rng.normal(size=(n, 4))
        return q / np.linalg.norm(q, axis=1, keepdims=True)

    own = draw(n_grains)  # each grain's random draw: the maps without plants
    comp_q = {c: np.roll(Rotation.from_euler("zxz", TEXTURE_COMPONENTS[n], degrees=True)
                         .as_quat(), 1) for c, n in ((1, "cube"), (2, "goss"))}
    s3 = csl_rotation("3")
    orbit1, orbit3 = csl_orbit(np.asarray([1.0, 0.0, 0.0, 0.0])), csl_orbit(s3)

    def planted(q_own, twins_on=True, comps_on=True):
        q = q_own.copy()
        if comps_on:
            for c, cq in comp_q.items():
                q[comp == c] = cq
        if twins_on:
            q[twins[:, 1]] = _qmul_np(q[twins[:, 0]], s3)
        return q

    i, j = pairs[:, 0], pairs[:, 1]
    twin_pair = partner[i] == j
    same_comp = (comp[i] > 0) & (comp[i] == comp[j])
    for _ in range(50):
        # Every boundary clear of the grain threshold as the maps reduce it,
        # and every random one clear of 0 and Σ3 as the CSL table does.
        q = planted(own)
        bad = ~same_comp & (_sample_side_deg(q[i], q[j]) < ANALYZE_MIN_RANDOM_DEG)
        for q, skip in ((q, twin_pair | same_comp), (planted(own, twins_on=False), same_comp)):
            d1 = _pair_deviation_deg(q[i], q[j], orbit1)
            d3 = _pair_deviation_deg(q[i], q[j], orbit3)
            bad |= ~skip & ((d1 < ANALYZE_MIN_RANDOM_DEG) | (d3 < ANALYZE_SIGMA3_CLEAR_DEG))
        if not bad.any():
            break
        # Redraw one grain of each bad pair: an unplanted one, else both
        # draws of a twin pair (the planted partner follows the first).
        for a, b in pairs[bad]:
            free = [g for g in (a, b) if comp[g] == 0 and partner[g] < 0]
            twin = [g for g in (a, b) if partner[g] >= 0]
            if not (free or twin):
                raise AssertionError(f"analyze_truth: components {a} and {b} touch too close")
            for g in free[:1] or (twin[0], partner[twin[0]]):
                own[g] = draw(1)[0]
    else:
        raise AssertionError("analyze_truth: random boundaries never cleared")
    sigma = rng.uniform(*ANALYZE_NOISE_DEG, n_grains)[owner.ravel()]
    noise = Rotation.from_rotvec(rng.normal(size=(side * side, 3))
                                 * np.radians(sigma / np.sqrt(3.0))[:, None])
    return dict(euler=_euler_map(planted(own), owner, noise),
                clean=_euler_map(planted(own), owner, None),
                no_twins=_euler_map(planted(own, twins_on=False), owner, noise),
                no_components=_euler_map(planted(own, comps_on=False), owner, noise),
                owner=owner, twins=twins, cube=cube, goss=goss)


def analyze_parent_truth(side: int = ANALYZE_PARENT_SIDE, n_parents: int = ANALYZE_PARENTS,
                         n_children: int = ANALYZE_CHILDREN,
                         seed: int = ANALYZE_PARENT_SEED) -> dict:
    """A forward-simulated martensite map, as
    tests/crystal/test_reconstruction.py builds one: the map is a square
    grid of ``n_parents`` parent squares, each split into a Voronoi of
    ``n_children`` children of distinct KS variants, ``g_c = s_c ⊗ T ⊗ s_p
    ⊗ g_p`` (s_p picks the variant, a random s_c the representative), each
    pixel turned by ANALYZE_PARENT_NOISE_DEG (RMS). Parents (and children's
    representatives) are redrawn until every child boundary is at least
    ANALYZE_MIN_RANDOM_DEG as the maps reduce it, and every cross-parent one
    as the crystal-side disorientation too. Returns ``euler`` ``(side, side, 3)``,
    ``parent`` (parent id per pixel) and ``parent_q`` ``(n_parents, 4)``."""
    from scipy.spatial import cKDTree
    from scipy.spatial.transform import Rotation

    from latice_tpu_torch.crystal import csl_orbit, or_rotation, symmetry_quats
    from latice_tpu_torch.crystal.csl import _qmul_np

    rng = np.random.default_rng(seed)
    per_side = int(round(np.sqrt(n_parents)))
    cell = side // per_side
    yy, xx = np.mgrid[0:side, 0:side]
    parent = (yy // cell) * per_side + xx // cell
    child = np.empty((side, side), np.int64)
    for p in range(n_parents):
        sel = parent == p
        corner = np.asarray([p // per_side, p % per_side]) * cell
        seeds = corner + rng.uniform(0, cell, (n_children, 2))
        child[sel] = p * n_children + cKDTree(seeds).query(np.stack([yy[sel], xx[sel]], 1))[1]
    child_parent = np.repeat(np.arange(n_parents), n_children)
    sym = symmetry_quats("432").double().numpy()
    t = or_rotation("ks")
    variant = np.concatenate([rng.permutation(24)[:n_children] for _ in range(n_parents)])
    s_c = sym[rng.integers(0, 24, n_parents * n_children)]
    pairs = _grain_pairs(child)
    cross = child_parent[pairs[:, 0]] != child_parent[pairs[:, 1]]
    orbit1 = csl_orbit(np.asarray([1.0, 0.0, 0.0, 0.0]))
    parent_q = rng.normal(size=(n_parents, 4))
    parent_q /= np.linalg.norm(parent_q, axis=1, keepdims=True)
    for _ in range(50):
        q = _qmul_np(s_c, _qmul_np(t, _qmul_np(sym[variant], parent_q[child_parent])))
        qa, qb = q[pairs[:, 0]], q[pairs[:, 1]]
        near = _sample_side_deg(qa, qb) < ANALYZE_MIN_RANDOM_DEG
        bad = near | (cross & (_pair_deviation_deg(qa, qb, orbit1) < ANALYZE_MIN_RANDOM_DEG))
        if not bad.any():
            break
        # A cross-parent pair redraws a parent, a pair inside one parent the
        # representative s_c of one child (the maps' reduction depends on it).
        for p in np.unique(child_parent[pairs[bad & cross, 0]]):
            q_new = rng.normal(size=4)
            parent_q[p] = q_new / np.linalg.norm(q_new)
        for a in pairs[bad & ~cross, 0]:
            s_c[a] = sym[rng.integers(0, 24)]
    else:
        raise AssertionError("analyze_parent_truth: cross-parent boundaries never cleared")
    noise = Rotation.from_rotvec(rng.normal(scale=np.radians(ANALYZE_PARENT_NOISE_DEG)
                                            / np.sqrt(3.0), size=(side * side, 3)))
    return dict(euler=_euler_map(q, child, noise), parent=parent, parent_q=parent_q)


def _sha(arr: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


def analyze_readings(summary: dict, prefix: str) -> dict:
    """What the card and the JAX package compare on the crop: counts and
    label digests, histograms of the CSL and component codes, the first
    grains' mean orientations, and the means of each field."""
    def load(tag):
        return np.load(f"{prefix}_{tag}.npy")

    with np.load(f"{prefix}_grain_stats.npz") as f:
        stats = {k: f[k] for k in f.files}
    csl = np.concatenate([load("csl_east").ravel(), load("csl_south").ravel()])
    gnd = load("gnd")
    return dict(
        n_grains=summary["n_grains"], cleaned_px=summary["cleaned_px"],
        grains_sha=_sha(load("grains").astype(np.int32)),
        boundaries_sha=_sha(load("boundaries")),
        sizes_sha=_sha(stats["sizes_px"].astype(np.int64)),
        mean_kam_deg=float(load("kam").mean()), mean_gos_deg=float(stats["gos_deg"].mean()),
        mean_orientation_first=stats["mean_orientation"][:8].astype(float).tolist(),
        csl_counts={int(k): int(v) for k, v in zip(*np.unique(csl, return_counts=True))},
        component_counts={int(k): int(v) for k, v in
                          zip(*np.unique(load("components"), return_counts=True))},
        mean_schmid=float(load("schmid").astype(np.float64).mean()),
        mean_taylor=float(load("taylor").mean()),
        mean_youngs_gpa=float(load("youngs").mean()),
        mean_gnd_per_m2=float(np.nanmean(gnd)), gnd_valid=int(np.isfinite(gnd).sum()),
        texture_index=summary["texture_index"],
    )


def _direction_waves(seed: int, n_waves: int = 60):
    """``(k (n, 3), phase (n,), amp (n,))`` of tests/test_hrebsd.py's
    `_band_function`: a broadband sum of 3-D cosine waves of the unit
    scattering direction, ``sum(amp * cos(u @ k.T + phase))``."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(n_waves, 3))
    k /= np.linalg.norm(k, axis=1, keepdims=True)
    mag = rng.uniform(100.0, 500.0, size=(n_waves, 1))
    k *= mag
    phase = rng.uniform(0, 2 * np.pi, n_waves)
    return k, phase, mag[:, 0] ** -0.5


def _direction_function(seed: int):
    """`_direction_waves` as a function of ``(..., 3)`` unit directions."""
    k, phase, amp = _direction_waves(seed)
    return lambda u: (amp * np.cos(u @ k.T + phase)).sum(axis=-1)


def _render_deformed(f, size: int, a: np.ndarray | None = None) -> np.ndarray:
    """tests/test_hrebsd.py's `_render` at the default PC (0.5, 0.5, 0.7):
    the pattern under deformation gradient ``I + a``, exactly (no image
    interpolation), float32."""
    x = (np.arange(size) + 0.5) / size - 0.5
    r = np.stack([np.broadcast_to(x[None, :], (size, size)),
                  np.broadcast_to(-x[:, None], (size, size)), np.full((size, size), 0.7)], axis=-1)
    if a is not None:
        r = r @ np.linalg.inv(np.eye(3) + a).T
    return f(r / np.linalg.norm(r, axis=-1, keepdims=True)).astype(np.float32)


def _rotation_a(theta_deg: float, axis, eps: np.ndarray) -> np.ndarray:
    """``R(I + eps) - I`` in the solve's ``a33 = 0`` gauge."""
    from scipy.spatial.transform import Rotation

    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    a = Rotation.from_rotvec(np.radians(theta_deg) * axis).as_matrix() @ (np.eye(3) + eps)
    a -= np.eye(3)
    return a - a[2, 2] * np.eye(3)


def strain_truth(n: int = STRAIN_TRUTH, seed: int = STRAIN_SEED, device: str = "cuda"):
    """``(reference (H, W), patterns (n, H, W) float32, a_true (n, 3, 3))``
    at ``STRAIN_SIZE``: symmetric strains with components up to
    `STRAIN_MAX` under rotations up to `STRAIN_ROT_MAX_DEG` about random
    axes, seeded. `_render_deformed`'s oracle in float64 torch on
    ``device``, 16 patterns at a time."""
    rng = np.random.default_rng(seed)
    k, phase, amp = _direction_waves(seed)
    a_true = []
    for _ in range(n):
        e = rng.uniform(-STRAIN_MAX, STRAIN_MAX, (3, 3))
        e = 0.5 * (e + e.T)
        e[2, 2] = 0.0
        a_true.append(_rotation_a(rng.uniform(0.0, STRAIN_ROT_MAX_DEG), rng.normal(size=3), e))
    a_true = np.stack(a_true)
    t = lambda v: torch.as_tensor(v, dtype=torch.float64, device=device)  # noqa: E731
    x = (np.arange(STRAIN_SIZE) + 0.5) / STRAIN_SIZE - 0.5
    r = t(np.stack([np.broadcast_to(x[None, :], (STRAIN_SIZE,) * 2),
                    np.broadcast_to(-x[:, None], (STRAIN_SIZE,) * 2),
                    np.full((STRAIN_SIZE,) * 2, 0.7)], axis=-1).reshape(-1, 3))
    kt, pt, at = t(k.T), t(phase), t(amp)
    inv = t(np.linalg.inv(np.eye(3) + np.concatenate([np.zeros((1, 3, 3)), a_true])))
    out = []
    for start in range(0, n + 1, 16):
        rr = r @ inv[start:start + 16].transpose(1, 2)
        u = rr / rr.norm(dim=-1, keepdim=True)
        out.append(((torch.cos(u @ kt + pt) * at).sum(dim=-1)).float().cpu())
    img = torch.cat(out).reshape(n + 1, STRAIN_SIZE, STRAIN_SIZE).numpy()
    return img[0], img[1:], a_true


def strain_readings(a: np.ndarray, a_true: np.ndarray, quality: np.ndarray,
                    residual_px: np.ndarray) -> dict:
    """The accuracy readings the strain phase holds to the JAX package's: the
    median and largest ``max|a - a_true|`` per pattern (``a`` taken back to
    the ``a33 = 0`` gauge, which a stiffness's closure leaves), the shares
    under 1e-4 and 5e-4, the mean quality and the median residual (px)."""
    gauge = a - a[:, 2, 2, None, None] * np.eye(3)
    err = np.abs(gauge - a_true).max(axis=(1, 2))
    return dict(median_err=float(np.median(err)), max_err=float(err.max()),
                within_1e4=float((err < 1e-4).mean()), within_5e4=float((err < 5e-4).mean()),
                mean_quality=float(np.mean(quality)),
                median_residual_px=float(np.median(residual_px)))


def _bands_truth(n: int, seed: int) -> np.ndarray:
    """``(n, 4)`` seeded random unit quaternions, float32."""
    q = np.random.default_rng(seed).normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def sphere_readings(err_deg: np.ndarray) -> dict:
    """The accuracy readings the sphere phase holds to the JAX package's:
    median and largest disorientation to the truth, and the shares within
    1, 2 and 4 degrees."""
    err = np.asarray(err_deg, np.float64)
    return dict(median_deg=float(np.median(err)), max_deg=float(err.max()),
                **{f"within_{d}deg": float((err < d).mean()) for d in (1, 2, 4)})


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back calls.

    The stream first spins (``torch.cuda._sleep``) while the host enqueues
    every call, so the launches run back to back and the events time the
    device's work, not the host's launch rate. If the start event has
    already completed when the last call is enqueued, the spin was too
    short to cover the host, and the timing is taken again with a spin
    twice as long.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = 40_000_000  # cycles: about 20 ms at 2 GHz
    for _ in range(6):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(iters):
            fn()
        covered = not start.query()
        end.record()
        end.synchronize()
        if covered:
            return start.elapsed_time(end) / iters
        spin *= 2
    raise AssertionError("the stream's spin never outlasted the host's enqueueing")


def host_bound_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds per call of ``fn`` called back to back from an idle
    stream: the device's time or the host's launch time, whichever is
    longer (how the main path sees a small kernel)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_busy_ms(fn, iters: int = 5) -> float:
    """Device milliseconds per call of ``fn``: the sum of its kernels' and
    copies' device times in a trace of ``iters`` calls, whatever the host
    does between them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(t for _, t, _ in _device_kernels(prof)) / iters


def waits_for_device(fn) -> bool:
    """Whether a call of ``fn`` holds the host until the stream's earlier
    work is done (then the host cannot enqueue the next batch meanwhile)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)  # cycles: about 0.2 s at 2 GHz
    t0 = time.perf_counter()
    fn()
    held = time.perf_counter() - t0
    torch.cuda.synchronize()
    return held > 0.1


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float = PEAK_FP32_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / peak_ops
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


def check_norm_serve_bf16(gen: torch.Generator) -> dict:
    """K2f in bf16 at the serving shapes (B=256, the 10 encoder launches of
    one batch), the precision the served model runs at (16-mixed)."""
    from latice_tpu_torch.ops import instance_norm_leaky_relu, instance_norm_leaky_relu_plain

    F = torch.nn.functional
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0)
    max_err = 0.0
    for c, h, w in ENCODER_SHAPES:
        x = (torch.randn((BATCH, c, h, w), device="cuda", generator=gen) * 3 + 1).bfloat16()
        y, mean, rstd = instance_norm_leaky_relu(x)
        py, pmean, prstd = instance_norm_leaky_relu_plain(x)
        torch.cuda.synchronize()
        try:
            err = max(_within(y, py, K2_BF16_ATOL, K2_BF16_RTOL), _within(mean, pmean, K2_ATOL),
                      _within(rstd, prstd, K2_ATOL))
        except AssertionError as e:
            raise AssertionError(f"K2f bf16 at {(BATCH, c, h, w)}: {e}") from None
        max_err = max(max_err, err)
        times = dict(
            ms=cuda_ms(lambda: instance_norm_leaky_relu(x)),
            plain_ms=cuda_ms(lambda: instance_norm_leaky_relu_plain(x)),
            library_ms=cuda_ms(lambda: F.leaky_relu(F.instance_norm(x), 0.02)),
        )
        for key in ("ms", "plain_ms", "library_ms"):
            totals[key] += 2 * times[key]  # two blocks per encoder stage
        totals["bytes"] += 2 * (4.0 * x.numel() + 8.0 * BATCH * c)  # bf16 x in, y out; stats
        totals["ops"] += 2 * 7.0 * x.numel()
        del x, y, py
    b_ms, b_by = bound_ms(totals["bytes"], totals["ops"])
    return dict(ms=totals["ms"], plain_ms=totals["plain_ms"], library_ms=totals["library_ms"],
                bound_ms=b_ms, bound_by=b_by, max_abs_err=max_err,
                timed_as="the 10 encoder launches of one batch of 256, bf16 (16-mixed serving)")


def check_norm_serve_nhwc(gen: torch.Generator) -> dict:
    """K2f's NHWC kernel in bf16 at both VAE cells' serving shapes (B=256,
    the encoder's norms, each run twice a batch; the first of stage 0 from
    the NCHW output of the one-channel convolution), from channels_last and
    from NCHW, against the plain twin and the NCHW kernel after one
    synchronize, timed beside the NCHW kernel on the same values and
    against the same bytes bound; then the channels_last encoder
    (`_check_nhwc_encoder`)."""
    from latice_tpu_torch.ops import instance_norm_leaky_relu, instance_norm_leaky_relu_plain
    from latice_tpu_torch.ops.fused_norm import _nhwc_plan

    out = {}
    for cell, shapes in (("ref", ENCODER_SHAPES), ("scaled", SCALED_ENCODER_SHAPES)):
        rows, totals = [], dict(ms=0.0, nchw_ms=0.0, bytes=0.0, ops=0.0)
        for c, h, w in shapes:
            x = (torch.randn((BATCH, c, h, w), device="cuda", generator=gen) * 3 + 1).bfloat16()
            xl = x.contiguous(memory_format=torch.channels_last)
            cl = torch.channels_last
            y, mean, rstd = instance_norm_leaky_relu(xl)
            fy, fmean, frstd = instance_norm_leaky_relu(x, memory_format=cl)
            ny, _, _ = instance_norm_leaky_relu(x)
            py, pmean, prstd = instance_norm_leaky_relu_plain(x)
            torch.cuda.synchronize()
            try:
                if not (y.is_contiguous(memory_format=cl) and fy.is_contiguous(memory_format=cl)):
                    raise AssertionError("y is not channels_last")
                err = max(_within(y, py, K2_BF16_ATOL, K2_BF16_RTOL),
                          _within(y, ny, K2_BF16_ATOL, K2_BF16_RTOL),
                          _within(fy, py, K2_BF16_ATOL, K2_BF16_RTOL),
                          *(_within(a, b, K2_ATOL) for a, b in
                            ((mean, pmean), (rstd, prstd), (fmean, pmean), (frstd, prstd))))
            except AssertionError as e:
                raise AssertionError(f"K2f NHWC at {(BATCH, c, h, w)}: {e}") from None
            n_bytes = 4.0 * x.numel() + 8.0 * BATCH * c  # bf16 x in, y out; stats
            n_ops = 7.0 * x.numel()
            row = dict(shape=[BATCH, c, h, w], plan=_nhwc_plan(c, h * w, 2, True)._asdict(),
                       from_nchw_plan=_nhwc_plan(c, h * w, 2, True, True)._asdict(),
                       ms=cuda_ms(lambda: instance_norm_leaky_relu(xl)),
                       from_nchw_ms=cuda_ms(lambda: instance_norm_leaky_relu(x, memory_format=cl)),
                       nchw_ms=cuda_ms(lambda: instance_norm_leaky_relu(x)),
                       bound_ms=bound_ms(n_bytes, n_ops)[0], max_abs_err=err)
            rows.append(row)
            first = not rows[:-1]  # stage 0's first norm reads the NCHW convolution
            totals["ms"] += row["ms"] + (row["from_nchw_ms"] if first else row["ms"])
            totals["nchw_ms"] += 2 * row["nchw_ms"]
            totals["bytes"] += 2 * n_bytes
            totals["ops"] += 2 * n_ops
            del x, xl, y, fy, ny, py
        b_ms, b_by = bound_ms(totals["bytes"], totals["ops"])
        emit("kernels", kernel="instance_norm_leaky_relu_nhwc", cell=cell, per_shape=rows)
        out[cell] = dict(ms=totals["ms"], nchw_ms=totals["nchw_ms"], bound_ms=b_ms, bound_by=b_by,
                         bound_share=b_ms / totals["ms"],
                         timed_as=f"the {2 * len(shapes)} encoder launches of a batch of 256")
    out["encoder"] = _check_nhwc_encoder()
    return out


def _check_nhwc_encoder() -> dict:
    """The channels_last encoder of both VAE cells' widths on 256 seeded
    patterns: ``mu`` against the same blocks in NCHW with the parameters'
    own layout (the path before it), each by its unit-latent distance from
    the f32 model, the channels_last one within twice the NCHW one's plus
    1e-4; no cuDNN layout transform in its trace; device time by kernel
    group, both paths."""
    from torch.profiler import ProfilerActivity, profile

    from latice_tpu_torch.models import VariationalAutoEncoderRawData
    from latice_tpu_torch.models.vae import ConvBlock

    def unit(mu):
        return mu / mu.norm(dim=1, keepdim=True)

    def groups(fn) -> dict:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        by = {}
        for name, t, _ in _device_kernels(prof):
            transform = "nchwToNhwc" in name or "nhwcToNchw" in name
            key = "transform" if transform else _kernel_group(name)
            by[key] = by.get(key, 0.0) + t / 5
        return by

    x = torch.rand((BATCH, 1, 128, 128), device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(4))
    out = {}
    for cell, (inplanes, latent, n_stages, hw) in (("ref", (32, 16, 5, 4)),
                                                   ("scaled", (64, 64, 6, 2))):
        model = VariationalAutoEncoderRawData(inplanes, latent, n_stages, hw)
        model = model.init_weights(torch.Generator().manual_seed(0)).cuda().eval()
        model.set_precision("16-mixed")

        def nchw():
            h = x
            for layer in model.encoder:
                if isinstance(layer, ConvBlock):
                    h = layer[1](layer[0]._conv_forward(h, layer[0].weight, None))
                else:
                    h = layer(h)
            return model.mu(h.flatten(1)).float()

        with torch.inference_mode():
            mu = model.encode(x)[0]
            with model._autocast(x):
                mu_nchw = nchw()
            torch.cuda.synchronize()
            by_nhwc = groups(lambda: model.encode(x))
            with model._autocast(x):
                by_nchw = groups(nchw)
            mu32 = model.set_precision("32").encode(x)[0]
        gap = (unit(mu) - unit(mu32)).norm(dim=1).max().item()
        gap_nchw = (unit(mu_nchw) - unit(mu32)).norm(dim=1).max().item()
        if not gap <= 2 * gap_nchw + 1e-4 or by_nhwc.get("transform"):
            raise AssertionError(f"channels_last encoder, {cell}: gap {gap} against NCHW "
                                 f"{gap_nchw}, device ms {by_nhwc}")
        out[cell] = dict(gap=gap, gap_nchw=gap_nchw, device_ms=by_nhwc, nchw_device_ms=by_nchw)
        del model
    emit("kernels", kernel="channels_last_encoder", **out)
    return out


def _within(got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float = 0.0) -> float:
    """Max abs error of ``got`` against ``want``; raises past ``atol + rtol*|want|``
    or on a non-finite value."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if not bool(torch.isfinite(got).all()) or bool((diff > atol + rtol * want.abs()).any()):
        raise AssertionError(f"max abs err {diff.max().item()} past atol {atol}, rtol {rtol}")
    return diff.max().item()


def _train_norm_inputs(gen: torch.Generator, shape, dtype):
    """x and an output gradient g at a training shape, in ``dtype``."""
    x = (torch.randn((TRAIN_BATCH, *shape), device="cuda", generator=gen) * 3 + 1).to(dtype)
    g = torch.randn((TRAIN_BATCH, *shape), device="cuda", generator=gen).to(dtype)
    return x, g


def check_norm_train(gen: torch.Generator) -> tuple[dict, dict]:
    """K2f at bf16 and K2b at f32 and bf16, at the 19 training shapes.

    Times are per train step: the sum over the 19 shapes of one launch
    each. K2b's library call is ATen's own backward of
    ``leaky_relu(instance_norm(x))``, through a graph kept from one forward.
    """
    from latice_tpu_torch.ops import (
        instance_norm_leaky_relu,
        instance_norm_leaky_relu_backward,
        instance_norm_leaky_relu_backward_plain,
        instance_norm_leaky_relu_plain,
    )

    F = torch.nn.functional
    names = ("ms", "plain_ms", "library_ms", "host_bound_ms", "bytes", "ops")
    fwd = {"bf16": dict.fromkeys(names, 0.0)}
    bwd = {"f32": dict.fromkeys(names, 0.0), "bf16": dict.fromkeys(names, 0.0)}
    err = {"fwd_bf16": 0.0, "bwd_f32": 0.0, "bwd_bf16": 0.0}
    rows = []
    for shape in TRAIN_SHAPES:
        for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            x, g = _train_norm_inputs(gen, shape, dtype)
            size = x.element_size()
            tol = (K2_ATOL, 0.0) if dtype == torch.float32 else (K2_BF16_ATOL, K2_BF16_RTOL)
            y, mean, rstd = instance_norm_leaky_relu(x)
            dx = instance_norm_leaky_relu_backward(x, mean, rstd, g)
            pdx = instance_norm_leaky_relu_backward_plain(x, mean, rstd, g)
            torch.cuda.synchronize()
            try:
                e_b = _within(dx, pdx, *tol)
            except AssertionError as e:
                raise AssertionError(f"K2b {tag} at {(TRAIN_BATCH, *shape)}: {e}") from None
            err[f"bwd_{tag}"] = max(err[f"bwd_{tag}"], e_b)
            row = dict(shape=[TRAIN_BATCH, *shape], dtype=tag, k2b_max_abs_err=e_b)

            xl = x.detach().requires_grad_()
            yl = F.leaky_relu(F.instance_norm(xl), 0.02)
            times = dict(
                ms=cuda_ms(lambda: instance_norm_leaky_relu_backward(x, mean, rstd, g)),
                plain_ms=cuda_ms(lambda: instance_norm_leaky_relu_backward_plain(x, mean, rstd, g)),
                library_ms=cuda_ms(lambda: torch.autograd.grad(yl, xl, g, retain_graph=True)),
                host_bound_ms=host_bound_ms(
                    lambda: instance_norm_leaky_relu_backward(x, mean, rstd, g)),
            )
            n = float(x.numel())
            b_bytes = 3.0 * size * n + 8.0 * TRAIN_BATCH * shape[0]  # x, g in; dx out; stats in
            b_ops = 10.0 * n  # y, slope select, two sums, dx
            for key in ("ms", "plain_ms", "library_ms", "host_bound_ms"):
                bwd[tag][key] += times[key]
            bwd[tag]["bytes"] += b_bytes
            bwd[tag]["ops"] += b_ops
            row.update(k2b=times, k2b_bound_ms=bound_ms(b_bytes, b_ops)[0])
            del yl, xl

            if dtype == torch.bfloat16:
                py, pmean, prstd = instance_norm_leaky_relu_plain(x)
                torch.cuda.synchronize()
                try:
                    e_f = max(_within(y, py, *tol), _within(mean, pmean, K2_ATOL),
                              _within(rstd, prstd, K2_ATOL))
                except AssertionError as e:
                    raise AssertionError(f"K2f bf16 at {(TRAIN_BATCH, *shape)}: {e}") from None
                err["fwd_bf16"] = max(err["fwd_bf16"], e_f)
                f_times = dict(
                    ms=cuda_ms(lambda: instance_norm_leaky_relu(x)),
                    plain_ms=cuda_ms(lambda: instance_norm_leaky_relu_plain(x)),
                    library_ms=cuda_ms(lambda: F.leaky_relu(F.instance_norm(x), 0.02)),
                    host_bound_ms=host_bound_ms(lambda: instance_norm_leaky_relu(x)),
                )
                f_bytes = 2.0 * size * n + 8.0 * TRAIN_BATCH * shape[0]
                for key in ("ms", "plain_ms", "library_ms", "host_bound_ms"):
                    fwd["bf16"][key] += f_times[key]
                fwd["bf16"]["bytes"] += f_bytes
                fwd["bf16"]["ops"] += 7.0 * n
                row.update(k2f=f_times, k2f_max_abs_err=e_f,
                           k2f_bound_ms=bound_ms(f_bytes, 7.0 * n)[0])
            rows.append(row)
            del x, g, y, dx, pdx
    emit("kernels", kernel="instance_norm_leaky_relu (train shapes)", per_shape=rows)

    def totals(t: dict, max_err: float) -> dict:
        b_ms, b_by = bound_ms(t["bytes"], t["ops"])
        return dict(ms=t["ms"], plain_ms=t["plain_ms"], library_ms=t["library_ms"],
                    bound_ms=b_ms, bound_by=b_by, max_abs_err=max_err,
                    host_bound_ms=t["host_bound_ms"])

    k2f_bf16 = dict(totals(fwd["bf16"], err["fwd_bf16"]),
                    timed_as="the 19 launches of one train step, B=64, bf16")
    k2b = dict(
        name="instance_norm_leaky_relu_backward", route="cuda",
        source="latice_tpu_torch/ops/csrc/fused_norm.cu",
        replaces="latice_tpu/ops/fused_norm.py:176",
        **totals(bwd["bf16"], err["bwd_bf16"]),
        timed_as="the 19 launches of one train step, B=64, bf16 (the 16-mixed path)",
        f32=dict(totals(bwd["f32"], err["bwd_f32"]),
                 timed_as="the 19 launches of one train step, B=64, f32"),
    )
    return k2f_bf16, k2b


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


def _k1_plan(b: int, n: int, k: int = TOP_N, d: int = LATENT) -> tuple[int, int]:
    """K1's launch plan (queries per warp, splits) on this card."""
    from latice_tpu_torch.ops import topk_fused

    return topk_fused._plan(b, n, k, d, torch.cuda.get_device_properties(0).multi_processor_count)


def _k1_split_cases(dic: torch.Tensor, gen: torch.Generator, cases: dict) -> None:
    """Duplicates across split boundaries, and every query's top-k in one
    split (the bound the splits share prunes the others), at B=64."""
    from latice_tpu_torch.ops import topk_fused

    b, n = 64, dic.shape[0]
    _, splits = _k1_plan(b, n)
    bounds = topk_fused._split_bounds(n, splits)
    # Row s-1 copied onto row s at each inner boundary s: the query is the
    # row itself, so its two copies come first, tied, lowest index first.
    inner = torch.tensor(bounds[1:-1] or [n // 2], device="cuda")
    inner = inner[torch.arange(b, device="cuda") % len(inner)]
    dup = dic.clone()
    dup[inner] = dup[inner - 1]
    cases["duplicates_across_splits"] = _topk_case(dup[inner].contiguous(), dup, TOP_N)
    want = torch.stack([inner - 1, inner], dim=1)
    if not torch.equal(cases["duplicates_across_splits"][2][:, :2], want):
        raise AssertionError("K1 duplicates across splits: copies not first in index order")
    # 8 directions, 8 queries and 20 near rows each, the rows all inside
    # the middle split.
    lo = bounds[splits // 2]
    centers = _unit_rows(8, LATENT, gen)
    q = centers.repeat_interleave(8, 0) + 0.01 * torch.randn((b, LATENT), device="cuda",
                                                             generator=gen)
    near = centers.repeat_interleave(TOP_N, 0) + 0.01 * torch.randn(
        (8 * TOP_N, LATENT), device="cuda", generator=gen)
    one = dic.clone()
    one[lo : lo + 8 * TOP_N] = near / near.norm(dim=1, keepdim=True)
    cases["topk_in_one_split"] = _topk_case(q, one, TOP_N)
    got = cases["topk_in_one_split"][2]
    if not bool(((got >= lo) & (got < bounds[splits // 2 + 1])).all()):
        raise AssertionError("K1 top-k in one split: an index outside that split")


def check_topk(gen: torch.Generator) -> dict:
    """K1 against its twin on every case, then timed at the serving shape
    (B=256, N=100,000, k=20) and at N=1,000,000 (64 MB, beyond the 50 MB
    L2, so each call reads the dictionary from HBM), with the device time
    of each pass from a trace of 5 calls."""
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
    for b in (1, 64, 257):  # the edges of the queries-per-warp choice
        cases[f"b{b}_n100k_k20"] = _topk_case(
            torch.randn((b, LATENT), device="cuda", generator=gen), dic, TOP_N
        )
    base = _unit_rows(7000, LATENT, gen)
    cases["tied_duplicates"] = _topk_case(base[:37].contiguous(), base.repeat(3, 1), 6)
    # Identical rows score bit-identically in the kernel, so its own order
    # must put each row's three copies first, lowest index first.
    copies = torch.arange(37, device="cuda")[:, None] + 7000 * torch.arange(3, device="cuda")
    if not torch.equal(cases["tied_duplicates"][2][:, :3], copies):
        raise AssertionError("K1 tied duplicates: copies not in ascending index order")
    _k1_split_cases(dic, gen, cases)
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
    big = _unit_rows(BIG_DICT_ROWS, LATENT, gen)
    cases["b256_n1m_k20"] = _topk_case(q, big, TOP_N)
    max_err = max(e for e, _, _ in cases.values())

    qn = l2_normalize(q)
    times = dict(
        ms=cuda_ms(lambda: cosine_topk_fused(q, dic, TOP_N)),
        plain_ms=cuda_ms(lambda: cosine_topk_fused_plain(q, dic, TOP_N)),
        library_ms=cuda_ms(lambda: torch.topk(qn @ dic.T, TOP_N)),
    )
    # The twin sorts all 1M scores of each row: not timed there.
    big_times = dict(
        ms=cuda_ms(lambda: cosine_topk_fused(q, big, TOP_N)),
        library_ms=cuda_ms(lambda: torch.topk(qn @ big.T, TOP_N)),
    )

    def bound(n: int) -> tuple[float, str]:
        n_bytes = 4.0 * (q.numel() + n * LATENT) + 12.0 * BATCH * TOP_N
        return bound_ms(n_bytes, (2.0 * LATENT + 1.0) * BATCH * n)  # an FMA per element, a compare

    # Device ms of each pass, from a trace of 5 calls.
    from torch.profiler import ProfilerActivity, profile

    passes = {}
    for tag, d in (("n100k", dic), ("n1m", big)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                cosine_topk_fused(q, d, TOP_N)
            torch.cuda.synchronize()
        split = {p: sum(t for n, t, _ in _device_kernels(prof) if p in n) / 5
                 for p in ("topk_partial", "topk_merge", "Memset")}
        split["merge_share"] = split["topk_merge"] / max(sum(split.values()), 1e-12)
        passes[tag] = split
    b_ms, b_by = bound(DICT_ROWS)
    big_b_ms, big_b_by = bound(BIG_DICT_ROWS)
    plan = dict(zip(("queries_per_warp", "splits"), _k1_plan(BATCH, DICT_ROWS)))
    big_plan = dict(zip(("queries_per_warp", "splits"), _k1_plan(BATCH, BIG_DICT_ROWS)))
    emit("kernels", kernel="cosine_topk_fused",
         cases={k: dict(max_abs_err=e, near_tie_rows=n) for k, (e, n, _) in cases.items()},
         shape=dict(B=BATCH, N=DICT_ROWS, D=LATENT, k=TOP_N), plan=plan,
         device_ms_by_pass=passes, **times)
    return dict(
        name="cosine_topk_fused", route="cuda", source="latice_tpu_torch/ops/csrc/topk_fused.cu",
        replaces="latice_tpu/ops/topk_fused.py:220", max_abs_err=max_err,
        bound_ms=b_ms, bound_by=b_by, **times, plan=plan, device_ms_by_pass=passes["n100k"],
        timed_as="B=256, N=100,000, D=16, k=20, dictionary warm in L2",
        n1m=dict(**big_times, plain_ms=None, bound_ms=big_b_ms, bound_by=big_b_by, plan=big_plan,
                 device_ms_by_pass=passes["n1m"],
                 timed_as="B=256, N=1,000,000, D=16, k=20; plain_ms not timed (the twin "
                          "sorts every row's 1M scores)"),
    )


def sweep_topk_plan(gen: torch.Generator) -> None:
    """K1 at both timed shapes with the planner aiming at 1, 2 or 4
    blocks per SM (2 is the default): how the split count trades the SMs'
    fill against each split's own selection."""
    from latice_tpu_torch.ops import cosine_topk_fused, topk_fused

    q = torch.randn((BATCH, LATENT), device="cuda", generator=gen)
    dicts = {n: _unit_rows(n, LATENT, gen) for n in (DICT_ROWS, BIG_DICT_ROWS)}
    rows, default = [], topk_fused._BLOCKS_PER_SM
    try:
        for per_sm in (1, 2, 4):
            topk_fused._BLOCKS_PER_SM = per_sm
            for n, d in dicts.items():
                rows.append(dict(blocks_per_sm=per_sm, N=n, plan=_k1_plan(BATCH, n),
                                 ms=cuda_ms(lambda: cosine_topk_fused(q, d, TOP_N))))
    finally:
        topk_fused._BLOCKS_PER_SM = default
    emit("k1_plan_sweep", shape=dict(B=BATCH, D=LATENT, k=TOP_N), rows=rows)


STAGE0_CASES = {  # tag: (B, C, H, W) of K3's checks; the first is the timed serving shape
    "b256_c32_128x128": (BATCH, INPLANES, 128, 128),
    "b64_c16_128x128": (64, 16, 128, 128),
    "b64_c64_128x128": (64, 64, 128, 128),
    "b1_c32_128x128": (1, INPLANES, 128, 128),
    "b257_c32_128x128": (257, INPLANES, 128, 128),
    "b3_c32_40x24": (3, INPLANES, 40, 24),
    "b3_c32_64x64": (3, INPLANES, 64, 64),
}


def _stage0_weights(c: int) -> list[torch.Tensor]:
    """(w1, b1, w2, b2) of the stage 0 of an encoder of width ``c``, from the
    serve phase's weight seed, on the card."""
    from latice_tpu_torch.models import VariationalAutoEncoderRawData

    enc = VariationalAutoEncoderRawData(c, LATENT).init_weights(
        torch.Generator().manual_seed(0)
    ).encoder
    return [t.detach().cuda() for t in (enc[0][0].weight, enc[0][0].bias,
                                         enc[1][0].weight, enc[1][0].bias)]


def check_stage0(gen: torch.Generator) -> dict:
    """K3 against its twin on every case of `STAGE0_CASES` (uint8/255
    inputs): C = 16, 32 and 64; B = 1 and 257, the persistent grid's edges;
    40x24, where tiles are partial and pool windows sit at tile edges. Each
    case is timed beside the twin and ATen's bf16 composition, with the
    device time of each launch from a trace and the planner's grid.

    Both outputs are bf16 and round f32 values that may sit on either side
    of a tie, hence K2's bf16 rule; two runs must be bitwise equal. The
    bound counts the convolutions' operations at the bf16 tensor-core peak
    against x read once and the pooled output written once;
    ``design_byte_floor_ms`` is this design's own floor: x in, the pooled
    f32 maxima written and read back, the bf16 output written.
    """
    import importlib

    from torch.profiler import ProfilerActivity, profile

    from latice_tpu_torch.ops import stage0_fused, stage0_fused_reference

    s0 = importlib.import_module("latice_tpu_torch.ops.stage0_fused")  # the module

    F = torch.nn.functional
    lib = s0._lib()
    for c in (16, 32, 64):
        if lib.latice_stage0_smem_bytes(c) != s0._smem_bytes(c):
            raise AssertionError(f"K3 shared memory at C={c}: the source's "
                                 f"{lib.latice_stage0_smem_bytes(c)}, the planner's "
                                 f"{s0._smem_bytes(c)}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    passes = ("stage0_conv1_stats", "stage0_conv2", "stage0_finish")
    cases = {}
    for tag, (b, c, h, w) in STAGE0_CASES.items():
        w1, b1, w2, b2 = _stage0_weights(c)
        x = torch.randint(0, 256, (b, 1, h, w), device="cuda", generator=gen).float() / 255.0
        got = stage0_fused(x, w1, b1, w2, b2)
        again = stage0_fused(x, w1, b1, w2, b2)
        want = stage0_fused_reference(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        try:
            err = _within(got, want, K2_BF16_ATOL, K2_BF16_RTOL)
        except AssertionError as e:
            raise AssertionError(f"K3 at {tag}: {e}") from None
        if got.shape != (b, c, h // 2, w // 2) or not torch.equal(got, again):
            raise AssertionError(f"K3 at {tag}: shape {tuple(got.shape)} or runs not bitwise equal")
        bf = [t.to(torch.bfloat16) for t in (w1, b1, w2, b2)]

        def aten():
            h1 = F.leaky_relu(F.instance_norm(F.conv2d(x.to(torch.bfloat16), bf[0], bf[1],
                                                       padding=1)), 0.02)
            h2 = F.leaky_relu(F.instance_norm(F.conv2d(h1, bf[2], bf[3], padding=1)), 0.02)
            return F.max_pool2d(h2, 2)

        times = dict(
            ms=cuda_ms(lambda: stage0_fused(x, w1, b1, w2, b2)),
            plain_ms=cuda_ms(lambda: stage0_fused_reference(x, w1, b1, w2, b2)),
            library_ms=cuda_ms(aten),
        )
        # Device ms of each of the three launches, from a trace of 5 calls.
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                stage0_fused(x, w1, b1, w2, b2)
            torch.cuda.synchronize()
        split = {p: sum(t for n, t, _ in _device_kernels(prof) if p + "<" in n or p + "(" in n) / 5
                 for p in passes}
        pixels = float(x.numel())
        n_ops = pixels * (2 * 9 * c * c + 2 * 9 * c)
        n_bytes = 4.0 * pixels + 2.0 * c * pixels / 4
        b_ms, b_by = bound_ms(n_bytes, n_ops, PEAK_BF16_PER_S)
        floor_bytes = 4.0 * pixels + (2 * 4.0 + 2.0) * c * pixels / 4
        cases[tag] = dict(
            shape=dict(B=b, C=c, H=h, W=w), max_abs_err=err,
            share_differing=(got != want).float().mean().item(),
            plan=dict(zip(("blocks", "tile_h", "tile_w"), s0._plan(b, h, w, c, sms))),
            gflop=n_ops / 1e9, bound_ms=b_ms, bound_by=b_by,
            design_byte_floor_ms=floor_bytes / PEAK_BYTES_PER_S * 1e3,
            device_ms_by_pass=split, **times,
        )
        del x, got, again, want
    main = cases[next(iter(STAGE0_CASES))]
    emit("kernels", kernel="stage0_fused", cases=cases)
    return dict(
        name="stage0_fused", route="cuda", source="latice_tpu_torch/ops/csrc/stage0_fused.cu",
        replaces="latice_tpu/ops/stage0_fused.py:214",
        max_abs_err=max(c["max_abs_err"] for c in cases.values()),
        **{k: main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                "design_byte_floor_ms", "plan", "device_ms_by_pass")},
        cases={k: {f: v[f] for f in ("shape", "max_abs_err", "plan", "ms", "plain_ms",
                                     "library_ms", "bound_ms")} for k, v in cases.items()},
        timed_as="B=256, C=32, 128x128, uint8/255 input; three launches per call",
    )


def _clustered_euler(rng: np.random.Generator) -> np.ndarray:
    """`K4_ROWS` f32 zxz degrees in clusters of `K4_CLUSTER` consecutive
    rows, each within 2.5 degrees of its cluster's centre."""
    from latice_tpu_torch.crystal import quat_mul, to_euler_zxz_deg

    axis = rng.normal(size=(K4_ROWS, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    half = np.deg2rad(rng.uniform(0.0, 2.5, size=(K4_ROWS, 1))) / 2
    small = np.concatenate([np.cos(half), np.sin(half) * axis], axis=1)
    centres = rng.normal(size=(K4_ROWS // K4_CLUSTER, 4))
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    quats = quat_mul(torch.from_numpy(small),
                     torch.from_numpy(np.repeat(centres, K4_CLUSTER, axis=0)))
    return to_euler_zxz_deg(quats).numpy().astype(np.float32)


def _k4_inputs(rng: np.random.Generator, phased: bool):
    """A `CandidateConsensus` on the card over `_clustered_euler`'s rows
    (with phases, 432 + 622: the first half of the rows cubic, the rest
    either at random), and a batch of `BATCH` best-first candidate sets of
    `TOP_N`: part of one cluster, the rest drawn anywhere, shuffled, so that
    trials both succeed and fail. Returns (consensus, scores, indices)."""
    from latice_tpu_torch.index.pipeline import CandidateConsensus

    n_clusters = K4_ROWS // K4_CLUSTER
    euler = _clustered_euler(rng)
    phases = None
    if phased:
        phases = rng.integers(0, 2, size=K4_ROWS).astype(np.int32)
        phases[: K4_ROWS // 2] = 0
    cc = CandidateConsensus(euler, torch.device("cuda"), dictionary_phases=phases,
                            phase_symmetries=["432", "622"] if phased else None,
                            orientation_threshold=K4_THRESHOLD,
                            min_required_matches=K4_MIN_MATCHES, max_iterations=K4_ITERS)
    idx = np.empty((BATCH, TOP_N), np.int64)
    for r in range(BATCH):
        c = rng.integers(n_clusters)
        members = c * K4_CLUSTER + rng.choice(
            K4_CLUSTER, size=rng.integers(TOP_N // 2, TOP_N + 1), replace=False)
        outliers = rng.choice(K4_ROWS, size=TOP_N - len(members), replace=False)
        idx[r] = rng.permutation(np.concatenate([members, outliers]))
    scores = np.sort(rng.uniform(0.2, 1.0, size=(BATCH, TOP_N)), axis=1)[:, ::-1]
    return (cc, torch.from_numpy(scores.astype(np.float32)).cuda(),
            torch.from_numpy(idx).cuda())


def _near_threshold(quats: torch.Tensor) -> np.ndarray:
    """Per row of ``(B, k, 4)`` candidate quaternions, whether a trial
    misorientation (the first `K4_ITERS` candidates against every one, in
    float64) lies within `K4_MARGIN_DEG` of `K4_THRESHOLD`."""
    from latice_tpu_torch.crystal import misorientation_angle

    q = quats.double().cpu()
    mis = np.rad2deg(misorientation_angle(q[:, :K4_ITERS, None], q[:, None]).numpy())
    return (np.abs(mis - K4_THRESHOLD) <= K4_MARGIN_DEG).any(axis=(1, 2))


def _euler_gap_deg(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    """Per row, the angle in degrees between two stacks of zxz Euler
    degrees, as rotations (float64)."""
    from latice_tpu_torch.crystal import from_euler_zxz_deg, misorientation_angle

    qa, qb = (from_euler_zxz_deg(t.double().cpu()) for t in (a, b))
    return np.rad2deg(misorientation_angle(qa, qb).numpy())


def _k4_work(b: int, k: int, n_phases: int, n_sym: int, phased: bool) -> tuple[float, float]:
    """(bytes, operations) of one K4 call on int64 indices, unweighted.
    Bytes: the scores and indices, each candidate's row as one 32-byte
    sector, the tables and the outputs. Operations, a multiply or an add
    each, a square root or an atan2 one: a misorientation is a quaternion
    product (28) and the angle (9); per query, the trials' K4_ITERS * k
    misorientations, each candidate's n_sym images and their angles to the
    reference, its 10 matrix entries and 4 start-vector terms (28), 30 power
    steps (a 4x4 product and a normalisation, 40) and two Euler
    conversions (40 each)."""
    n_bytes = b * k * (4.0 + 8.0 + 32.0 + 1.0) + 16.0 * n_phases * n_sym
    n_bytes += b * (12.0 + 12.0 + 1.0 + 8.0 + (4.0 if phased else 0.0))
    miso = 28 + 9
    per_query = K4_ITERS * k * miso + k * n_sym * (28 + miso) + k * 28 + 30 * 40 + 2 * 40
    return n_bytes, float(b * per_query)


def check_consensus() -> dict:
    """K4 against its twin at the index path's shapes (`_k4_inputs`: B=256,
    k=20, 3 trials at 3 degrees and 18 matches), with the cubic table
    alone (``vae_ref``'s dictionary) and with 432 + 622 phases
    (``vae_scaled``'s). ``success``, ``n_similar``, the chosen trial's
    per-candidate mask and ``phase`` must be equal in every row whose trial
    misorientations lie more than `K4_MARGIN_DEG` from the threshold, the
    mean orientation of each such succeeding row and the best orientation
    of each such row within `K4_ORIENT_DEG`, and two runs bitwise equal. Timed by CUDA events
    (`cuda_ms`) and host-paced (`host_bound_ms`) beside the twin, whose
    host syncs rule out `cuda_ms`: its kernels' device time from a trace,
    its kernels and copies counted. The bound is `_k4_work`'s."""
    from torch.profiler import ProfilerActivity, profile

    from latice_tpu_torch.ops import candidate_consensus_fused, candidate_consensus_fused_plain

    rng = np.random.default_rng(40)
    cases = {}
    for tag, phased in (("cubic", False), ("432_622", True)):
        cc, scores, idx = _k4_inputs(rng, phased)
        args = (scores, idx, cc.quats, cc.sym_tables, cc.threshold, cc.min_matches,
                cc.max_iterations, cc.angle_unit, cc.weight_power)
        before = candidate_consensus_fused.launches
        got = candidate_consensus_fused(*args)
        again = candidate_consensus_fused(*args)
        want = candidate_consensus_fused_plain(*args)
        torch.cuda.synchronize()
        if candidate_consensus_fused.launches != before + 2:
            raise AssertionError(f"K4 {tag}: {candidate_consensus_fused.launches - before} "
                                 "launches for two calls")
        fields = [f for f, w in want._asdict().items() if w is not None]
        if [f for f, g in got._asdict().items() if g is not None] != fields or any(
                (getattr(got, f).dtype, getattr(got, f).shape)
                != (getattr(want, f).dtype, getattr(want, f).shape) for f in fields):
            raise AssertionError(f"K4 {tag}: fields, dtypes or shapes differ from the twin's")
        if not all(torch.equal(getattr(got, f), getattr(again, f)) for f in fields):
            raise AssertionError(f"K4 {tag}: two runs are not bitwise equal")
        keep = ~_near_threshold(cc.quats[idx][..., :4])
        success = want.success.cpu().numpy()
        if not (keep.mean() > 0.9 and 0 < success.sum() < BATCH):
            raise AssertionError(f"K4 {tag}: {int(keep.sum())} rows held, "
                                 f"{int(success.sum())} succeed: the inputs test too little")
        differing = {f: int((getattr(got, f).cpu().numpy() != getattr(want, f).cpu().numpy())
                            .reshape(BATCH, -1)[keep].any(axis=1).sum())
                     for f in ("success", "n_similar", "similar_mask")
                     + (("phase",) if phased else ())}
        mean_err = float(_euler_gap_deg(got.mean_euler, want.mean_euler)[keep & success]
                         .max(initial=0.0))
        best_err = float(_euler_gap_deg(got.best, want.best)[keep].max(initial=0.0))
        if any(differing.values()) or not max(mean_err, best_err) < K4_ORIENT_DEG:
            raise AssertionError(f"K4 {tag} against its twin: {differing} rows differ, "
                                 f"orientations {mean_err} / {best_err} degrees apart")

        def k4():
            return candidate_consensus_fused(*args)

        def plain():
            return candidate_consensus_fused_plain(*args)

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            plain()
            torch.cuda.synchronize()
        eager = _device_kernels(prof)
        copies = sum(c for n, _, c in eager if _kernel_group(n) == "copy")
        n_phases, n_sym, _ = cc.sym_tables.shape
        b_ms, b_by = bound_ms(*_k4_work(BATCH, TOP_N, n_phases, n_sym, phased))
        cases[tag] = dict(
            shape=dict(B=BATCH, k=TOP_N, iters=K4_ITERS, rows=K4_ROWS, phases=int(n_phases),
                       operators=int(n_sym)),
            rows_held=int(keep.sum()), rows_succeeding=int(success.sum()),
            rows_differing=differing, mean_max_err_deg=mean_err, best_max_err_deg=best_err,
            ms=cuda_ms(k4), host_ms=host_bound_ms(k4), plain_ms=device_busy_ms(plain),
            plain_host_ms=host_bound_ms(plain), plain_kernels=sum(c for _, _, c in eager) - copies,
            plain_copies=copies, bound_ms=b_ms, bound_by=b_by,
        )
        del cc, scores, idx, got, again, want
    main = cases["cubic"]
    emit("kernels", kernel="candidate_consensus_fused", cases=cases)
    return dict(
        name="candidate_consensus_fused", route="cuda",
        source="latice_tpu_torch/ops/csrc/consensus_fused.cu",
        replaces="none: the JAX package's consensus is jnp that XLA fuses under jit",
        **{k: main[k] for k in ("ms", "host_ms", "plain_ms", "plain_host_ms", "plain_kernels",
                                "plain_copies", "bound_ms", "bound_by")},
        cases={k: {f: v[f] for f in ("shape", "rows_held", "mean_max_err_deg",
                                     "best_max_err_deg", "ms", "plain_ms", "bound_ms")}
               for k, v in cases.items()},
        timed_as="B=256, k=20, 3 trials, a 100,000-row dictionary, the cubic table; "
                 "plain_ms the twin's kernels alone, plain_host_ms with its host syncs",
    )


def _unit_rows_bf16(gen: torch.Generator, n: int, d: int, chunk: int = 16_384) -> torch.Tensor:
    out = torch.empty((n, d), dtype=torch.bfloat16, device="cuda")
    for i in range(0, n, chunk):
        x = torch.randn((min(chunk, n - i), d), generator=gen, device="cuda")
        out[i : i + len(x)] = (x / torch.linalg.vector_norm(x, dim=1, keepdim=True)).bfloat16()
    return out


def _k5_twin_blocked(q: torch.Tensor, table: torch.Tensor, k: int, rows: int = 32_768):
    """K5's plain twin over row blocks of the table (whole, its f32 copy
    would be 21.8 GB), merged in row order."""
    from latice_tpu_torch.index.knn import topk_lower_index_first
    from latice_tpu_torch.ops import cosine_topk_wide_plain

    vals, idx = [], []
    for i in range(0, len(table), rows):
        v, j = cosine_topk_wide_plain(q, table[i : i + rows], k)
        vals.append(v)
        idx.append(j + i)
    v, pos = topk_lower_index_first(torch.cat(vals, 1), k)
    return v, torch.cat(idx, 1).gather(1, pos)


def _k5_faults(got, want, q: torch.Tensor, table: torch.Tensor, tol: float) -> dict:
    """How K5's best-first ``got`` (B, k) departs from the twin's best
    ``k + 1`` (``want``) beyond ``tol``: rows repeated within a query, the
    widest gap between a returned score and its row's own f32 score, rows
    the twin scores more than ``tol`` above the returned k-th and K5 left
    out, and rows standing elsewhere than the twin's where the twin's score
    there ties no neighbour's within ``tol``."""
    gv, gi = got
    wv, wi = want
    k = gi.shape[1]
    ordered = gi.sort(1).values
    own = torch.stack([(q[b].float() * table[gi[b]].float()).sum(1) for b in range(len(gi))])
    present = (wi[:, :k, None] == gi[:, None, :]).any(2)
    close = (wv[:, 1:] - wv[:, :-1]).abs() <= tol
    near = torch.zeros_like(wv, dtype=torch.bool)
    near[:, 1:] |= close
    near[:, :-1] |= close
    moved = gi != wi[:, :k]
    return dict(repeated=int((ordered[:, 1:] == ordered[:, :-1]).sum()),
                own_score_gap=float((own - gv).abs().max()),
                missing=int(((wv[:, :k] > gv[:, -1:] + tol) & ~present).sum()),
                moved_without_tie=int((moved & ~near[:, :k]).sum()),
                rows_equal=int((~moved).all(1).sum()), near_tie_rows=int(near[:, :k].any(1).sum()))


def check_topk_wide(gen: torch.Generator) -> dict:
    """K5 against its twin at the DI cell's shapes (B=256 and B=1, N =
    `K5_ROWS`, D = `K5_DIM`, k = 20) over random unit bf16 rows with one
    exact tie, by `_k5_faults` at `K5_TIE`: no row repeated, missing or
    moved where the twin's scores do not tie, every score within `K5_TIE`
    of its row's own and of the twin's, the tie's lower row first. Timed
    by CUDA events (`cuda_ms`) beside its bound (bytes or bf16
    operations), the twin (the exact engine's path before K5: an f32 copy
    of the table and a (B, N) score matrix, then the keyed top-k) and
    ``torch.topk(q.float() @ d.float().T, 20)``; the peak memory each adds
    to the table's."""
    from latice_tpu_torch.ops import cosine_topk_wide, cosine_topk_wide_plain

    table = _unit_rows_bf16(gen, K5_ROWS, K5_DIM)
    table[1] = table[0]
    cases, queries = {}, {}
    for b in (BATCH, 1):
        q = _unit_rows_bf16(gen, b, K5_DIM)
        q[0] = table[0]
        before = cosine_topk_wide.launches
        got_v, got_i = cosine_topk_wide(q, table, TOP_N)
        torch.cuda.synchronize()
        if cosine_topk_wide.launches != before + 1:
            raise AssertionError("K5: one call made other than one launch")
        want_v, want_i = _k5_twin_blocked(q, table, TOP_N + 1)
        faults = _k5_faults((got_v, got_i), (want_v, want_i), q, table, K5_TIE)
        gap = float((got_v - want_v[:, :TOP_N]).abs().max())
        if (faults["repeated"] or faults["missing"] or faults["moved_without_tie"]
                or faults["own_score_gap"] > K5_TIE or gap > K5_TIE
                or got_i[0, :2].tolist() != [0, 1]):
            raise AssertionError(f"K5 B={b} against its twin: {faults}, scores {gap} apart, "
                                 f"row 0 {got_i[0, :2]}")
        n_bytes = 2.0 * (K5_ROWS + b) * K5_DIM + 12.0 * b * TOP_N
        b_ms, b_by = bound_ms(n_bytes, 2.0 * b * K5_ROWS * K5_DIM, PEAK_BF16_PER_S)
        ms = cuda_ms(lambda: cosine_topk_wide(q, table, TOP_N), iters=10, warmup=2)
        cases[f"B{b}"] = dict(shape=dict(B=b, N=K5_ROWS, D=K5_DIM, k=TOP_N), **faults,
                              max_score_gap=gap, ms=ms, bound_ms=b_ms, bound_by=b_by,
                              share_of_bound=b_ms / ms)
        queries[b] = q
    q = queries[BATCH]

    def extra_peak(fn) -> int:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return int(torch.cuda.max_memory_allocated() - base)

    main = cases[f"B{BATCH}"]
    main.update(
        plain_ms=cuda_ms(lambda: cosine_topk_wide_plain(q, table, TOP_N), iters=3, warmup=1),
        library_ms=cuda_ms(lambda: torch.topk(q.float() @ table.float().T, TOP_N), iters=3,
                           warmup=1),
        extra_peak_bytes=extra_peak(lambda: cosine_topk_wide(q, table, TOP_N)),
        plain_extra_peak_bytes=extra_peak(lambda: cosine_topk_wide_plain(q, table, TOP_N)),
    )
    emit("kernels", kernel="cosine_topk_wide", cases=cases)
    del table, queries, q
    torch.cuda.empty_cache()
    return dict(
        name="cosine_topk_wide", route="cuda",
        source="latice_tpu_torch/ops/csrc/topk_wide.cu",
        replaces="none: the JAX package's exact engine is jnp.dot(preferred_element_type=f32) "
                 "and lax.top_k, which XLA runs on the MXU",
        **{k: main[k] for k in ("ms", "bound_ms", "bound_by", "share_of_bound", "plain_ms",
                                "library_ms", "extra_peak_bytes", "plain_extra_peak_bytes")},
        cases=cases,
        timed_as="B=256, N=333,227, D=16,384, k=20 (the DI cell's table, 10.9 GB of bf16); "
                 "plain_ms the twin, library_ms torch.topk over the f32 product",
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


def _cli_service(ckpt: str, npz: str, device: str, batch: int, engine: str = "fused"):
    """The service ``python -m latice_tpu_torch.cli.serve`` builds (its model
    at 16-mixed, ``/reload`` confined to the checkpoint's directory), on
    ``device``, fused engine unless given."""
    from latice_tpu_torch.cli.serve import build_service, parse_args

    return build_service(parse_args([
        "--db", npz, "--checkpoint", ckpt, "--inplanes", str(INPLANES),
        "--latent-dim", str(LATENT), "--batch-size", str(batch), "--top-n", str(TOP_N),
        "--engine", engine, "--device", device,
    ]))


def phase_serve(workdir: str) -> tuple[dict, dict, object, str, str]:
    from latice_tpu_torch.ops import (
        candidate_consensus_fused,
        cosine_topk_fused,
        instance_norm_leaky_relu,
    )
    from latice_tpu_torch.serve import make_server

    ckpt, npz, rng = _serve_files(workdir)

    service = _cli_service(ckpt, npz, "cuda", BATCH)
    if service.pipeline.model.compute_dtype != torch.bfloat16:
        raise AssertionError("the serve CLI's model is not 16-mixed")
    warm_s = service.warmup()
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    counters = (instance_norm_leaky_relu, cosine_topk_fused, candidate_consensus_fused)
    try:
        health = _request(f"{url}/healthz")
        if health["count"] != DICT_ROWS or health["platform"] != "gpu":
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
            want = [10 * batches] + [batches if route == "index" else 0] * 2
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
        batches["candidate_consensus_fused"] = batches["cosine_topk_fused"]
        per_batch = {name: launches[name] / batches[name] for name in launches}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    emit("serve", warmup_s=warm_s, requests=log, index_patterns=index_n,
         index_patterns_per_s=index_n / index_s, launches=launches,
         launches_per_batch=per_batch)
    return launches, per_batch, service, ckpt, npz


def _conv_flag_probe(model: torch.nn.Module, seen: set) -> None:
    """Hooks on every convolution of ``model`` that add the cuDNN
    (allow_tf32, enabled) flags to ``seen`` as each one runs forward and
    backward."""

    def record(*_):
        seen.add((torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled))

    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            m.register_forward_pre_hook(record)
            m.register_full_backward_pre_hook(record)


def _tf32_at_defaults() -> None:
    """Nothing in this script sets TF32: the port's f32 models must keep it
    off by themselves (``device.no_tf32``)."""
    if not (torch.backends.cudnn.allow_tf32 and torch.backends.cudnn.enabled):
        raise AssertionError("cuDNN's TF32 flag is not at PyTorch's default (True)")


def _index_rows_agree(res_gpu, res_cpu, lat_cpu, vectors, orients,
                      margin) -> tuple[int, int]:
    """Rows whose top-n indices and success agree, where a row may differ
    only if two of its first n+1 CPU scores lie within ``margin`` (a
    scalar or one per row) of each other, and its success only if a trial
    misorientation of its candidates lies within `K4_MARGIN_DEG` of the
    threshold (`_near_threshold`). Returns (equal rows, near-tie rows)."""
    from latice_tpu_torch.crystal import from_euler_zxz_deg
    from latice_tpu_torch.index import l2_normalize

    scores = l2_normalize(torch.from_numpy(lat_cpu)) @ torch.from_numpy(vectors).T
    head = torch.sort(scores, dim=1, descending=True).values[:, : TOP_N + 1]
    gaps = (head[:, :-1] - head[:, 1:]).numpy()
    near = (gaps <= np.reshape(margin, (-1, 1))).any(axis=1)
    cand = from_euler_zxz_deg(torch.from_numpy(np.asarray(orients, np.float64)[res_cpu.indices]))
    same = (res_gpu.indices == res_cpu.indices).all(axis=1) & (
        (res_gpu.success == res_cpu.success) | _near_threshold(cand)
    )
    if not np.all(same | near):
        raise AssertionError(f"{int((~same & ~near).sum())} rows differ without a near tie")
    return int(same.sum()), int(near.sum())


def _hold_16mixed(name: str, service, cpu16, cpu32, x: np.ndarray, vectors) -> dict:
    """The card's 16-mixed service against the CPU's on ``x``: each row's
    latent no farther from the f32 CPU latent than `GRAD_RATIO` times the
    CPU 16-mixed path's distance plus `GRAD_FLOOR` (median and largest), and
    indices and success equal except near ties (`phase_parity`'s rule)."""
    from latice_tpu_torch.index import l2_normalize

    lat_gpu = np.asarray(service.encode(x)["latents"], np.float32)
    lat_cpu = np.asarray(cpu16.encode(x)["latents"], np.float32)
    lat_f32 = cpu32.encode(x)
    f32_norm = np.linalg.norm(lat_f32, axis=1)
    d_gpu = np.linalg.norm(lat_gpu - lat_f32, axis=1) / f32_norm
    d_cpu = np.linalg.norm(lat_cpu - lat_f32, axis=1) / f32_norm
    share = {stat: float(fn(d_gpu) / (GRAD_RATIO * fn(d_cpu) + GRAD_FLOOR))
             for stat, fn in (("median", np.median), ("max", np.max))}
    elem = np.abs(lat_gpu - lat_cpu).max(axis=1) / (3e-2 * np.linalg.norm(lat_cpu, axis=1))
    unit_dist = (l2_normalize(torch.from_numpy(lat_gpu))
                 - l2_normalize(torch.from_numpy(lat_cpu))).norm(dim=1).numpy()
    equal, near = _index_rows_agree(service.pipeline(x), cpu16.pipeline(x), lat_cpu,
                                    vectors, cpu16._db._orientations, 2.0 * unit_dist + 1e-6)
    out = dict(
        card_rel_dist_from_f32=dict(median=float(np.median(d_gpu)), max=float(d_gpu.max())),
        cpu_rel_dist_from_f32=dict(median=float(np.median(d_cpu)), max=float(d_cpu.max())),
        share_of_limit=share, elem_over_3e2_of_norm_max=float(elem.max()),
        rows_past_3e2_of_norm=int((elem > 1).sum()), equal_rows=equal, near_tie_rows=near)
    if not max(share.values()) <= 1.0:
        raise AssertionError(f"16-mixed latents on {name}: {out}")
    return out


def phase_parity(service, ckpt: str, npz: str) -> None:
    """The card's serve-CLI service (16-mixed) against the same service
    built on the CPU (plain twins, 16-mixed), on uint8 noise and on
    synthetic band patterns; then the f32 model on the card against the
    f32 CPU pipeline, with TF32 left at PyTorch's defaults.

    At full width a 16-mixed latent lies ~5% (relative L2, median) from the
    f32 model's on the card and on the CPU alike, so the two 16-mixed paths
    are held to each other by that distance: the card's median and largest
    per-row distance from the f32 CPU latents at most `GRAD_RATIO` times
    the CPU 16-mixed path's, plus `GRAD_FLOOR`. Each row's largest element
    difference over 3e-2 of its norm (the index CLI test's bf16 tolerance
    at a tiny width) is reported beside it. A row's indices may differ where
    two of its scores lie within twice the distance of its unit latents.
    """
    from latice_tpu_torch.index import IndexPipeline
    from latice_tpu_torch.models import load_checkpoint

    _tf32_at_defaults()
    noise = np.random.default_rng(1).integers(0, 256, (64, 128, 128), dtype=np.uint8)
    bands = np.round(_synthetic_patterns(64, seed=1) * 255.0).astype(np.uint8)
    cpu16 = _cli_service(ckpt, npz, "cpu", 64)
    vectors, orients = cpu16._db._vectors, cpu16._db._orientations
    knobs = dict(top_n=TOP_N, engine="fused")
    cpu32 = IndexPipeline(load_checkpoint(ckpt, INPLANES, LATENT, device="cpu"), vectors, orients,
                          batch_size=64, device="cpu", **knobs)

    mixed16 = {
        name: _hold_16mixed(name, service, cpu16, cpu32, x, vectors)
        for name, x in (("noise", noise), ("bands", bands))
    }

    # f32: latents within 1e-4; scores closer than that may swap places.
    gpu32_model = load_checkpoint(ckpt, INPLANES, LATENT, device="cuda")
    seen = set()
    _conv_flag_probe(gpu32_model, seen)
    gpu32 = IndexPipeline(gpu32_model, vectors, orients, batch_size=BATCH, device="cuda", **knobs)
    lat_gpu, lat_cpu = gpu32.encode(noise), cpu32.encode(noise)
    lat_err = float(np.abs(lat_gpu - lat_cpu).max())
    if not lat_err <= 1e-4:
        raise AssertionError(f"f32 latents differ by {lat_err}")
    if seen != {(False, True)}:
        raise AssertionError(f"f32 convolutions ran with cuDNN (allow_tf32, enabled) in {seen}")
    _tf32_at_defaults()
    equal32, near32 = _index_rows_agree(gpu32(noise), cpu32(noise), lat_cpu, vectors, orients,
                                        1e-4)
    emit("parity", rows=len(noise), mixed16=mixed16,
         f32=dict(latent_max_abs_err=lat_err, equal_rows=equal32, near_tie_rows=near32,
                  conv_flags_seen=sorted(seen), tf32_default=True))


def _kernel_group(name: str) -> str:
    if "instance_norm_lrelu_bwd" in name:
        return "instance_norm_leaky_relu_backward"
    if "instance_norm_lrelu" in name:
        return "instance_norm_leaky_relu"
    if "topk_partial" in name or "topk_merge" in name:
        return "cosine_topk_fused"
    if "consensus_fused" in name:
        return "candidate_consensus_fused"
    if any(s in name for s in ("xmma", "fft", "conv", "pointwise_mult_and_sum", "gemm",
                               "cutlass", "fprop", "dgrad", "wgrad", "nchwToNhwc",
                               "nhwcToNchw", "winograd")):
        return "convolution"
    if "max_pool" in name:
        return "max_pool"
    if "upsample" in name:
        return "upsample"
    if "multi_tensor_apply" in name or "foreach" in name:
        return "optimizer"
    if "Memcpy" in name or "Memset" in name:
        return "copy"
    return "other"


def _device_kernels(prof) -> list[tuple[str, float, int]]:
    """(name, device ms, calls) of every device activity in a trace."""
    kernels = []
    for evt in prof.key_averages():
        dev_ms = getattr(evt, "self_device_time_total", 0) / 1e3
        # Device work, not a host op, nor a labelled range (record_function
        # and Optimizer.step ranges also appear on the device timeline).
        if (dev_ms > 0 and evt.self_cpu_time_total == 0
                and not evt.key.startswith(("train:", "Optimizer."))):
            kernels.append((evt.key, dev_ms, evt.count))
    return kernels


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
    kernels = _device_kernels(prof)
    groups: dict[str, float] = {}
    for name, dev_ms, _ in kernels:
        groups[_kernel_group(name)] = groups.get(_kernel_group(name), 0.0) + dev_ms
    busy = sum(groups.values())
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    emit("profile", patterns=len(x), wall_ms=wall_ms, device_busy_ms=busy,
         idle_share=1.0 - busy / wall_ms, device_ms=groups,
         top=[dict(kernel=n[:80], ms=t, calls=c) for n, t, c in top])


def _post_json(url: str, payload: dict) -> tuple[int, dict]:
    """POST a JSON body; (HTTP status, reply), error replies included."""
    try:
        return 200, _request(url, json.dumps(payload).encode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def phase_reload(service, workdir: str, npz: str) -> dict:
    """``POST /reload`` on the serve phase's service (its loader builds the
    model at 16-mixed, confined to the checkpoint's directory): a second
    seeded checkpoint under the root swaps in and ``model_version`` goes up;
    ``/index`` and ``/encode`` then answer as the same service built on the
    CPU from that checkpoint (`_hold_16mixed`, the parity phase's rule); a
    path outside the root answers 400 and swaps nothing."""
    from latice_tpu_torch.index import IndexPipeline
    from latice_tpu_torch.models import VariationalAutoEncoderRawData, load_checkpoint
    from latice_tpu_torch.ops import (
        candidate_consensus_fused,
        cosine_topk_fused,
        instance_norm_leaky_relu,
    )
    from latice_tpu_torch.serve import make_server

    ckpt2 = f"{workdir}/vae_reload.pt"
    model = VariationalAutoEncoderRawData(INPLANES, LATENT)
    torch.save(model.init_weights(torch.Generator().manual_seed(1)).state_dict(), ckpt2)
    x = np.round(_synthetic_patterns(RELOAD_PATTERNS, seed=14) * 255.0).astype(np.uint8)
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    counters = (instance_norm_leaky_relu, cosine_topk_fused, candidate_consensus_fused)
    try:
        before = np.asarray(_request(f"{url}/encode", _npy(x))["latents"], np.float32)
        code, refused = _post_json(f"{url}/reload", {"checkpoint": "../vae.pt"})
        if code != 400 or service.model_version != 0:
            raise AssertionError(f"/reload outside the root: HTTP {code}, {refused}")
        code, out = _post_json(f"{url}/reload", {"checkpoint": Path(ckpt2).name})
        health = _request(f"{url}/healthz")
        if code != 200 or out["model_version"] != 1 or health["model_version"] != 1:
            raise AssertionError(f"/reload: HTTP {code}, {out}, healthz {health}")
        for fn in counters:
            fn.launches = 0
        index = _request(f"{url}/index", _npy(x))
        after = np.asarray(_request(f"{url}/encode", _npy(x))["latents"], np.float32)
        launches = {fn.__name__: fn.launches for fn in counters}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    want = {"instance_norm_leaky_relu": 20, "cosine_topk_fused": 1,  # one /index, one /encode
            "candidate_consensus_fused": 1}
    if launches != want:
        raise AssertionError(f"reload launches {launches}, want {want}")
    if not np.abs(after - before).max() > 1e-2:
        raise AssertionError("/reload did not change the latents")
    res = service.pipeline(x)
    if not (np.array_equal(np.asarray(index["orientations"]), res.best_orientation)
            and index["success"] == res.success.tolist()):
        raise AssertionError("/index after /reload differs from the swapped pipeline")
    cpu16 = _cli_service(ckpt2, npz, "cpu", RELOAD_PATTERNS)
    vectors, orients = cpu16._db._vectors, cpu16._db._orientations
    cpu32 = IndexPipeline(load_checkpoint(ckpt2, INPLANES, LATENT, device="cpu"), vectors,
                          orients, top_n=TOP_N, engine="fused", batch_size=RELOAD_PATTERNS,
                          device="cpu")
    held = _hold_16mixed("reload", service, cpu16, cpu32, x, vectors)
    emit("reload", patterns=RELOAD_PATTERNS, model_version=health["model_version"],
         seconds=out["seconds"], refused_outside_root=dict(status=400, reply=refused),
         latent_change_max=float(np.abs(after - before).max()), launches=launches, **held)
    return launches


def _recall_at(got, want, k: int = 10) -> float:
    """Mean share of each row's first ``k`` ``want`` indices among its
    first ``k`` ``got`` ones."""
    got, want = np.asarray(got)[:, :k], np.asarray(want)[:, :k]
    return float(np.mean([len(set(g) & set(w)) / k for g, w in zip(got.tolist(), want.tolist())]))


def _identity(p: torch.Tensor) -> torch.Tensor:
    return p


def _db_engines() -> dict:
    """The latent database's engines on the card, each held to the same
    engine's database on the CPU.

    `K4_ROWS` latents in clusters of `K4_CLUSTER` rows (a centre plus 0.3
    Gaussian noise) with `_clustered_euler`'s orientations, and
    `ENGINE_PATTERNS` queries (rows plus 0.05 noise), indexed by
    ``find_best_orientations_batch`` and ``find_best_orientations_dense`` in
    chunks of `BATCH` at `K4_THRESHOLD`, `K4_MIN_MATCHES` and `K4_ITERS`.
    Held: one K4 launch a chunk on the card whatever the engine, one K1 a
    chunk for "fused" alone; the candidates equal the CPU's but in rows
    with a near tie among the exact top `TOP_N` + 1 (`NEAR_TIE`); in rows
    with the same candidates and no trial misorientation within
    `K4_MARGIN_DEG` of the threshold, success, ``n_similar`` and the similar
    indices equal, means within `K4_ORIENT_DEG`, and a failed row's best
    orientation its top-1's stored angles, as on the CPU."""
    from latice_tpu_torch.crystal import from_euler_zxz_deg
    from latice_tpu_torch.index import (
        LatentVectorDatabaseConfig,
        TorchLatentVectorDatabase,
        cosine_topk,
    )
    from latice_tpu_torch.ops import candidate_consensus_fused, cosine_topk_fused

    rng = np.random.default_rng(41)
    euler = _clustered_euler(rng)
    vecs = np.repeat(rng.normal(size=(K4_ROWS // K4_CLUSTER, LATENT)), K4_CLUSTER, axis=0)
    vecs = (vecs + 0.3 * rng.normal(size=vecs.shape)).astype(np.float32)
    src = rng.choice(K4_ROWS, ENGINE_PATTERNS, replace=False)
    queries = vecs[src] + 0.05 * rng.normal(size=(ENGINE_PATTERNS, LATENT)).astype(np.float32)
    kw = dict(top_n=TOP_N, orientation_threshold=K4_THRESHOLD,
              min_required_matches=K4_MIN_MATCHES, max_iterations=K4_ITERS, batch_size=BATCH)
    chunks = -(-ENGINE_PATTERNS // BATCH)
    head = cosine_topk(torch.from_numpy(queries), torch.from_numpy(vecs), TOP_N + 1)[0].numpy()
    near_tie = _near_tie_rows(head, TOP_N + 1)
    out = {}
    for engine in DB_ENGINES:
        runs = {}
        for device in ("cuda", "cpu"):
            db = TorchLatentVectorDatabase(LatentVectorDatabaseConfig(
                npz_path="/nonexistent/db.npz", dimension=LATENT, engine=engine), device=device)
            db.add_vectors(vecs, euler)
            db.find_best_orientations_batch(queries[:1], **kw)  # builds the stages and kernels
            torch.cuda.synchronize()
            k4, k1 = candidate_consensus_fused.launches, cosine_topk_fused.launches
            t0 = time.perf_counter()
            rows = db.find_best_orientations_batch(queries, **kw)
            dense = db.find_best_orientations_dense(queries, **kw)
            runs[device] = dict(rows=rows, dense=dense, wall_s=time.perf_counter() - t0,
                                launches=dict(k4=candidate_consensus_fused.launches - k4,
                                              k1=cosine_topk_fused.launches - k1))
        card, cpu = runs["cuda"], runs["cpu"]
        want = dict(k4=2 * chunks, k1=2 * chunks if engine == "fused" else 0)
        if card["launches"] != want or cpu["launches"] != dict(k4=0, k1=0):
            raise AssertionError(f"database {engine}: launches {card['launches']} on the card, "
                                 f"{cpu['launches']} on the CPU; want {want} and none")
        got, ref = card["dense"], cpu["dense"]
        same = (got["indices"] == ref["indices"]).all(axis=1)
        if (~same & ~near_tie).any():
            raise AssertionError(f"database {engine}: {int((~same & ~near_tie).sum())} rows "
                                 "differ from the CPU's candidates without a near tie")
        cand = from_euler_zxz_deg(torch.from_numpy(euler[ref["indices"]].astype(np.float64)))
        held = same & ~_near_threshold(cand)
        success = ref["success"]
        if not (held.mean() > 0.9 and 0 < success.sum() < ENGINE_PATTERNS):
            raise AssertionError(f"database {engine}: {int(held.sum())} rows held, "
                                 f"{int(success.sum())} succeed: the inputs test too little")
        masks = [np.array_equal(a.similar_indices, b.similar_indices)
                 for a, b in zip(card["rows"], cpu["rows"])]
        differing = {f: int((got[f] != ref[f])[held].sum()) for f in ("success", "n_similar")}
        differing["similar_indices"] = int((~np.array(masks))[held].sum())
        fail = held & ~success
        differing["failed_best"] = int(
            (got["best_orientation"] != ref["best_orientation"])[fail].any(axis=1).sum())
        ok = held & success
        mean_err = float(_euler_gap_deg(torch.from_numpy(got["mean_orientation"][ok]),
                                        torch.from_numpy(ref["mean_orientation"][ok]))
                         .max(initial=0.0))
        if any(differing.values()) or not mean_err < K4_ORIENT_DEG:
            raise AssertionError(f"database {engine} against the CPU: {differing} rows differ, "
                                 f"means {mean_err} degrees apart")
        out[engine] = dict(
            k4_per_chunk=card["launches"]["k4"] / (2 * chunks),
            k1_per_chunk=card["launches"]["k1"] / (2 * chunks),
            rows_same_candidates=int(same.sum()), rows_held=int(held.sum()),
            rows_succeeding=int(success.sum()), mean_max_err_deg=mean_err,
            wall_s=dict(card=card["wall_s"], cpu=cpu["wall_s"]),
        )
    return out


def phase_engines(ckpt: str, npz: str) -> dict:
    """The search engines: the serve CLI's 16-mixed model on 512 uint8
    patterns over its 100,000-row dictionary through ``IndexPipeline`` for
    each engine (launches per batch, recall@10 and top-1 against exact);
    then each engine's search alone at B=256 near-duplicate queries over
    100,000 and 1,000,000 rows, timed, with blocked (131,072-row blocks) and
    streamed (131,072-row chunks from pinned host memory) beside them.

    Held: approx's recall@10 >= 0.9; at both sizes blocked's and streamed's
    indices equal exact's except rows with two of their first k+1 scores
    within `NEAR_TIE`; int8's indices and scores bitwise those of its CPU
    twin; bf16's top-1 equal to exact's on every near-duplicate query.
    Last, the latent database's five engines on the card against the CPU
    (`_db_engines`)."""
    from latice_tpu_torch.index import (
        IndexPipeline,
        cosine_topk,
        cosine_topk_blocked,
        cosine_topk_int8,
        cosine_topk_streamed,
        l2_normalize,
    )
    from latice_tpu_torch.ops import (
        candidate_consensus_fused,
        cosine_topk_fused,
        cosine_topk_wide,
        instance_norm_leaky_relu,
    )

    engines = {"exact": {}, "fused": {}, "approx": {}, "int8": {},
               "bfloat16": dict(search_dtype="bfloat16")}
    x = np.random.default_rng(12).integers(0, 256, (ENGINE_PATTERNS, 128, 128), dtype=np.uint8)
    batches = ENGINE_PATTERNS // BATCH
    counters = (instance_norm_leaky_relu, cosine_topk_fused, candidate_consensus_fused,
                cosine_topk_wide)
    totals = dict.fromkeys((fn.__name__ for fn in counters), 0)
    served, results = {}, {}
    base = _cli_service(ckpt, npz, "cuda", BATCH, engine="exact")
    for name, kw in engines.items():
        if kw:  # bf16 search is a pipeline option, not a serve CLI flag
            pipe = IndexPipeline(base.pipeline.model, base._db._vectors, base._db._orientations,
                                 top_n=TOP_N, batch_size=BATCH, device="cuda", **kw)
        elif name == "exact":
            pipe = base.pipeline
        else:
            pipe = _cli_service(ckpt, npz, "cuda", BATCH, engine=name).pipeline
        pipe(x[:BATCH])
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        results[name] = pipe(x)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        want = {"instance_norm_leaky_relu": 10 * batches,
                "cosine_topk_fused": batches if name == "fused" else 0,
                "candidate_consensus_fused": batches,  # every engine's consensus
                "cosine_topk_wide": batches if name == "bfloat16" else 0}  # exact over bf16
        if launches != want:
            raise AssertionError(f"engines {name} launches {launches}, want {want}")
        for k, v in launches.items():
            totals[k] += v
        served[name] = dict(wall_s=wall_s, launches_per_batch={k: v / batches
                                                              for k, v in launches.items()})
    exact = results["exact"].indices
    for name, res in results.items():
        served[name].update(recall_at_10=_recall_at(res.indices, exact),
                            top1_agree=float(np.mean(res.indices[:, 0] == exact[:, 0])))
    if not served["approx"]["recall_at_10"] >= ENGINE_RECALL_MIN:
        raise AssertionError(f"approx recall@10 on the served path: {served['approx']}")

    alone = {}
    for rows in (DICT_ROWS, BIG_DICT_ROWS):
        rng = np.random.default_rng(rows)
        d_np = rng.normal(size=(rows, LATENT)).astype(np.float32)
        d_np /= np.linalg.norm(d_np, axis=1, keepdims=True)
        src = rng.choice(rows, BATCH, replace=False)
        q = torch.from_numpy(d_np[src] + 0.05 * rng.normal(size=(BATCH, LATENT)).astype(
            np.float32)).cuda()
        orients = np.zeros((rows, 3), np.float32)
        pipes = {name: IndexPipeline(None, d_np, orients, top_n=TOP_N, batch_size=BATCH,
                                     engine="exact" if kw else name, device="cuda",
                                     feature_fn=_identity, **kw)
                 for name, kw in engines.items()}
        d32 = pipes["exact"].search.table
        host = torch.from_numpy(d_np).pin_memory()
        fns = {name: (lambda p=p: p._search(q)) for name, p in pipes.items()}
        fns["blocked"] = lambda: cosine_topk_blocked(q, d32, TOP_N, block_size=BLOCK_ROWS)
        fns["streamed"] = lambda: cosine_topk_streamed(q, host, TOP_N, chunk_rows=BLOCK_ROWS)
        qn = l2_normalize(q)

        def library():
            return torch.topk(qn @ d32.T, TOP_N)

        library_ms = dict(device_ms=device_busy_ms(library), host_ms=host_bound_ms(library))
        head = cosine_topk(q, d32, TOP_N + 1)[0]
        near = ((head[:, :-1] - head[:, 1:]) <= NEAR_TIE).any(dim=1).cpu().numpy()
        out = {name: [t.cpu() for t in fn()] for name, fn in fns.items()}
        torch.cuda.synchronize()
        ex_i = out["exact"][1].numpy()
        stats = {}
        for name, (_, i_) in out.items():
            i_ = i_.numpy()
            fn = fns[name]
            stats[name] = dict(device_ms=device_busy_ms(fn), host_ms=host_bound_ms(fn),
                               waits_for_device=waits_for_device(fn),
                               recall_at_10=_recall_at(i_, ex_i),
                               top1_agree=float(np.mean(i_[:, 0] == ex_i[:, 0])),
                               rows_differing=int((i_ != ex_i).any(axis=1).sum()))
        for name in ("blocked", "streamed", "fused"):
            bad = (out[name][1].numpy() != ex_i).any(axis=1) & ~near
            if bad.any():
                raise AssertionError(f"{name} at {rows} rows: {int(bad.sum())} rows differ from "
                                     "exact without a near tie")
        di8 = pipes["int8"].search.table
        twin_s, twin_i = cosine_topk_int8(q.cpu(), di8.cpu(), TOP_N, n_valid=rows)
        if not (torch.equal(twin_i, out["int8"][1]) and torch.equal(twin_s, out["int8"][0])):
            raise AssertionError(f"int8 at {rows} rows differs from its CPU twin")
        if not stats["approx"]["recall_at_10"] >= ENGINE_RECALL_MIN:
            raise AssertionError(f"approx recall@10 at {rows} rows: {stats['approx']}")
        if not stats["bfloat16"]["top1_agree"] == 1.0:
            raise AssertionError(f"bf16 top-1 at {rows} rows: {stats['bfloat16']}")
        alone[f"n{rows}"] = dict(engines=stats, library_ms=library_ms,
                                 streamed_rows_pinned=bool(host[:BLOCK_ROWS].is_pinned()),
                                 near_tie_rows=int(near.sum()), int8_twin_bitwise=True,
                                 dictionary_mb=dict(f32=4 * rows * LATENT / 2**20,
                                                    bf16=2 * rows * LATENT / 2**20,
                                                    int8=di8.numel() / 2**20))
        del pipes, fns, out, host, d32, di8
        torch.cuda.empty_cache()
    emit("engines", patterns=ENGINE_PATTERNS, batches=batches, served=served, launches=totals,
         search_alone=alone, database=_db_engines(),
         queries="B=256 dictionary rows plus 0.05 Gaussian noise",
         timed_as="the search alone, k=20: device_ms the kernels' and copies' device time "
                  "from a trace of 5 calls; host_ms CUDA events over 20 calls from an idle "
                  "stream (host-paced)")
    return totals


def _dense_result(n: int, seed: int):
    """A seeded `DenseIndexResult` of ``n`` points: 10% failures (half of
    them NaN angles), two phases, scores best first."""
    from latice_tpu_torch.index import DenseIndexResult

    rng = np.random.default_rng(seed)
    success = rng.uniform(size=n) > 0.1
    best = rng.uniform(0, 360, (n, 3))
    best[~success & (rng.uniform(size=n) > 0.5)] = np.nan
    return DenseIndexResult(
        mean_orientation=np.where(success[:, None], best, np.nan), best_orientation=best,
        success=success, n_similar=rng.integers(0, TOP_N + 1, n),
        indices=rng.integers(0, DICT_ROWS, (n, 5)),
        scores=np.sort(rng.uniform(0.4, 1.0, (n, 5)), axis=1)[:, ::-1],
        phase=rng.integers(0, 2, n))


def phase_tools(workdir: str, ckpt: str, npz: str) -> dict:
    """The host runtime and the utilities around the main path.

    1. The native engine: ``TorchLatentVectorDatabase(engine="native")``
       over the serve phase's 100,000 x 16 dictionary, 256 near-duplicate
       queries, host-timed; its indices equal ``engine="device"``'s (exact,
       on the card) except rows with two of their first k+1 scores within
       `NEAR_TIE`.
    2. Export: `write_ang` and `write_ctf` of `EXPORT_ROWS` points through
       the native formatter and through the Python loop, byte-equal, each
       timed.
    3. The trace reader: one `IndexPipeline` call of 512 patterns (the
       serve CLI's service, fused engine) under `utils.trace`; the
       summary's kernel and copy total within 2% of `_device_kernels`' sum
       for the same capture, K2f and K1 named among its ops with their
       launch counts. The launches of that call are this path's.
    4. `get_platform()` is ``"gpu"``; `PhaseTimer(sync=True)` around one
       encode of 256 patterns, against CUDA events.
    """
    from unittest import mock

    from latice_tpu_torch import native
    from latice_tpu_torch.data import write_ang, write_ctf
    from latice_tpu_torch.index import LatentVectorDatabaseConfig, TorchLatentVectorDatabase
    from latice_tpu_torch.ops import (
        candidate_consensus_fused,
        cosine_topk_fused,
        instance_norm_leaky_relu,
    )
    from latice_tpu_torch.utils import PhaseTimer, get_platform, summarize_trace, trace

    t_phase = time.perf_counter()
    out: dict = {}
    # 1. The native engine over the serve phase's dictionary.
    if not native.available():
        raise AssertionError("the native library did not build (g++)")
    dbs = {engine: TorchLatentVectorDatabase(
        LatentVectorDatabaseConfig(npz_path=npz, dimension=LATENT, engine=engine), device="cuda")
        for engine in ("native", "device")}
    vecs = dbs["native"]._vectors
    rng = np.random.default_rng(13)
    q = (vecs[rng.choice(len(vecs), BATCH, replace=False)]
         + 0.05 * rng.normal(size=(BATCH, LATENT))).astype(np.float32)
    got = dbs["native"].query_similar_batch(q, TOP_N)
    host_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        dbs["native"].query_similar_batch(q, TOP_N)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    want = dbs["device"].query_similar_batch(q, TOP_N)
    head = dbs["device"].query_similar_batch(q, TOP_N + 1)[0]
    near = (head[:, :-1] - head[:, 1:] <= NEAR_TIE).any(axis=1)
    differ = (got[1] != want[1]).any(axis=1)
    if (differ & ~near).any():
        raise AssertionError(f"native engine: {int((differ & ~near).sum())} rows differ from "
                             "exact without a near tie")
    score_err = float(np.abs(got[0] - want[0]).max())
    out["native_engine"] = dict(
        rows=len(vecs), queries=BATCH, k=TOP_N, host_ms_per_256=float(np.median(host_ms)),
        host_ms_runs=host_ms, rows_differing=int(differ.sum()), near_tie_rows=int(near.sum()),
        score_max_abs_err=score_err, library=native.build().name, cpu_threads=os.cpu_count())
    del dbs

    # 2. Export: native rows against the Python loop.
    result = _dense_result(EXPORT_ROWS, seed=14)
    grid = (EXPORT_ROWS // 512, 512)
    export = {}
    for writer, fmt in ((write_ang, "format_ang_rows_native"), (write_ctf, "format_ctf_rows_native")):
        suffix = writer.__name__[-3:]
        paths = {k: f"{workdir}/tools_{k}.{suffix}" for k in ("native", "python")}
        t0 = time.perf_counter()
        writer(paths["native"], result, grid=grid)
        native_s = time.perf_counter() - t0
        with mock.patch.object(native, fmt, side_effect=ImportError("the Python loop")):
            t0 = time.perf_counter()
            writer(paths["python"], result, grid=grid)
            python_s = time.perf_counter() - t0
        body = {k: Path(v).read_bytes() for k, v in paths.items()}
        if body["native"] != body["python"]:
            raise AssertionError(f"{suffix}: native and Python rows differ")
        export[suffix] = dict(native_s=native_s, python_s=python_s, bytes=len(body["native"]),
                              byte_equal=True)
    out["export"] = dict(rows=EXPORT_ROWS, **export)

    # 3. The trace reader on one traced IndexPipeline call.
    service = _cli_service(ckpt, npz, "cuda", BATCH)
    x = np.random.default_rng(15).integers(0, 256, (2 * BATCH, 128, 128), dtype=np.uint8)
    service.pipeline(x)
    torch.cuda.synchronize()
    counters = (instance_norm_leaky_relu, cosine_topk_fused, candidate_consensus_fused)
    for fn in counters:
        fn.launches = 0
    trace_dir = Path(workdir) / "tools_trace"
    with trace(trace_dir, "index") as prof:
        service.pipeline(x)
    launches = {fn.__name__: fn.launches for fn in counters}
    profiler_ms = sum(t for _, t, _ in _device_kernels(prof))
    summary = summarize_trace(str(trace_dir), category=("kernel", "gpu_memcpy", "gpu_memset"))
    kernels_only = summarize_trace(str(trace_dir))
    rel = abs(summary.total_ms - profiler_ms) / profiler_ms
    named = {}
    for fn, marks in ((instance_norm_leaky_relu, ("instance_norm_lrelu",)),
                      (cosine_topk_fused, ("topk_partial", "topk_merge")),
                      (candidate_consensus_fused, ("consensus_fused",))):
        ops = [(rank, op) for rank, op in enumerate(kernels_only.ops) if any(
            m in op.name for m in marks)]
        if not ops:
            raise AssertionError(f"the trace summary names no kernel of {fn.__name__}")
        named[fn.__name__] = dict(ranks=[r for r, _ in ops], calls=[op.count for _, op in ops],
                                  ms=sum(op.total_ms for _, op in ops))
    if not rel <= 0.02:
        raise AssertionError(f"trace summary {summary.total_ms} ms vs profiler {profiler_ms} ms")
    for name in ("instance_norm_leaky_relu", "candidate_consensus_fused"):
        # K2f's launches split between its NHWC kernel's instantiations
        if sum(named[name]["calls"]) != launches[name]:
            raise AssertionError(f"{name} calls in the trace {named} vs launches {launches}")
    if launches["candidate_consensus_fused"] != 2:  # one a batch
        raise AssertionError(f"tools trace launches {launches}, want 2 consensus launches")
    out["trace"] = dict(patterns=len(x), summary_ms=summary.total_ms, kernels_ms=kernels_only.total_ms,
                        profiler_ms=profiler_ms, rel_diff=rel, ops=len(kernels_only.ops),
                        named=named, top=[dict(kernel=op.name[:80], ms=op.total_ms, calls=op.count)
                                          for op in kernels_only.ops[:5]])

    # 4. Devices and timers.
    platform = get_platform()
    if platform != "gpu":
        raise AssertionError(f"get_platform() = {platform!r} on the card")
    timer = PhaseTimer(sync=True)
    xb = torch.from_numpy(x[:BATCH, None].astype(np.float32) / 255.0).cuda()
    model = service.pipeline.model
    with torch.inference_mode():
        model.encode(xb)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with timer.phase("encode"):
            start.record()
            model.encode(xb)
            end.record()
    report = timer.report()
    event_s = start.elapsed_time(end) / 1e3
    if not report["encode/total_s"] >= event_s:
        raise AssertionError(f"PhaseTimer {report} ended before the device's {event_s} s")
    out["devices"] = dict(platform=platform, phase_timer=report, encode_events_s=event_s)
    del service
    torch.cuda.empty_cache()
    emit("tools", **out, launches=launches, phase_s=time.perf_counter() - t_phase)
    return launches


def _serve_files(workdir: str) -> tuple[str, str, np.random.Generator]:
    """The serve phase's seeded checkpoint and its 100,000-row dictionary,
    and the generator that drew the dictionary (the serve phase draws its
    requests from it next)."""
    from latice_tpu_torch.index import LatentVectorDatabaseConfig, TorchLatentVectorDatabase
    from latice_tpu_torch.models import VariationalAutoEncoderRawData

    ckpt, npz = f"{workdir}/vae.pt", f"{workdir}/latent_index.npz"
    model = VariationalAutoEncoderRawData(INPLANES, LATENT)
    torch.save(model.init_weights(torch.Generator().manual_seed(0)).state_dict(), ckpt)
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(DICT_ROWS, LATENT)).astype(np.float32)
    orients = rng.uniform([0, 20, 0], [340, 140, 340], size=(DICT_ROWS, 3))
    db = TorchLatentVectorDatabase(LatentVectorDatabaseConfig(npz_path=npz, dimension=LATENT))
    db.add_vectors(vecs, orients)
    db.save()
    return ckpt, npz, rng


def _near_tie_rows(scores: np.ndarray, k: int) -> np.ndarray:
    """Rows with two of their first ``k`` scores within `NEAR_TIE` (their
    order may turn on the last bit)."""
    head = np.asarray(scores)[:, :k]
    return ((head[:, :-1] - head[:, 1:]) <= NEAR_TIE).any(axis=1)


def _hold_indices(name: str, got, want, scores) -> int:
    """``got``'s indices equal ``want``'s but in rows with a near tie
    (`NEAR_TIE`, the engines phase's rule); the count of such rows."""
    differ = (np.asarray(got) != np.asarray(want)).any(axis=1)
    near = _near_tie_rows(scores, np.asarray(want).shape[1])
    if (differ & ~near).any():
        raise AssertionError(f"mesh {name}: {int((differ & ~near).sum())} rows differ from one "
                             "device without a near tie")
    return int(differ.sum())


def _dp_grads(state: dict, batch, dev, mesh=None,
              dtype=torch.float32) -> tuple[float, dict, torch.Tensor]:
    """One train step from ``state`` on ``batch`` (x, eps; every row real)
    on ``dev``, over ``mesh`` when given (its first device is ``dev``), in
    ``dtype``: (loss, {name: grad as f64 on the CPU}, the first parameter
    leaf after the update)."""
    from latice_tpu_torch.models import VariationalAutoEncoderRawData
    from latice_tpu_torch.train import VAELoss, make_optimizer, make_train_step

    model = VariationalAutoEncoderRawData(INPLANES, LATENT)
    model.load_state_dict(state)
    model.to(dev, dtype)
    x, eps = (t.to(dev, dtype) for t in batch)
    step = make_train_step(VAELoss(kl_lambda=5e-6), mesh=mesh)
    m = step(model, make_optimizer(model.parameters()), x, None, 0, eps)
    return (float(m["loss"]), {k: p.grad.detach().cpu().double()
                               for k, p in model.named_parameters()},
            next(model.parameters()).detach().clone())


def _mesh_dp_train(mesh, counters) -> tuple[dict, dict]:
    """The DP train step at full width (f32, TF32 off) against the
    one-device step from the same weights and noise, then both timed at
    16-mixed. Returns (readings, this path's launches).

    At B=64 the loss and the first parameter leaf after the update are held
    at 1e-5 and the summed gradients are reported: at full width an f32
    step's gradient is conditioned at about 1e-2 of a leaf's scale (an f32
    rounding moves an activation across LeakyReLU's kink or swaps a
    max-pool's argmax, and the flip reaches every leaf upstream; see
    `phase_train_parity`), and cuDNN's f32 forward of a 16-row block is not
    bitwise that of the same rows in a 64-row batch. So the gradients are
    held by `phase_train_parity`'s rule at B=8 (2 rows per replica): each
    leaf of the DP step within `GRAD_RATIO` times the one-device step's
    distance from a float64 CPU step plus `GRAD_FLOOR`, each over the
    leaf's largest f64 |gradient| (the before-norm biases, whose exact
    gradient is 0, reported only). In float64 the DP step equals the
    one-device step to ~5e-16 (the CPU tests)."""
    from latice_tpu_torch.models import VariationalAutoEncoderRawData
    from latice_tpu_torch.train import VAELoss, make_optimizer, make_train_step

    state = VariationalAutoEncoderRawData(INPLANES, LATENT).init_weights(
        torch.Generator().manual_seed(21)).state_dict()
    layout = VariationalAutoEncoderRawData(INPLANES, LATENT)
    out, launches = {}, dict.fromkeys((fn.__name__ for fn in counters), 0)
    for batch_rows in (TRAIN_BATCH, MESH_GRAD_BATCH):
        batch = (torch.from_numpy(_synthetic_patterns(batch_rows, seed=22)[:, None]),
                 torch.from_numpy(np.random.default_rng(23).normal(
                     size=(batch_rows, LATENT)).astype(np.float32)))
        l1, g1, p1 = _dp_grads(state, batch, "cuda")
        for fn in counters:
            fn.launches = 0
        l4, g4, p4 = _dp_grads(state, batch, mesh.devices[0], mesh)
        torch.cuda.synchronize()
        step_launches = {fn.__name__: fn.launches for fn in counters}
        want = {"instance_norm_leaky_relu": 19 * mesh.size,
                "instance_norm_leaky_relu_backward": 19 * mesh.size,
                "candidate_consensus_fused": 0}
        if {k: step_launches[k] for k in want} != want:
            raise AssertionError(f"DP step launches {step_launches}, want {want}")
        for k, v in step_launches.items():
            launches[k] += v
        held = [k for k in g1 if not _before_norm_bias(k, layout)]
        rel = {k: ((g4[k] - g1[k]).abs().max() / g1[k].abs().max()).item() for k in held}
        worst = max(rel, key=rel.get)
        loss_rel = abs(l4 - l1) / abs(l1)
        param_err = (p4 - p1).abs().max().item()
        reading = dict(loss_one=l1, loss_mesh=l4, loss_rel_err=loss_rel,
                       first_param_max_abs_err=param_err, grad_worst_leaf=worst,
                       grad_worst_rel_to_one_device=rel[worst], launches=step_launches)
        if not loss_rel <= MESH_LOSS_RTOL:
            raise AssertionError(f"DP step at B={batch_rows}: loss {l4} vs one device {l1}")
        if not param_err <= MESH_PARAM_ATOL:
            raise AssertionError(f"DP step at B={batch_rows}: first parameter leaf {param_err}")
        if batch_rows == MESH_GRAD_BATCH:
            from unittest import mock

            from latice_tpu_torch.models import InstanceNormLeakyReLU

            with mock.patch.object(InstanceNormLeakyReLU, "forward", _aten_norm):
                _, g_ref, _ = _dp_grads(state, batch, "cpu", dtype=torch.float64)

            def dist(g):
                return {k: ((g[k] - g_ref[k]).abs().max() / g_ref[k].abs().max()).item()
                        for k in held}

            d1, d4 = dist(g1), dist(g4)
            share = {k: d4[k] / (GRAD_RATIO * d1[k] + GRAD_FLOOR) for k in held}
            worst_share = max(share, key=share.get)
            reading.update(grad_vs_f64_worst_leaf=worst_share,
                           grad_vs_f64_share_of_limit=share[worst_share],
                           grad_vs_f64_mesh=d4[worst_share], grad_vs_f64_one=d1[worst_share])
            if not share[worst_share] <= 1.0:
                raise AssertionError(f"DP gradient of {worst_share}: {d4[worst_share]} from f64 "
                                     f"against one device's {d1[worst_share]}")
        out[f"b{batch_rows}_f32"] = reading

    # The step's times at the training precision: host wall per step over
    # MESH_STEP_TIMED steps, and device time from a trace.
    x = torch.from_numpy(_synthetic_patterns(TRAIN_BATCH, seed=22)[:, None]).cuda()
    eps = torch.from_numpy(np.random.default_rng(23).normal(
        size=(TRAIN_BATCH, LATENT)).astype(np.float32)).cuda()
    times = {}
    for name, m in (("one", None), ("mesh", mesh)):
        model = VariationalAutoEncoderRawData(INPLANES, LATENT)
        model.load_state_dict(state)
        model = model.cuda().set_precision("16-mixed")
        opt = make_optimizer(model.parameters())
        step = make_train_step(VAELoss(kl_lambda=5e-6), mesh=m)
        run = lambda: step(model, opt, x, None, 0, eps)  # noqa: E731
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_STEP_TIMED):
            run()
        torch.cuda.synchronize()
        times[name] = dict(wall_ms=(time.perf_counter() - t0) * 1e3 / MESH_STEP_TIMED,
                           device_ms=device_busy_ms(run))
    out["timed_16mixed_b64"] = times
    return out, launches


def _mesh_search(mesh, counters) -> dict:
    """The sharded search alone at B=256 over the engines phase's
    1,000,000 rows, each engine against the unsharded one on the card, timed
    beside it: device time from a trace, and CUDA events over calls from an
    idle stream (host-paced). Launches here are comparisons, not the
    path's."""
    from latice_tpu_torch.index import IndexPipeline
    from latice_tpu_torch.parallel import shard_dictionary, sharded_cosine_topk
    from latice_tpu_torch.parallel.sharded_knn import quantize_dictionary_int8

    rows = BIG_DICT_ROWS
    rng = np.random.default_rng(rows)
    d_np = rng.normal(size=(rows, LATENT)).astype(np.float32)
    d_np /= np.linalg.norm(d_np, axis=1, keepdims=True)
    src = rng.choice(rows, BATCH, replace=False)
    q = torch.from_numpy(d_np[src] + 0.05 * rng.normal(size=(BATCH, LATENT)).astype(
        np.float32)).cuda()
    orients = np.zeros((rows, 3), np.float32)
    sharded = {"f32": shard_dictionary(d_np, mesh),
               "int8": shard_dictionary(quantize_dictionary_int8(d_np)[0], mesh)}
    out = {}
    for engine in ("exact", "fused", "int8", "approx"):
        pipe = IndexPipeline(None, d_np, orients, top_n=TOP_N, batch_size=BATCH,
                             engine=engine, device="cuda", feature_fn=_identity)
        table = sharded["int8" if engine == "int8" else "f32"]
        one = lambda p=pipe: p._search(q)  # noqa: E731
        four = lambda e=engine, t=table: sharded_cosine_topk(  # noqa: E731
            q, t, TOP_N, mesh, n_valid=rows, engine=e)
        s1, i1 = (t.cpu().numpy() for t in one())
        s4, i4 = (t.cpu().numpy() for t in four())
        reading = dict(one_device_ms=device_busy_ms(one), mesh_device_ms=device_busy_ms(four),
                       one_host_ms=host_bound_ms(one), mesh_host_ms=host_bound_ms(four),
                       mesh_waits_for_device=waits_for_device(four))
        if engine == "approx":
            reading["recall_at_10"] = _recall_at(i4, i1)
            if not reading["recall_at_10"] >= ENGINE_RECALL_MIN:
                raise AssertionError(f"sharded approx recall@10 {reading['recall_at_10']}")
        else:
            # exact and fused are exact searches; int8's int32 products are
            # exact: each is held to its unsharded self, bit for bit.
            if not (np.array_equal(i4, i1) and np.array_equal(s4, s1)):
                raise AssertionError(f"sharded {engine} differs from unsharded "
                                     f"({int((i4 != i1).any(axis=1).sum())} rows)")
            reading["bitwise"] = True
        out[engine] = reading
        del pipe
    del sharded
    torch.cuda.empty_cache()
    return dict(rows=rows, queries=BATCH, k=TOP_N, shards=mesh.size, **out)


def _mesh_pipeline(mesh, ckpt: str, npz: str, counters) -> tuple[dict, dict]:
    """`IndexPipeline` over the serve phase's model and dictionary, with the
    exact and the fused engine, mesh against one device on 512 patterns.
    Returns (readings, this path's launches).

    Held in f32 (TF32 off): the indices equal but in rows where two of the
    one-device run's first k+1 scores lie within twice that row's latent
    distance (the normalized latents' L2 distance bounds every score's
    change, so only such rows can swap). The served model (16-mixed) is
    timed: its bf16 convolutions of a 64-row block round otherwise than in
    a 256-row batch (latents ~1e-2 apart), so its indices are not held."""
    from latice_tpu_torch.index import IndexPipeline, l2_normalize

    base = _cli_service(ckpt, npz, "cuda", BATCH, engine="exact")
    served, db = base.pipeline.model, base._db
    f32 = copy.deepcopy(served).set_precision("32")
    x = np.random.default_rng(24).integers(0, 256, (MESH_PATTERNS, 128, 128), dtype=np.uint8)
    batches = MESH_PATTERNS // BATCH
    out, totals = {}, dict.fromkeys((fn.__name__ for fn in counters), 0)
    for engine in ("exact", "fused"):
        kw = dict(top_n=TOP_N, batch_size=BATCH, engine=engine)
        one = IndexPipeline(f32, db._vectors, db._orientations, device="cuda", **kw)
        four = IndexPipeline(f32, db._vectors, db._orientations, mesh=mesh, **kw)
        want = one(x)
        four(x[:BATCH])
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        got = four(x)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}
        expect = {"instance_norm_leaky_relu": 10 * mesh.size * batches,
                  "cosine_topk_fused": mesh.size * batches if engine == "fused" else 0,
                  "candidate_consensus_fused": batches}  # on the first device, once a batch
        if {k: launches[k] for k in expect} != expect:
            raise AssertionError(f"mesh pipeline {engine} launches {launches}, want {expect}")
        for k, v in launches.items():
            totals[k] += v
        u1, u4 = (l2_normalize(torch.from_numpy(p.encode(x))) for p in (one, four))
        delta = (u4 - u1).norm(dim=1).numpy()
        gaps = np.diff(-np.asarray(want.scores), axis=1)  # (B, k-1), >= 0
        near = (gaps <= 2 * delta[:, None]).any(axis=1)
        differ = (got.indices != want.indices).any(axis=1)
        if (differ & ~near).any():
            raise AssertionError(f"mesh pipeline {engine}: {int((differ & ~near).sum())} rows "
                                 "differ from one device beyond their latents' distance")
        out[engine] = dict(rows_differing=int(differ.sum()), rows_within_margin=int(near.sum()),
                           latent_unit_max_dist=float(delta.max()),
                           score_max_abs_err=float(np.abs(got.scores - want.scores).max()),
                           launches_per_shard_batch={k: v / (mesh.size * batches)
                                                     for k, v in launches.items()})
        # The served precision, timed: host wall per call and device time.
        timed = {}
        for tag, m in (("one", None), ("mesh", mesh)):
            pipe = IndexPipeline(served, db._vectors, db._orientations, mesh=m,
                                 device=None if m else "cuda", **kw)
            pipe(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                pipe(x)
            timed[tag] = dict(wall_ms=(time.perf_counter() - t0) * 1e3 / 3,
                              device_ms=device_busy_ms(lambda p=pipe: p(x), iters=2))
        out[engine]["timed_16mixed"] = timed
        del one, four, pipe
    del base
    torch.cuda.empty_cache()
    return dict(patterns=MESH_PATTERNS, batches=batches, dictionary_rows=DICT_ROWS,
                held_precision="32", **out), totals


def _mesh_fit(mesh, workdir: str, counters) -> tuple[dict, dict]:
    """`Trainer.fit` over the mesh for one epoch: 3*4+1 training rows at
    batch 8 (the tail padded), full width, 16-mixed. Returns (readings, this
    path's launches)."""
    from latice_tpu_torch.data import DPDataModule
    from latice_tpu_torch.models import VariationalAutoEncoderRawData
    from latice_tpu_torch.train import Trainer, VAEModule

    root = Path(workdir) / "mesh_fit"
    root.mkdir()
    np.save(root / "p.npy", _synthetic_patterns(MESH_FIT_PATTERNS, seed=25))
    with open(root / "a.txt", "w") as f:
        f.write(f"zxz\n{MESH_FIT_PATTERNS}\n")
        np.savetxt(f, np.random.default_rng(26).uniform(0, 360, (MESH_FIT_PATTERNS, 3)),
                   fmt="%.4f")
    dm = DPDataModule(root / "p.npy", root / "a.txt", batch_size=MESH_FIT_BATCH, seed=27)
    trainer = Trainer(max_epochs=1, seed=28, mesh=mesh, enable_progress_bar=False,
                      recon_figure=False)
    module = VAEModule(VariationalAutoEncoderRawData(INPLANES, LATENT), kl_lambda=5e-6)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    trainer.fit(module, dm)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    n_train, n_val = trainer.steps_run["train"], trainer.steps_run["val"]
    if (dm.train_size, n_train, n_val) != (13, 2, 1):
        raise AssertionError(f"mesh fit: {dm.train_size} rows, {n_train} train and {n_val} "
                             "eval steps, want 13, 2 and 1")
    want = {"instance_norm_leaky_relu": 19 * mesh.size * (n_train + n_val),
            "instance_norm_leaky_relu_backward": 19 * mesh.size * n_train,
            "candidate_consensus_fused": 0}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"mesh fit launches {launches}, want {want}")
    epoch = trainer.history[0]
    if not all(np.isfinite(v) for v in epoch.values()):
        raise AssertionError(f"mesh fit epoch metrics {epoch}")
    return dict(train_rows=dm.train_size, batch=MESH_FIT_BATCH, train_steps=n_train,
                eval_steps=n_val, wall_s=wall_s, epoch=epoch,
                launches_per_replica_train_step=19), launches


def _mesh_one_card_flags(workdir: str, npz: str, ckpt: str) -> dict:
    """``cli.index build|query --devices 4``, ``cli.serve
    --shard-dictionary`` and ``master --devices 2`` on a machine with fewer
    cards: each logs the JAX CLI's warning and runs on one device."""
    from latice_tpu_torch.cli import index as index_cli
    from latice_tpu_torch.cli.serve import build_service, parse_args

    root = Path(workdir) / "mesh_cli"
    root.mkdir()
    n = MESH_CLI_PATTERNS
    x = np.random.default_rng(29).integers(0, 256, (n, 128, 128), dtype=np.uint8)
    np.save(root / "p.npy", x)
    (root / "a.txt").write_text(f"eu\n{n}\n" + "".join(
        f"{a:.4f} {b:.4f} {c:.4f}\n" for a, b, c in np.random.default_rng(30).uniform(
            [0, 20, 0], [340, 140, 340], (n, 3))))
    model = ["--checkpoint", ckpt, "--inplanes", str(INPLANES), "--latent-dim", str(LATENT),
             "--batch-size", str(BATCH)]
    attached = torch.cuda.device_count()
    log = _Captured("latice_tpu_torch.cli")
    with log, contextlib.redirect_stdout(io.StringIO()) as stdout:
        index_cli.main(["build", "--patterns", str(root / "p.npy"), "--angles",
                        str(root / "a.txt"), "--db", str(root / "db.npz"), "--devices",
                        str(MESH_SHARDS)] + model)
        index_cli.main(["query", "--patterns", str(root / "p.npy"), "--db", str(root / "db.npz"),
                        "--out", str(root / "o.npy"), "--engine", "fused", "--devices",
                        str(MESH_SHARDS)] + model)
        index_cli.main(["master", "--size", "33", "--beams", "15", "--max-hkl", "2",
                        "--devices", "2", "--out", str(root / "m.npy")])
        service = build_service(parse_args(["--db", npz, "--shard-dictionary"] + model))
    summary = json.loads(stdout.getvalue().strip().splitlines()[-1])
    messages = "\n".join(log.messages)
    out = dict(attached=attached, messages=log.messages)
    expected = []
    if attached < MESH_SHARDS:  # build and query
        expected += [f"--devices {MESH_SHARDS} ignored: only {attached} attached"] * 2
    if attached < 2:
        expected += [f"--devices 2 ignored: only {attached} attached",
                     "--shard-dictionary ignored: one device attached"]
    for want in set(expected):
        if messages.count(want) < expected.count(want):
            raise AssertionError(f"missing warning {want!r} in {log.messages}")
    if attached < 2 and service.health()["mesh_devices"] != 0:
        raise AssertionError(f"/healthz {service.health()}")
    top1 = np.load(root / "o.npy")
    if top1.shape != (n, 3) or not np.isfinite(top1).all():
        raise AssertionError(f"query --devices output {top1.shape}")
    out["master_summary"] = {k: summary[k] for k in summary if k != "out"}
    del service
    return out


def _mesh_planes(mesh, workdir: str) -> dict:
    """The remaining mesh paths against one device on the card."""
    from scipy.spatial.transform import Rotation as R

    from latice_tpu_torch import hrebsd as th
    from latice_tpu_torch import sim as tsim
    from latice_tpu_torch.index import (
        DiffractionPatternIndexer,
        HoughIndexer,
        IndexerConfig,
        LatentVectorDatabaseConfig,
        PatternDictionaryIndexer,
        SphericalIndexer,
        SphericalIndexerConfig,
        TorchLatentVectorDatabase,
    )
    from latice_tpu_torch.index.spherical import projection_tables
    from latice_tpu_torch.models import VariationalAutoEncoderRawData
    from latice_tpu_torch.parallel import make_mesh
    from latice_tpu_torch.serve import IndexService

    out = {}
    # DiffractionPatternIndexer: the encode batches shard.
    model = VariationalAutoEncoderRawData(INPLANES, LATENT).init_weights(
        torch.Generator().manual_seed(31)).cuda().set_precision("32").eval()
    pats = _synthetic_patterns(MESH_PATTERNS, seed=32)
    lat = {}
    for tag, m in (("one", None), ("mesh", mesh)):
        ix = DiffractionPatternIndexer(model, config=IndexerConfig(
            batch_size=BATCH, latent_dim=LATENT), mesh=m)
        lat[tag] = ix.encode_patterns_batch(pats)
    err = float(np.abs(lat["mesh"] - lat["one"]).max())
    if not err <= MESH_LATENT_ATOL:
        raise AssertionError(f"mesh indexer latents {err}")
    out["indexer"] = dict(patterns=len(pats), precision="32", latent_max_abs_err=err)

    # IndexService: /healthz, /index and /encode.
    db = TorchLatentVectorDatabase(LatentVectorDatabaseConfig(
        npz_path=f"{workdir}/mesh_service.npz", dimension=LATENT), device="cuda")
    rows = lat["one"][:BATCH]
    db.add_vectors(rows / np.linalg.norm(rows, axis=1, keepdims=True),
                   np.random.default_rng(33).uniform([0, 20, 0], [340, 140, 340], (len(rows), 3)))
    kw = dict(top_n=TOP_N, min_required_matches=1, batch_size=BATCH, device="cuda")
    one, four = IndexService(model, db, **kw), IndexService(model, db, mesh=mesh, **kw)
    health = four.health()
    if health["mesh_devices"] != mesh.size:
        raise AssertionError(f"/healthz {health}")
    r1, r4 = one.index(pats[:BATCH]), four.index(pats[:BATCH])
    e1 = np.asarray(one.encode(pats[:64])["latents"])
    e4 = np.asarray(four.encode(pats[:64])["latents"])
    if r1["success"] != r4["success"] or not np.allclose(
            r4["orientations"], r1["orientations"], rtol=0, atol=1e-3):
        raise AssertionError("mesh /index differs from one device")
    if not np.abs(e4 - e1).max() <= MESH_LATENT_ATOL:
        raise AssertionError(f"mesh /encode {np.abs(e4 - e1).max()}")
    out["service"] = dict(mesh_devices=health["mesh_devices"],
                          encode_max_abs_err=float(np.abs(e4 - e1).max()))
    del one, four, db, model

    # Pattern DI: the query features by batch, the dictionary rows by row.
    quats = np.roll(R.random(MESH_DI_ROWS, random_state=34).as_quat(), 1, axis=1)
    geom = tsim.DetectorGeometry()
    dict_pats = tsim.simulate_patterns(quats, geom, device="cuda")
    queries = dict_pats[:MESH_DI_QUERIES] + np.random.default_rng(35).normal(
        scale=0.05, size=(MESH_DI_QUERIES, 128, 128)).astype(np.float32)
    angles = np.degrees(R.from_quat(np.roll(quats, -1, axis=1)).as_euler("zxz"))
    kw = dict(top_n=TOP_N, min_required_matches=1, batch_size=BATCH)
    res = {}
    for tag, m in (("one", None), ("mesh", mesh)):
        ix = PatternDictionaryIndexer(dict_pats, angles, mesh=m, device="cuda", **kw)
        res[tag] = ix(queries)
    # The bf16 mesh search multiplies f32 queries into bf16 shards, as the
    # JAX package's does, and the one-device bf16 search rounds its queries
    # too, so the two differ by design (~2e-4): the card's mesh is held to
    # the CPU's mesh path over the card's own table (the two builds' f32
    # features may round to bf16 apart).
    table = torch.cat([t.cpu() for t in ix.pipeline.search.table.shards])[:MESH_DI_ROWS]
    cpu_mesh = make_mesh(devices=["cpu"] * MESH_SHARDS)
    res["cpu"] = PatternDictionaryIndexer(table, angles, mesh=cpu_mesh, device="cpu",
                                          **kw)(queries)
    differ = _hold_indices("DI", res["mesh"].indices, res["cpu"].indices, res["cpu"].scores)
    di_err = float(np.abs(res["mesh"].scores - res["cpu"].scores).max())
    if not di_err <= MESH_SCORE_ATOL:
        raise AssertionError(f"mesh DI scores {di_err} from the CPU mesh")
    out["pattern_di"] = dict(rows=MESH_DI_ROWS, queries=MESH_DI_QUERIES, search_dtype="bfloat16",
                             rows_differing=differ, score_max_abs_err=di_err,
                             one_device_score_diff=float(
                                 np.abs(res["mesh"].scores - res["one"].scores).max()))

    # HoughIndexer: the orientation grid's chunks shard.
    hough_pats = dict_pats[:MESH_HOUGH_PATTERNS]
    hres = {tag: HoughIndexer(tsim.cubic_reflectors(), geom, mesh=m,
                              device=None if m else "cuda")(hough_pats)
            for tag, m in (("one", None), ("mesh", mesh))}
    gap = hres["mesh"].band_score - hres["one"].band_score
    if not (gap >= -MESH_HOUGH_SLACK).all():
        raise AssertionError(f"mesh Hough band score below one device's by {-gap.min()}")
    out["hough"] = dict(patterns=len(hough_pats), min_score_gain=float(gap.min()),
                        rows_tied=int((np.abs(gap) < 1e-5).sum()))
    del dict_pats, hres, res

    # SphericalIndexer and its ambiguity diagnostic.
    master = tsim.make_kinematical_master(size=257)
    sgeom = tsim.DetectorGeometry(shape=(128, 128))
    sq = np.roll(R.random(MESH_SPHERE_PATTERNS, random_state=36).as_quat(), 1, axis=1)
    spats = tsim.render_from_master(master, sq, sgeom, device="cuda")
    cfg = SphericalIndexerConfig(bandwidth=MESH_SPHERE_L, detector_bin=SPHERE_BIN,
                                 chunk=SPHERE_CHUNK)
    tables = projection_tables(MESH_SPHERE_L, sgeom, SPHERE_BIN)
    sph = {}
    for tag, m in (("one", None), ("mesh", mesh)):
        ix = SphericalIndexer(master, sgeom, cfg, mesh=m, tables=tables,
                              device=None if m else "cuda")
        sph[tag] = (ix.index_patterns(spats).scores, ix.ambiguity(spats[:64], n_cells=32).score_gap)
    s_err = float(np.abs(sph["mesh"][0] - sph["one"][0]).max())
    a_err = float(np.nanmax(np.abs(sph["mesh"][1] - sph["one"][1])))
    if not (s_err <= MESH_SCORE_ATOL and a_err <= MESH_SCORE_ATOL):
        raise AssertionError(f"mesh sphere scores {s_err}, ambiguity gaps {a_err}")
    out["sphere"] = dict(patterns=len(spats), bandwidth=MESH_SPHERE_L,
                         score_max_abs_err=s_err, gap_max_abs_err=a_err)

    # hrebsd_map: the pattern chunks shard.
    ref, spatt, _ = strain_truth(MESH_STRAIN_PATTERNS)
    geom_s = tsim.DetectorGeometry(shape=(STRAIN_SIZE, STRAIN_SIZE))
    hre = {}
    for passes in (0, 1):
        kw = dict(roi_size=STRAIN_ROI, upsample=STRAIN_UPSAMPLE, chunk=STRAIN_CHUNK,
                  remap_iterations=passes)
        h1 = th.hrebsd_map(spatt, ref, geom_s, device="cuda", **kw)
        h4 = th.hrebsd_map(spatt, ref, geom_s, mesh=mesh, **kw)
        hre[f"remap{passes}_a_max_abs_err"] = float(np.abs(h4.a - h1.a).max())
    # Each shard's chunk runs the one-device kernels on fewer rows, so the
    # first pass matches and the remap pass starts from the same `a`.
    if not max(hre.values()) <= STRAIN_A_ATOL:
        raise AssertionError(f"mesh hrebsd_map a {hre}")
    out["hrebsd"] = dict(patterns=len(spatt), **hre)

    # The dynamical master and the Monte Carlo, bit for bit.
    structure = tsim.cubic_structure()
    beams = tsim.dynamical_beams(structure)
    m1 = tsim.dynamical_master_pattern(structure, size=MESH_MASTER_SIZE, beams=beams,
                                       device="cuda")
    m4 = tsim.dynamical_master_pattern(structure, size=MESH_MASTER_SIZE, beams=beams, mesh=mesh)
    kw = dict(n_electrons=MESH_MC_ELECTRONS, chunk=MESH_MC_CHUNK, seed=37)
    mc1 = tsim.simulate_bse_monte_carlo(structure, device="cuda", **kw)
    mc4 = tsim.simulate_bse_monte_carlo(structure, mesh=mesh, **kw)
    if not np.array_equal(m4, m1):
        raise AssertionError(f"mesh master differs: {float(np.abs(m4 - m1).max())}")
    if not (np.array_equal(mc4.exit_energy_kev, mc1.exit_energy_kev)
            and np.array_equal(mc4.max_depth_nm, mc1.max_depth_nm)):
        raise AssertionError("mesh Monte Carlo differs from one device")
    out["master"] = dict(size=MESH_MASTER_SIZE, beams=len(beams.g), bitwise=True)
    out["monte_carlo"] = dict(electrons=MESH_MC_ELECTRONS, chunk=MESH_MC_CHUNK,
                              chunks=-(-MESH_MC_ELECTRONS // MESH_MC_CHUNK), bitwise=True,
                              bse_yield=mc4.bse_yield)
    torch.cuda.empty_cache()
    return out


def phase_mesh(workdir: str, ckpt: str, npz: str) -> dict:
    """Every multi-device path on a mesh that names the card `MESH_SHARDS`
    times (``make_mesh(devices=["cuda:0"] * 4)``), each against the same
    path on one device: DP training (one f32 step held, then
    ``Trainer.fit``), ``IndexPipeline`` over the serve phase's files, the
    sharded search alone over 1,000,000 rows, the indexer, the service,
    pattern DI, Hough, spherical, HR-EBSD, the dynamical master and the
    Monte Carlo, and the CLI flags on one card. With more than one card
    attached the search and the pipeline run again over ``make_mesh()``.
    The launches of the mesh runs (the pipeline, the DP step and the fit)
    are this path's."""
    from latice_tpu_torch.ops import (
        candidate_consensus_fused,
        cosine_topk_fused,
        instance_norm_leaky_relu,
        instance_norm_leaky_relu_backward,
    )
    from latice_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    counters = (instance_norm_leaky_relu, instance_norm_leaky_relu_backward, cosine_topk_fused,
                candidate_consensus_fused)
    mesh = make_mesh(devices=["cuda:0"] * MESH_SHARDS)
    totals = dict.fromkeys((fn.__name__ for fn in counters), 0)

    def add(launches):
        for k, v in launches.items():
            totals[k] += v

    out = dict(mesh=repr(mesh))
    out["dp_step"], launches = _mesh_dp_train(mesh, counters)
    add(launches)
    out["fit"], launches = _mesh_fit(mesh, workdir, counters)
    add(launches)
    out["pipeline"], launches = _mesh_pipeline(mesh, ckpt, npz, counters)
    add(launches)
    out["search"] = _mesh_search(mesh, counters)
    out.update(_mesh_planes(mesh, workdir))
    out["one_card_flags"] = _mesh_one_card_flags(workdir, npz, ckpt)
    if torch.cuda.device_count() > 1:
        cards = make_mesh()
        out["cards"] = dict(mesh=repr(cards), search=_mesh_search(cards, counters),
                            pipeline=_mesh_pipeline(cards, ckpt, npz, counters)[0])
    emit("mesh", **out, launches=totals, phase_s=time.perf_counter() - t_phase)
    return totals


def _rel_dist(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per-row relative L2 distance of ``got`` from ``want``."""
    return (got - want).norm(dim=1) / want.norm(dim=1)


def phase_stage0_path(ckpt: str, npz: str) -> dict:
    """K3 on a path: the pipeline's ``feature_fn`` hook over the serve
    phase's checkpoint and dictionary."""
    from latice_tpu_torch.index import (
        IndexPipeline,
        LatentVectorDatabaseConfig,
        TorchLatentVectorDatabase,
    )
    from latice_tpu_torch.models import load_checkpoint
    from latice_tpu_torch.ops import (
        candidate_consensus_fused,
        cosine_topk_fused,
        fused_stage0_apply,
        instance_norm_leaky_relu,
        stage0_fused,
    )

    model = load_checkpoint(ckpt, INPLANES, LATENT, device="cuda").eval()
    tail = model.encoder[3:]  # stages 1-4: 8 blocks, 4 pools

    def feature_fn(p: torch.Tensor) -> torch.Tensor:
        with torch.autocast("cuda", dtype=torch.bfloat16):
            h = tail(fused_stage0_apply(model.encoder, p[:, None]))
            return model.mu(h.flatten(1)).float()

    db = TorchLatentVectorDatabase(LatentVectorDatabaseConfig(npz_path=npz, dimension=LATENT))
    pipe = IndexPipeline(None, db._vectors, db._orientations, top_n=TOP_N, batch_size=BATCH,
                         engine="fused", device="cuda", feature_fn=feature_fn)
    x = np.random.default_rng(9).integers(0, 256, (STAGE0_PATTERNS, 128, 128), dtype=np.uint8)
    pipe(x[:BATCH])
    torch.cuda.synchronize()
    counters = (stage0_fused, instance_norm_leaky_relu, cosine_topk_fused,
                candidate_consensus_fused)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    res = pipe(x)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    batches = STAGE0_PATTERNS // BATCH
    want = {"stage0_fused": batches, "instance_norm_leaky_relu": 8 * batches,
            "cosine_topk_fused": batches, "candidate_consensus_fused": batches}
    if launches != want:
        raise AssertionError(f"stage0_path launches {launches}, want {want}")
    if res.indices.shape != (STAGE0_PATTERNS, TOP_N) or not np.all(
        np.isfinite(res.best_orientation)
    ):
        raise AssertionError(f"stage0_path result {res.indices.shape}")

    # Each row's latent against the f32 model's, held as train_parity holds
    # a gradient: within twice the 16-mixed model's own distance, plus a floor.
    k3 = torch.from_numpy(pipe.encode(x)).cuda()
    xt = torch.from_numpy(x[:, None]).cuda().float() / 255.0
    with torch.no_grad():
        ref = model.set_precision("32").encode(xt)[0]
        mixed = model.set_precision("16-mixed").encode(xt)[0]
    d_k3, d_mixed = _rel_dist(k3, ref), _rel_dist(mixed, ref)
    share = d_k3 / (GRAD_RATIO * d_mixed + GRAD_FLOOR)
    worst = int(share.argmax())
    emit("stage0_path", patterns=STAGE0_PATTERNS, batches=batches, launches=launches,
         launches_per_batch={k: v / batches for k, v in launches.items()},
         wall_s=wall_s, patterns_per_s=STAGE0_PATTERNS / wall_s,
         worst_share_of_limit=share[worst].item(), worst_row=worst,
         worst_row_k3_rel=d_k3[worst].item(), worst_row_16mixed_rel=d_mixed[worst].item(),
         k3_rel_median=d_k3.median().item(), mixed_rel_median=d_mixed.median().item(),
         success_rows=int(res.success.sum()))
    if not bool(torch.isfinite(k3).all()) or not share[worst].item() <= 1.0:
        raise AssertionError(f"stage0_path latent of row {worst}: {d_k3[worst].item()} from f32, "
                             f"16-mixed {d_mixed[worst].item()}")
    return launches


def phase_index_cli(workdir: str, ckpt: str) -> dict:
    """``cli.index`` build, export and query in this process at full width."""
    import contextlib
    import logging

    from latice_tpu_torch.cli.index import main as index_main
    from latice_tpu_torch.crystal import from_euler_zxz_deg, misorientation_angle
    from latice_tpu_torch.data import read_ang
    from latice_tpu_torch.ops import (
        candidate_consensus_fused,
        cosine_topk_fused,
        instance_norm_leaky_relu,
        stage0_fused,
    )

    root = Path(workdir) / "index_cli"
    root.mkdir()
    pats = np.round(_synthetic_patterns(CLI_DICT, seed=10) * 255.0).astype(np.uint8)
    np.save(root / "dict.npy", pats)
    np.save(root / "query.npy", pats[:CLI_QUERY])
    angles = np.random.default_rng(11).uniform([0, 0, 0], [360, 180, 360], size=(CLI_DICT, 3))
    with open(root / "angles.txt", "w") as f:
        f.write(f"zxz\n{CLI_DICT}\n")
        np.savetxt(f, angles, fmt="%.4f")
    common = ["--checkpoint", ckpt, "--inplanes", str(INPLANES), "--latent-dim", str(LATENT),
              "--batch-size", str(BATCH)]
    dictionary = ["--patterns", str(root / "dict.npy"), "--angles", str(root / "angles.txt")]
    db, out = str(root / "db.npz"), str(root / "orientations.npy")
    commands = {
        "build": ["build", *dictionary, "--db", db],
        "export": ["export", *dictionary, "--latents-out", str(root / "latents.npy"),
                   "--angles-out", str(root / "export_angles.npy")],
        "query": ["query", "--patterns", str(root / "query.npy"), "--db", db, "--out", out,
                  "--engine", "fused", "--ang", str(root / "q.ang"), "--ctf", str(root / "q.ctf"),
                  "--ambiguity", str(root / "amb.npz")],
    }
    encode_batches = {"build": CLI_DICT // BATCH, "export": CLI_DICT // BATCH,
                      "query": CLI_QUERY // BATCH}
    counters = (stage0_fused, instance_norm_leaky_relu, cosine_topk_fused,
                candidate_consensus_fused)
    steps, totals = {}, dict.fromkeys((fn.__name__ for fn in counters), 0)
    for name, argv in commands.items():
        for fn in counters:
            fn.launches = 0
        stdout = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            index_main(argv + common)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        n = encode_batches[name]
        want = {"stage0_fused": 0, "instance_norm_leaky_relu": 10 * n,
                "cosine_topk_fused": n if name == "query" else 0,
                "candidate_consensus_fused": n if name == "query" else 0}
        if launches != want:
            raise AssertionError(f"index_cli {name} launches {launches}, want {want}")
        for k, v in launches.items():
            totals[k] += v
        steps[name] = dict(wall_s=wall_s, launches=launches)
        if name == "query":
            steps[name]["summary"] = json.loads(stdout.getvalue().strip().splitlines()[-1])
    logging.getLogger().setLevel(logging.WARNING)  # the CLI turned INFO on

    with np.load(db) as f:
        vectors, orients = f["vectors"], f["orientations"]
    if vectors.shape != (CLI_DICT, LATENT) or not np.all(np.isfinite(vectors)):
        raise AssertionError(f"index_cli dictionary {vectors.shape}")
    if not np.abs(orients - angles).max() <= 1e-4:
        raise AssertionError("index_cli dictionary orientations are not the angle file's")
    latents = np.load(root / "latents.npy")
    unit = latents / np.linalg.norm(latents, axis=1, keepdims=True)
    export_err = float(np.abs(unit - vectors).max())
    if latents.shape != (CLI_DICT, LATENT) or not export_err <= 1e-5:
        raise AssertionError(f"index_cli export {latents.shape} differs from build by {export_err}")
    # The dictionary's angles are random, so no 18 of 20 candidates agree and
    # every row falls back to its top-1's orientation (re-expressed in f32
    # from its quaternion). That must be its own row's: the nearest other
    # of 16,384 random rotations lies degrees away, the f32 round trip
    # ~1e-4 degrees (misorientation taken in f64 on the host).
    got = np.load(out)
    q_got, q_own = (from_euler_zxz_deg(torch.from_numpy(np.asarray(a, np.float64)))
                    for a in (got, orients[:CLI_QUERY]))
    own_deg = np.rad2deg(misorientation_angle(q_got, q_own).numpy())
    not_own = int((own_deg > 1e-2).sum())
    if got.shape != (CLI_QUERY, 3) or not_own:
        raise AssertionError(f"index_cli query: {not_own} rows whose top-1 is not their own row")
    own_err = float(own_deg.max())
    ang = read_ang(str(root / "q.ang"))
    ang_err = float(np.abs(ang.eulers - got).max())
    if ang.eulers.shape != (CLI_QUERY, 3) or not ang_err <= 1e-3:
        raise AssertionError(f"index_cli .ang reads back {ang.eulers.shape}, {ang_err} off")
    with np.load(root / "amb.npz") as amb:
        n_rival = int(amb["has_rival"].sum())
    emit("index_cli", dict_patterns=CLI_DICT, query_patterns=CLI_QUERY, steps=steps,
         launches=totals, build_patterns_per_s=CLI_DICT / steps["build"]["wall_s"],
         export_patterns_per_s=CLI_DICT / steps["export"]["wall_s"],
         query_patterns_per_s=CLI_QUERY / steps["query"]["wall_s"],
         query_patterns_per_s_in_pipeline=CLI_QUERY / steps["query"]["summary"]["seconds"],
         export_vs_build_max_abs_err=export_err, own_row_max_abs_err_deg=own_err,
         ang_readback_max_abs_err_deg=ang_err, rows_with_rival=n_rival,
         timed_as="host wall of each command in this process, model load and file I/O included")
    return totals


def phase_preprocess(workdir: str, ckpt: str) -> dict:
    """`PREPROCESS_RECIPE` on 256 synthetic patterns, ``static=auto`` taken
    as their mean (`data.estimate_static_background`), on the card against
    the same recipe on the CPU: the stages before equalization within
    `PREPROCESS_ATOL`, and the card's equalization bitwise the CPU's of the
    card's own input (ranks amplify roundoff: two pixels whose values differ
    by an ulp swap places, so full outputs are compared on their input).
    Then ``cli.index query --preprocess`` on the index_cli phase's files:
    10 InstanceNorm launches per batch and 1 top-k launch per batch."""
    import contextlib
    import dataclasses
    import logging

    from latice_tpu_torch.cli.index import main as index_main
    from latice_tpu_torch.data import (
        equalize_histogram,
        estimate_static_background,
        make_preprocess_fn,
        parse_preprocess_spec,
    )
    from latice_tpu_torch.ops import (
        candidate_consensus_fused,
        cosine_topk_fused,
        instance_norm_leaky_relu,
    )

    x = np.round(_synthetic_patterns(PREPROCESS_PATTERNS, seed=13) * 255.0).astype(np.uint8)
    x = x.astype(np.float32) / 255.0
    cfg = parse_preprocess_spec(PREPROCESS_RECIPE)
    cfg = dataclasses.replace(cfg, static_background=estimate_static_background(x))
    full = make_preprocess_fn(cfg)
    before_eq = make_preprocess_fn(dataclasses.replace(cfg, equalize=False))
    xc, xh = torch.from_numpy(x).cuda(), torch.from_numpy(x)
    card_pre = before_eq(xc).cpu()
    pre_err = float((card_pre - before_eq(xh)).abs().max())
    if not pre_err <= PREPROCESS_ATOL:
        raise AssertionError(f"preprocess before equalization: card vs CPU {pre_err}")
    card = full(xc).cpu()
    if not (torch.equal(card, equalize_histogram(card_pre)) and bool(torch.isfinite(card).all())):
        raise AssertionError("preprocess: the card's equalization differs from the CPU's")
    cpu = full(xh)
    t0 = time.perf_counter()
    full(xh)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    card_ms = dict(device_ms=device_busy_ms(lambda: full(xc)),
                   host_ms=host_bound_ms(lambda: full(xc), iters=5),
                   waits_for_device=waits_for_device(lambda: full(xc)))

    root = Path(workdir) / "index_cli"
    out = str(root / "preprocessed.npy")
    argv = ["query", "--patterns", str(root / "query.npy"), "--db", str(root / "db.npz"),
            "--out", out, "--engine", "fused", "--preprocess", PREPROCESS_RECIPE,
            "--checkpoint", ckpt, "--inplanes", str(INPLANES), "--latent-dim", str(LATENT),
            "--batch-size", str(BATCH)]
    counters = (instance_norm_leaky_relu, cosine_topk_fused, candidate_consensus_fused)
    for fn in counters:
        fn.launches = 0
    stdout = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        index_main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    logging.getLogger().setLevel(logging.WARNING)  # the CLI turned INFO on
    launches = {fn.__name__: fn.launches for fn in counters}
    n = CLI_QUERY // BATCH
    want = {"instance_norm_leaky_relu": 10 * n, "cosine_topk_fused": n,
            "candidate_consensus_fused": n}
    if launches != want:
        raise AssertionError(f"preprocess query launches {launches}, want {want}")
    got = np.load(out)
    summary = json.loads(stdout.getvalue().strip().splitlines()[-1])
    if got.shape != (CLI_QUERY, 3) or not np.all(np.isfinite(got)):
        raise AssertionError(f"preprocess query output {got.shape}")
    emit("preprocess", recipe=PREPROCESS_RECIPE, patterns=PREPROCESS_PATTERNS,
         before_equalize_max_abs_err=pre_err, equalize_bitwise=True,
         full_recipe_vs_cpu=dict(max_abs_diff=float((card - cpu).abs().max()),
                                 share_differing=float((card != cpu).float().mean())),
         card_ms=card_ms, cpu_ms=cpu_ms,
         query=dict(patterns=CLI_QUERY, wall_s=wall_s, launches=launches, summary=summary))
    return launches


def _disorientation_deg(a: np.ndarray, b: np.ndarray, group: str = "432",
                        compose: str = "crystal") -> np.ndarray:
    """Disorientation, degrees, in ``group`` (cubic unless given) between
    rows of zxz Euler degrees or quaternions, in f64 on the host, over the
    crystal-side (q ⊗ s) or sample-side (s ⊗ q) images."""
    from latice_tpu_torch.crystal import (
        ROTATION_GROUPS,
        from_euler_zxz_deg,
        symmetry_reduced_misorientation,
    )

    qa, qb = (torch.from_numpy(np.asarray(x, np.float64)) for x in (a, b))
    qa, qb = (from_euler_zxz_deg(q) if q.shape[-1] == 3 else q for q in (qa, qb))
    sym = torch.from_numpy(np.asarray(ROTATION_GROUPS[group], np.float64))
    return np.rad2deg(symmetry_reduced_misorientation(qa, qb, sym=sym, compose=compose).numpy())


def _traced(fn) -> dict:
    """Device busy ms, device activities launched, host wall ms and the
    three longest activities of one call of ``fn`` under the profiler
    (after one untraced call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_kernels(prof)
    top = sorted(kernels, key=lambda k: -k[1])[:3]
    return dict(device_ms=sum(t for _, t, _ in kernels), launches=sum(c for _, _, c in kernels),
                wall_ms=wall_ms, top=[dict(kernel=n[:60], ms=t, calls=c) for n, t, c in top])


def _grain_scan(rng) -> np.ndarray:
    """``(SCAN_SIDE**2, 4)`` unit quaternions of a seeded Voronoi map of
    `SCAN_GRAINS` grains, each at a random orientation, row-major."""
    seeds = rng.uniform(0, SCAN_SIDE, (SCAN_GRAINS, 2))
    yy, xx = np.mgrid[0:SCAN_SIDE, 0:SCAN_SIDE]
    d2 = (yy.reshape(-1, 1) - seeds[:, 0]) ** 2 + (xx.reshape(-1, 1) - seeds[:, 1]) ** 2
    grain_q = rng.normal(size=(SCAN_GRAINS, 4))
    grain_q /= np.linalg.norm(grain_q, axis=1, keepdims=True)
    return grain_q[d2.argmin(axis=1)].astype(np.float32)


def phase_dictionary(workdir: str, ckpt: str, smi: str) -> dict:
    """The native dictionary loop at full width: ``cli.index sample`` (the
    2-degree cubic grid, 18,467 orientations) and ``simulate --uint8`` on
    the card, 256 of its patterns held against the CPU render (also under
    ``torch.set_float32_matmul_precision("high")``); a 64x64 scan of 256
    grains rendered on the card plus seeded noise; NLPAR of the noisy scan,
    its first slab held against the CPU; pattern DI (exact, bf16 search,
    the ``di`` CLI's defaults) of the clean, noisy and denoised scans
    (median disorientation to the truth under 2 degrees; streamed DI equal
    to resident); refinement of 256 clean
    patterns at 40 steps: at the default rate from the truth turned
    `REFINE_TURN_DEG` (the JAX test's bounds), and from the DI result at
    `REFINE_LR` (median under 0.15 degrees; the default rate's reported
    beside it); then ``build``
    of the dictionary with the full-width model and ``query --engine fused
    --nlpar 1 --scan-grid 64 64 --refine 10`` of the noisy scan, whose K2f
    and K1 launches are the path's."""
    from latice_tpu_torch.crystal import from_euler_zxz_deg
    from latice_tpu_torch.data import nlpar_denoise, parse_angle_file
    from latice_tpu_torch.index import (
        PatternDictionaryIndexer,
        StreamedPatternDI,
        build_pattern_dictionary,
    )
    from latice_tpu_torch.ops import (
        candidate_consensus_fused,
        cosine_topk_fused,
        cosine_topk_wide,
        instance_norm_leaky_relu,
    )
    from latice_tpu_torch.serve import IndexService
    from latice_tpu_torch.sim import kinematical, refine_orientations, simulate_patterns

    root = Path(workdir) / "dictionary"
    root.mkdir()
    grid, dict_npy = str(root / "grid.txt"), str(root / "dict.npy")
    out = {}

    # 1-2. The grid and its patterns through the CLI.
    sample = _index_cli(["sample", "--group", DICT_GROUP, "--resolution", str(DICT_RESOLUTION),
                         "--out", grid])
    if sample["summary"]["n_orientations"] != GRID_ROWS:
        raise AssertionError(f"dictionary grid: {sample['summary']}")
    sim = _index_cli(["simulate", "--angles", grid, "--out", dict_npy, "--uint8"])
    card_u8 = np.load(dict_npy)
    if card_u8.shape != (GRID_ROWS, 128, 128) or card_u8.dtype != np.uint8:
        raise AssertionError(f"simulate wrote {card_u8.shape} {card_u8.dtype}")
    angles = parse_angle_file(grid)
    quats = kinematical.orientations_to_quats(angles, angles_in_degrees=True)
    t0 = time.perf_counter()
    simulate_patterns(quats, dtype=np.uint8)
    sim_s = time.perf_counter() - t0
    chunk_trace = _traced(lambda: simulate_patterns(quats[:640], dtype=np.uint8))
    out["simulate"] = dict(patterns=GRID_ROWS, cli=sim, library_s=sim_s,
                           patterns_per_s=GRID_ROWS / sim_s,
                           per_64_chunk=dict(device_ms=chunk_trace["device_ms"] / 10,
                                             launches=chunk_trace["launches"] / 10,
                                             wall_ms=chunk_trace["wall_ms"] / 10,
                                             top=chunk_trace["top"]))

    # The render against the CPU, at PyTorch's default matmul precision and
    # under "high" (TF32 allowed), where the render's own scope must hold.
    hold = np.linspace(0, GRID_ROWS - 1, SIM_HOLD).astype(int)
    cpu = simulate_patterns(quats[hold], device="cpu")
    cpu_u8 = np.round(cpu * 255.0).astype(np.uint8)

    def held(card_f32, card8) -> dict:
        err = float(np.abs(card_f32 - cpu).max())
        diff = np.abs(card8.astype(np.int16) - cpu_u8.astype(np.int16))
        share = float((diff > 0).mean())
        if not (err <= SIM_ATOL and diff.max() <= 1 and share <= SIM_UINT8_SHARE):
            raise AssertionError(f"render vs CPU: {err} f32, uint8 {diff.max()} / {share}")
        return dict(f32_max_abs_err=err, uint8_max_diff=int(diff.max()), uint8_share=share)

    saved = torch.get_float32_matmul_precision()
    renders = {"highest": held(simulate_patterns(quats[hold]), card_u8[hold])}
    try:
        torch.set_float32_matmul_precision("high")
        renders["high"] = held(simulate_patterns(quats[hold]),
                               simulate_patterns(quats[hold], dtype=np.uint8))
        # What the scope prevents: the same render's products in TF32.
        consts = kinematical.model_tensors(kinematical.DetectorGeometry(),
                                           kinematical.cubic_reflectors(), torch.device("cuda"))
        with torch.no_grad():
            unscoped = torch.cat([
                kinematical._render_chunk(torch.from_numpy(quats[hold[i:i + 64]]).cuda(),
                                          *consts, 0.25, False)
                for i in range(0, SIM_HOLD, 64)]).cpu().numpy().reshape(cpu.shape)
        renders["high_unscoped_max_abs_err"] = float(np.abs(unscoped - cpu).max())
    finally:
        torch.set_float32_matmul_precision(saved)
    out["render_vs_cpu"] = renders

    # 3. The scan: grains at random orientations, rendered on the card.
    rng = np.random.default_rng(20)
    truth = _grain_scan(rng)
    clean = simulate_patterns(truth)
    noisy = clean + rng.standard_normal(clean.shape, dtype=np.float32) * SCAN_NOISE
    scan = noisy.reshape(SCAN_SIDE, SCAN_SIDE, 128, 128)

    # 4. NLPAR, timed, its first slab against the CPU.
    t0 = time.perf_counter()
    denoised = nlpar_denoise(scan, h=1.0)
    nlpar_ms = (time.perf_counter() - t0) * 1e3
    nlpar_trace = _traced(lambda: nlpar_denoise(scan, h=1.0))
    # Rows 0-7 of the scan depend on rows 0-9 only (the noise estimate of
    # row 8 reads row 9), so the CPU denoises those ten rows.
    want = nlpar_denoise(scan[:NLPAR_HOLD_ROWS + 2], h=1.0, device="cpu")[:NLPAR_HOLD_ROWS]
    nlpar_err = float(np.abs(denoised[:NLPAR_HOLD_ROWS] - want).max() / np.abs(want).max())
    if not nlpar_err <= NLPAR_RTOL:
        raise AssertionError(f"NLPAR slab vs CPU: relative {nlpar_err}")
    denoised = denoised.reshape(-1, 128, 128)
    out["nlpar"] = dict(scan=[SCAN_SIDE, SCAN_SIDE], h=1.0, radius=1, wall_ms=nlpar_ms,
                        traced=nlpar_trace, slab_vs_cpu_rel_err=nlpar_err,
                        noise_rms=float(np.sqrt(np.mean((noisy - clean) ** 2))),
                        denoised_rms_err=float(np.sqrt(np.mean((denoised - clean) ** 2))))

    # 5. Pattern DI against the dictionary, and the streamed engine.
    t0 = time.perf_counter()
    di = PatternDictionaryIndexer(card_u8, angles, batch_size=BATCH)
    torch.cuda.synchronize()
    di_build_s = time.perf_counter() - t0
    di_out = {}
    cosine_topk_wide.launches = 0
    for name, x in (("clean", clean), ("noisy", noisy), ("denoised", denoised)):
        t0 = time.perf_counter()
        res = di(x)
        wall_ms = (time.perf_counter() - t0) * 1e3
        err = _disorientation_deg(res.best_orientation, truth)
        if not np.median(err) < DI_MEDIAN_MAX_DEG:
            raise AssertionError(f"DI {name}: median {np.median(err)} degrees")
        top1 = _disorientation_deg(angles[res.indices[:, 0]], truth)
        di_out[name] = dict(ms_per_256=wall_ms * BATCH / len(x), median_deg=float(np.median(err)),
                            p90_deg=float(np.quantile(err, 0.9)),
                            top1_median_deg=float(np.median(top1)),
                            success=float(res.success.mean()))
        if name == "clean":
            clean_res = res
    # K5 once a batch on the resident engine; none on the streamed one.
    k5_launches = {"resident": cosine_topk_wide.launches}
    if k5_launches["resident"] != 3 * SCAN_SIDE**2 // BATCH:
        raise AssertionError(f"DI: {k5_launches['resident']} K5 launches for three scans")
    di_trace = _traced(lambda: di(clean[:BATCH]))
    rows = build_pattern_dictionary(card_u8, dtype=torch.bfloat16)
    streamed = StreamedPatternDI(rows, angles, batch_size=BATCH)
    before = cosine_topk_wide.launches
    t0 = time.perf_counter()
    s_res = streamed(clean)
    streamed_ms = (time.perf_counter() - t0) * 1e3
    if cosine_topk_wide.launches != before:
        raise AssertionError("streamed DI launched K5")
    same = (s_res.indices == clean_res.indices).all(axis=1)
    tied = (np.abs(np.diff(clean_res.scores, axis=1)) < NEAR_TIE).any(axis=1)
    if not (same | tied).all():
        raise AssertionError(f"streamed DI: {int((~same & ~tied).sum())} rows differ from resident")
    same_err = _disorientation_deg(s_res.best_orientation[same],
                                   from_euler_zxz_deg(torch.from_numpy(
                                       clean_res.best_orientation[same])).numpy())
    if not same_err.max() < 1e-4:
        raise AssertionError(f"streamed DI orientations {same_err.max()} degrees off resident")
    # The server's DI mode over the same stack: K5 once a batch, the
    # resident indexer's answers.
    service = IndexService(None, None, batch_size=BATCH, di_dictionary=(card_u8, angles),
                           device="cuda")
    before = cosine_topk_wide.launches
    served = service.index(clean[: 2 * BATCH])
    k5_launches["serve"] = cosine_topk_wide.launches - before
    if k5_launches["serve"] != 2 or not np.allclose(
            served["orientations"], clean_res.best_orientation[: 2 * BATCH], atol=1e-4):
        raise AssertionError(f"serve DI: {k5_launches['serve']} K5 launches for two batches, "
                             "or answers other than the resident indexer's")
    out["di"] = dict(dictionary=GRID_ROWS, features=128 * 128, engine="exact",
                     search_dtype="bfloat16", queries=len(clean),
                     build_s=di_build_s,
                     scans=di_out, traced_256=di_trace, k5_launches=k5_launches,
                     streamed=dict(ms_per_256=streamed_ms * BATCH / len(clean),
                                   rows_equal=int(same.sum()), near_tie_rows=int(tied.sum())))
    del di, rows, streamed, service
    torch.cuda.empty_cache()

    # 6. Refinement of clean patterns at 40 steps: at the default rate from
    # the truth turned `REFINE_TURN_DEG` about seeded axes (held to the JAX
    # test's bounds), and from the DI result at the default rate (reported)
    # and at `REFINE_LR` (held).
    from scipy.spatial.transform import Rotation

    pick = np.linspace(0, len(clean) - 1, REFINE_PATTERNS).astype(int)
    axes = rng.normal(size=(REFINE_PATTERNS, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    turn = Rotation.from_rotvec(np.radians(REFINE_TURN_DEG) * axes)
    turned = np.roll((turn * Rotation.from_quat(np.roll(truth[pick], -1, axis=-1))).as_quat(),
                     1, axis=-1).astype(np.float32)
    from_di = from_euler_zxz_deg(torch.from_numpy(
        clean_res.best_orientation[pick].astype(np.float32))).numpy()
    refine = {}
    for name, init, lr in (("turned_default_lr", turned, 2e-3), ("di_default_lr", from_di, 2e-3),
                           ("di_held_lr", from_di, REFINE_LR)):
        err0 = _disorientation_deg(init, truth[pick])
        t0 = time.perf_counter()
        refined, ncc = refine_orientations(clean[pick], init, steps=REFINE_STEPS, lr=lr)
        ms = (time.perf_counter() - t0) * 1e3
        err1 = _disorientation_deg(refined, truth[pick])
        refine[name] = dict(lr=lr, ms_per_64_chunk=ms * 64 / REFINE_PATTERNS,
                            median_deg_before=float(np.median(err0)),
                            median_deg=float(np.median(err1)),
                            p90_deg=float(np.quantile(err1, 0.9)),
                            share_under_bound=float((err1 < REFINE_MEDIAN_MAX_DEG).mean()),
                            share_under_third=float((err1 < err0 / 3).mean()),
                            ncc_min=float(ncc.min()), ncc_median=float(np.median(ncc)))
    at_default = refine["turned_default_lr"]
    if not (at_default["median_deg"] < REFINE_MEDIAN_MAX_DEG
            and at_default["share_under_third"] == 1.0 and at_default["ncc_min"] > REFINE_NCC_MIN):
        raise AssertionError(f"refine from the turned truth at the default rate: {at_default}")
    if not refine["di_held_lr"]["median_deg"] < REFINE_MEDIAN_MAX_DEG:
        raise AssertionError(f"refine from DI: median {refine['di_held_lr']['median_deg']} degrees")
    step_trace = _traced(lambda: refine_orientations(clean[pick[:64]], from_di[:64], steps=5))
    out["refine"] = dict(patterns=REFINE_PATTERNS, steps=REFINE_STEPS, **refine,
                         per_step_5_step_chunk=dict(device_ms=step_trace["device_ms"] / 5,
                                                    launches=step_trace["launches"] / 5,
                                                    wall_ms=step_trace["wall_ms"] / 5,
                                                    top=step_trace["top"]))

    # 7. build and query through the CLI: the path's K2f and K1 launches.
    scan_npy = str(root / "scan_u8.npy")
    np.save(scan_npy, np.round(np.clip(noisy, 0.0, 1.0) * 255.0).astype(np.uint8))
    db, oriented = str(root / "dict_db.npz"), str(root / "orientations.npy")
    common = ["--checkpoint", ckpt, "--inplanes", str(INPLANES), "--latent-dim", str(LATENT),
              "--batch-size", str(BATCH)]
    counters = (instance_norm_leaky_relu, cosine_topk_fused, candidate_consensus_fused)
    for fn in counters:
        fn.launches = 0
    steps = {"build": _index_cli(["build", "--patterns", dict_npy, "--angles", grid, "--db", db]
                                 + common)}
    steps["query"] = _index_cli(["query", "--patterns", scan_npy, "--db", db, "--out", oriented,
                                 "--engine", "fused", "--nlpar", "1", "--scan-grid", str(SCAN_SIDE),
                                 str(SCAN_SIDE), "--refine", "10"] + common)
    launches = {fn.__name__: fn.launches for fn in counters}
    build_batches, query_batches = -(-GRID_ROWS // BATCH), SCAN_SIDE**2 // BATCH
    want_launches = {"instance_norm_leaky_relu": 10 * (build_batches + query_batches),
                     "cosine_topk_fused": query_batches,
                     "candidate_consensus_fused": query_batches}
    if launches != want_launches:
        raise AssertionError(f"dictionary launches {launches}, want {want_launches}")
    got = np.load(oriented)
    summary = steps["query"]["summary"]
    if got.shape != (SCAN_SIDE**2, 3) or not np.all(np.isfinite(got)) or summary.get(
            "refine_steps") != 10:
        raise AssertionError(f"dictionary query: {got.shape}, {summary}")
    with np.load(db) as f:
        if "sim_meta" not in f.files or f["vectors"].shape != (GRID_ROWS, LATENT):
            raise AssertionError("dictionary build lost its provenance or its rows")
    launches["cosine_topk_wide"] = k5_launches["resident"] + k5_launches["serve"]
    emit("dictionary", card=smi, **out, cli=dict(steps=steps, launches=launches),
         timed_as="host wall unless named device_ms (profiler sums of device activity)")
    return launches


def _hold_bands(card, cpu, k: int, rho_bin: float) -> dict:
    """The card's `BandDetection` (top ``k``) against the CPU's (top ``k + 4``)
    on the same frames. Slot by slot, theta and rho must be equal and the
    strength within `BAND_STRENGTH_ATOL`, until the first near tie: a
    strength within `BAND_TIE` of a neighbouring rank's in either list, or a
    card band one bin from the CPU's at the same strength (a plateau that
    roundoff split). From there the order may differ, and each remaining
    card band must lie within one bin of one of the CPU's at the same
    strength. The IQ (the card's mean of its k strengths) is held where no
    tie came into play. Returns the worst readings."""

    def near(t0, r0, s0, t, r, s) -> bool:
        dt = np.abs(t - t0)
        r = np.where(dt > 90.0, -r, r)  # (theta, rho) and (theta -+ 180, -rho): one line
        dt = np.minimum(dt, 180.0 - dt)
        return bool(((dt <= 2.0 + 1e-6) & (np.abs(r - r0) <= rho_bin + 1e-4)
                     & (np.abs(s - s0) <= BAND_TIE)).any())

    tied_patterns, exact_slots, worst_s, worst_iq = 0, 0, 0.0, 0.0
    for i in range(len(card.theta_deg)):
        ct, cr, cs_ = card.theta_deg[i], card.rho_px[i], card.strength[i]
        pt, pr, ps = cpu.theta_deg[i], cpu.rho_px[i], cpu.strength[i]
        event = None
        for j in range(k):
            same = ct[j] == pt[j] and abs(cr[j] - pr[j]) <= 1e-4
            tied = (abs(ps[j] - ps[j + 1]) <= BAND_TIE
                    or (j > 0 and abs(ps[j] - ps[j - 1]) <= BAND_TIE)
                    or (j + 1 < k and abs(cs_[j] - cs_[j + 1]) <= BAND_TIE)
                    or (j > 0 and abs(cs_[j] - cs_[j - 1]) <= BAND_TIE))
            if tied or (not same and near(ct[j], cr[j], cs_[j], pt[j:j + 1], pr[j:j + 1],
                                          ps[j:j + 1])):
                event = j
                break
            if not same:
                raise AssertionError(f"band {j} of pattern {i}: card ({ct[j]}, {cr[j]}), CPU "
                                     f"({pt[j]}, {pr[j]}), no near tie")
            worst_s = max(worst_s, abs(float(cs_[j] - ps[j])))
            exact_slots += 1
        if event is None:  # every slot finite: the IQ is their mean
            worst_iq = max(worst_iq, abs(float(card.iq[i] - ps[:k].mean())))
            continue
        tied_patterns += 1
        for j in range(event, k):
            if not near(ct[j], cr[j], cs_[j], pt, pr, ps):
                raise AssertionError(f"card band {j} of pattern {i} ({ct[j]}, {cr[j]}, "
                                     f"{cs_[j]}) is not among the CPU's")
    if not (worst_s <= BAND_STRENGTH_ATOL and worst_iq <= BAND_STRENGTH_ATOL):
        raise AssertionError(f"band strength {worst_s} or IQ {worst_iq} off the CPU's")
    return dict(patterns=len(card.theta_deg), slots=len(card.theta_deg) * k,
                exact_slots=exact_slots, tied_patterns=tied_patterns,
                strength_max_abs_err=worst_s, iq_max_abs_err=worst_iq,
                strength_atol=BAND_STRENGTH_ATOL, tie=BAND_TIE)


def _hough_accuracy(quats, success, fit_deg, n_matched, truth, group: str = "432") -> dict:
    """Success share, median and largest disorientation to the truth, largest
    fit, fewest matched bands, and the share of patterns within every
    per-pattern bound of the JAX tests (as examples/hough_jax_reference.py
    reads them)."""
    from latice_tpu_torch.crystal import symmetry_quats, symmetry_reduced_misorientation

    a, b = (torch.from_numpy(np.asarray(q, np.float64)) for q in (quats, truth))
    err = np.rad2deg(symmetry_reduced_misorientation(
        a, b, symmetry_quats(group, dtype=torch.float64)).numpy())
    ok = (np.asarray(success) & (err < HOUGH_MAX_DEG) & (np.asarray(fit_deg) < HOUGH_FIT_MAX_DEG)
          & (np.asarray(n_matched) >= HOUGH_MIN_MATCHED))
    return dict(success_rate=float(np.mean(success)), median_deg=float(np.median(err)),
                max_deg=float(err.max()), fit_max_deg=float(np.max(fit_deg)),
                matched_min=int(np.min(n_matched)), within_bounds=float(ok.mean()),
                over_max_deg=int((err >= HOUGH_MAX_DEG).sum()))


def _hold_hough_bounds(name: str, acc: dict, jax_within: float) -> None:
    """tests/index/test_hough_indexing.py::test_orientations_recovered's
    median, and its per-pattern bounds on JAX's share of the patterns."""
    if not (acc["median_deg"] < HOUGH_MEDIAN_MAX_DEG
            and acc["within_bounds"] >= jax_within - HOUGH_SHARE_SLACK):
        raise AssertionError(f"{name}: Hough accuracy {acc}, JAX within bounds {jax_within}")


def phase_bands(workdir: str, ckpt: str, smi: str) -> dict:
    """The band plane and detector calibration at full width. 1,024 fcc
    renders (and a noisy copy), the detector on the card against the CPU on
    256, `HoughIndexer` against the CPU on 64 and held to the JAX tests'
    accuracy over all; the multi-phase fcc + hcp run held to the true phases;
    ``quality``, ``hough --ang`` and ``hough --refine 20`` through the CLI;
    ``query --hough-iq --engine fused`` over index_cli's files, whose K2f and
    K1 launches are the path's; ``calibrate`` (pinned, shared and affine) on
    renders at a known pattern center; ``cli.serve --hough`` with no
    dictionary; and the times of detection, vote, refinement and a
    calibration step."""
    from latice_tpu_torch.cli.serve import build_service, parse_args
    from latice_tpu_torch.data import BandDetector
    from latice_tpu_torch.device import full_f32_matmul
    from latice_tpu_torch.index import HoughIndexer, MultiPhaseHoughIndexer
    from latice_tpu_torch.index.hough_indexing import _index_bands
    from latice_tpu_torch.ops import (
        candidate_consensus_fused,
        cosine_topk_fused,
        instance_norm_leaky_relu,
    )
    from latice_tpu_torch.serve import make_server
    from latice_tpu_torch.sim import (
        DetectorGeometry,
        calibrate_geometry,
        cubic_reflectors,
        hexagonal_reflectors,
        simulate_patterns,
    )

    root = Path(workdir) / "bands"
    root.mkdir()
    out = {}

    # 1. The renders, on the card.
    fcc, hcp = cubic_reflectors(), hexagonal_reflectors(**HCP)
    truth = _bands_truth(BANDS_PATTERNS, BANDS_SEEDS["fcc"])
    clean = simulate_patterns(truth, reflectors=fcc)
    noise = np.random.default_rng(BANDS_SEEDS["noise"]).standard_normal(clean.shape,
                                                                        dtype=np.float32)
    noisy = clean + noise * BANDS_NOISE
    q_f = _bands_truth(MULTI_PER_PHASE, BANDS_SEEDS["multi_fcc"])
    q_h = _bands_truth(MULTI_PER_PHASE, BANDS_SEEDS["multi_hcp"])
    mixed = np.concatenate([simulate_patterns(q_f, reflectors=fcc),
                            simulate_patterns(q_h, reflectors=hcp)])

    # 2. The detector on the card against the CPU (quality's 10 bands).
    t0 = time.perf_counter()
    det = BandDetector()
    det_build_s = time.perf_counter() - t0
    card = det(clean[:BANDS_HOLD])
    cpu = BandDetector(k=14, device="cpu")(clean[:BANDS_HOLD])
    out["detector_vs_cpu"] = _hold_bands(card, cpu, 10, det.rho_scale)
    iq_clean, iq_noisy = float(det(clean).iq.mean()), float(det(noisy).iq.mean())
    if not iq_clean > iq_noisy:
        raise AssertionError(f"noise did not lower the IQ: {iq_clean} vs {iq_noisy}")
    out["iq_mean"] = dict(clean=iq_clean, noisy=iq_noisy)

    # 3. HoughIndexer: 64 against the CPU, all 1,024 held to the JAX bounds.
    t0 = time.perf_counter()
    ix = HoughIndexer(fcc)
    torch.cuda.synchronize()
    ix_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = ix(clean)
    hough_s = time.perf_counter() - t0
    acc = _hough_accuracy(res.quaternions, res.success, res.fit_deg, res.n_matched, truth)
    _hold_hough_bounds("hough", acc, JAX_HOUGH_WITHIN)
    cpu_ix = HoughIndexer(fcc, batch_size=HOUGH_HOLD, device="cpu")
    held = cpu_ix(clean[:HOUGH_HOLD])
    same_bands = np.all(held.bands.theta_deg[:, :8] == res.bands.theta_deg[:HOUGH_HOLD, :8],
                        axis=1) & np.all(np.abs(held.bands.rho_px[:, :8]
                                                - res.bands.rho_px[:HOUGH_HOLD, :8]) < 1e-4,
                                         axis=1)
    dev = _disorientation_deg(res.quaternions[:HOUGH_HOLD], held.quaternions)
    if not dev[same_bands].max(initial=0.0) < HOUGH_HOLD_DEG:
        raise AssertionError(f"Hough card vs CPU: {dev[same_bands].max()} degrees")
    if not (res.success[:HOUGH_HOLD] == held.success).all():
        raise AssertionError("Hough success differs from the CPU's")
    nres = ix(noisy)
    noisy_acc = _hough_accuracy(nres.quaternions, nres.success, nres.fit_deg, nres.n_matched,
                                truth)
    out["hough"] = dict(patterns=BANDS_PATTERNS, build_s=ix_build_s, detector_build_s=det_build_s,
                        wall_s=hough_s, patterns_per_s=BANDS_PATTERNS / hough_s, **acc,
                        jax_within_bounds=JAX_HOUGH_WITHIN, noisy=noisy_acc,
                        vs_cpu=dict(patterns=HOUGH_HOLD, same_bands=int(same_bands.sum()),
                                    max_deg_same_bands=float(dev[same_bands].max(initial=0.0)),
                                    max_deg=float(dev.max()), tolerance_deg=HOUGH_HOLD_DEG))

    # 4. Multi-phase: every pattern in its true phase.
    mp = MultiPhaseHoughIndexer([(fcc, "432"), (hcp, "622")], n_bands=MULTI_BANDS,
                                detector=BandDetector(k=MULTI_BANDS))
    t0 = time.perf_counter()
    mres = mp(mixed)
    multi_s = time.perf_counter() - t0
    phase_truth = np.repeat([0, 1], MULTI_PER_PHASE)
    wrong = int((mres.phase != phase_truth).sum())
    multi = dict(patterns=len(mixed), wall_s=multi_s, phase_wrong=wrong,
                 jax_phase_wrong=JAX_MULTI_PHASE_WRONG)
    for pid, (group, q) in enumerate((("432", q_f), ("622", q_h))):
        m = phase_truth == pid
        multi[group] = _hough_accuracy(mres.quaternions[m], mres.success[m], mres.fit_deg[m],
                                       mres.n_matched[m], q, group)
        _hold_hough_bounds(f"multi-phase {group}", multi[group], JAX_MULTI_WITHIN[group])
    # test_phase_discrimination_and_accuracy wants every phase right; JAX
    # itself misplaces 15 of these 512.
    if wrong > JAX_MULTI_PHASE_WRONG + HOUGH_SHARE_SLACK * len(mixed):
        raise AssertionError(f"multi-phase: {wrong} patterns in the wrong phase (JAX: "
                             f"{JAX_MULTI_PHASE_WRONG})")
    out["multi_phase"] = multi
    del mp
    torch.cuda.empty_cache()

    # 5. The CLI: quality, hough --ang, hough --refine 20.
    pats = str(root / "fcc_u8.npy")
    np.save(pats, np.round(clean * 255.0).astype(np.uint8))
    steps = {"quality": _index_cli(["quality", "--patterns", pats, "--scan-grid", "32", "32",
                                    "--out-prefix", str(root / "q")])}
    qiq = np.load(root / "q_iq.npy")
    if qiq.shape != (32, 32) or not np.all(np.isfinite(qiq)):
        raise AssertionError(f"quality IQ map {qiq.shape}")
    steps["hough"] = _index_cli(["hough", "--patterns", pats, "--out", str(root / "h.npy"),
                                 "--ang", str(root / "h.ang"), "--scan-grid", "32", "32"])
    steps["hough_refine"] = _index_cli(["hough", "--patterns", pats, "--out", str(root / "r.npy"),
                                        "--refine", "20"])
    raw_err = _disorientation_deg(np.load(root / "h.npy"), truth)
    ref_err = _disorientation_deg(np.load(root / "r.npy"), truth)
    if not np.median(ref_err) < np.median(raw_err):
        raise AssertionError(f"hough --refine median {np.median(ref_err)} did not beat the raw "
                             f"{np.median(raw_err)}")
    from latice_tpu_torch.data import read_ang

    ang = read_ang(str(root / "h.ang"))
    with np.load(root / "h_detail.npz") as f:
        h_success = f["success"]
    if ang.grid != (32, 32) or not (ang.success == h_success).all():
        raise AssertionError("hough .ang: grid or success column")
    out["cli"] = dict(steps=steps, raw_median_deg=float(np.median(raw_err)),
                      refined_median_deg=float(np.median(ref_err)))

    # 6. query --hough-iq on index_cli's files: the path's K2f and K1 launches.
    cli_root = Path(workdir) / "index_cli"
    counters = (instance_norm_leaky_relu, cosine_topk_fused, candidate_consensus_fused)
    for fn in counters:
        fn.launches = 0
    qout = str(root / "query.npy")
    query = _index_cli(["query", "--patterns", str(cli_root / "query.npy"), "--db",
                        str(cli_root / "db.npz"), "--out", qout, "--engine", "fused", "--hough-iq",
                        "--ang", str(root / "query.ang"), "--checkpoint", ckpt, "--inplanes",
                        str(INPLANES), "--latent-dim", str(LATENT), "--batch-size", str(BATCH)])
    launches = {fn.__name__: fn.launches for fn in counters}
    batches = CLI_QUERY // BATCH
    want = {"instance_norm_leaky_relu": 10 * batches, "cosine_topk_fused": batches,
            "candidate_consensus_fused": batches}
    if launches != want:
        raise AssertionError(f"query --hough-iq launches {launches}, want {want}")
    raw = np.load(cli_root / "query.npy")
    direct = det(raw).iq
    qiq = np.load(query["summary"]["hough_iq_out"])
    if not np.array_equal(qiq, direct):
        raise AssertionError(f"query --hough-iq IQ differs from the detector's by "
                             f"{np.abs(qiq - direct).max()}")
    out["query_hough_iq"] = dict(patterns=CLI_QUERY, wall_s=query["wall_s"], launches=launches,
                                 mean_iq=query["summary"]["mean_iq"])

    # 7. calibrate at 128x128: pinned shared and affine fits through the CLI.
    cal_q = _bands_truth(CAL_PATTERNS, BANDS_SEEDS["calibrate"])
    pc_true = np.array(CAL_PC_TRUE)
    shared = simulate_patterns(cal_q, DetectorGeometry(pcx=pc_true[0], pcy=pc_true[1],
                                                       dd=pc_true[2]), fcc)
    g_true = np.array(CAL_GRADIENT)
    rows, cols = CAL_GRID
    rr, cc = np.divmod(np.arange(rows * cols), cols)
    scan = np.stack([simulate_patterns(cal_q[i:i + 1], DetectorGeometry(
        **dict(zip(("pcx", "pcy", "dd"), pc_true + g_true @ (cc[i], rr[i])))), fcc)[0]
        for i in range(rows * cols)])
    np.save(root / "cal_q.npy", cal_q)
    np.save(root / "cal_shared.npy", shared)
    np.save(root / "cal_scan.npy", scan)
    cal = {}
    for name, pats_npy, extra in (("shared", "cal_shared.npy", []),
                                  ("affine", "cal_scan.npy", ["--scan-grid", str(rows), str(cols)])):
        res_cli = _index_cli(["calibrate", "--patterns", str(root / pats_npy), "--orientations",
                              str(root / "cal_q.npy"), "--out", str(root / f"cal_{name}.npz"),
                              "--pin", "--steps", str(CAL_STEPS)] + extra)
        with np.load(root / f"cal_{name}.npz") as f:
            fit = {k: f[k] for k in f.files}
        if name == "shared":
            err = np.abs(fit["pc"] - pc_true)
            if not (err[0] < 2e-3 and err[1] < 2e-3 and err[2] < 3e-3):
                raise AssertionError(f"calibrate shared: PC {fit['pc']}, off by {err}")
            cal[name] = dict(pc=fit["pc"].tolist(), err=err.tolist())
        else:
            span = np.array([cols - 1, rows - 1], np.float64)
            pc0_err = float(np.abs(fit["pc0"] - pc_true).max())
            g_err = float((np.abs(fit["gradient"] - g_true) * span).max())
            if not (pc0_err < 1e-5 and g_err < 1e-5 and res_cli["summary"]["mean_ncc"] > 0.999):
                raise AssertionError(f"calibrate affine: pc0 {pc0_err}, gradient {g_err}, "
                                     f"{res_cli['summary']}")
            cal[name] = dict(pc0=fit["pc0"].tolist(), pc0_err=pc0_err, gradient_span_err=g_err)
        cal[name].update(wall_s=res_cli["wall_s"], mean_ncc=res_cli["summary"]["mean_ncc"],
                         steps=CAL_STEPS)
    step_trace = _traced(lambda: calibrate_geometry(shared, cal_q, DetectorGeometry(), fcc,
                                                    steps=5))
    cal["per_step"] = dict(device_ms=step_trace["device_ms"] / 5,
                           launches=step_trace["launches"] / 5,
                           wall_ms=step_trace["wall_ms"] / 5, top=step_trace["top"])
    out["calibrate"] = cal

    # 8. cli.serve --hough with no dictionary: /healthz, /quality, /hough.
    service = build_service(parse_args(["--hough"]))
    warm_s = service.warmup()
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    x = np.round(clean[:BATCH] * 255.0).astype(np.uint8)
    try:
        health = _request(f"{url}/healthz")
        if health["mode"] != "zero-training" or health["planes"] != ["hough"]:
            raise AssertionError(f"zero-training /healthz: {health}")
        t0 = time.perf_counter()
        quality = _request(f"{url}/quality", _npy(x))
        quality_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        hough = _request(f"{url}/hough", _npy(x))
        hough_req_s = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if quality["iq"] != det(x).iq.tolist():
        raise AssertionError("/quality differs from the detector")
    direct = HoughIndexer(fcc)(x)
    if not (hough["orientations"] == direct.eulers_deg.tolist()
            and hough["success"] == direct.success.tolist()):
        raise AssertionError("/hough differs from a direct HoughIndexer call")
    out["serve"] = dict(warmup_s=warm_s, quality_s=quality_s, hough_s=hough_req_s,
                        patterns=BATCH, health=dict(mode=health["mode"], planes=health["planes"]))
    del service

    # 9. Times per batch of 256: detection (and the product's alternatives),
    # vote, refinement.
    xb = torch.from_numpy(clean[:BATCH]).cuda()
    v = torch.randn((BATCH, 128 * 128), device="cuda")
    a16 = det._a
    a32 = a16.float()
    products = {
        "bf16_gemm_f32_out": lambda: torch.mm(v.bfloat16(), a16, out_dtype=torch.float32),
        "widened_f32_sgemm": lambda: v.bfloat16().float() @ a16.float(),
        "resident_f32_sgemm": lambda: v.bfloat16().float() @ a32,
    }
    ref = products["bf16_gemm_f32_out"]()
    saved_tf32 = torch.backends.cuda.matmul.allow_tf32
    product_ms = {}
    try:
        for name, fn in products.items():
            product_ms[name] = cuda_ms(fn)
            product_ms[name + "_max_abs_err"] = float((fn() - ref).abs().max())
        torch.backends.cuda.matmul.allow_tf32 = True
        product_ms["resident_tf32"] = cuda_ms(products["resident_f32_sgemm"])
        product_ms["resident_tf32_max_abs_err"] = float(
            (products["resident_f32_sgemm"]() - ref).abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved_tf32
    del a32
    n_bytes = a16.numel() * 2 + BATCH * 128 * 128 * 4 + BATCH * 10 * 4 * 5
    n_ops = 2.0 * BATCH * a16.shape[0] * a16.shape[1]
    bound, by = bound_ms(n_bytes, n_ops, PEAK_BF16_PER_S)
    # Few calls per timing: each call is tens to hundreds of launches, and
    # the spin must outlast their enqueueing with the launch queue unfilled.
    detect = dict(ms=cuda_ms(lambda: det._run(xb), iters=4),
                  traced=_traced(lambda: det(clean[:BATCH])),
                  bound_ms=bound, bound_by=by, products=product_ms)
    _, normals, weights = ix.detect_bands(clean[:BATCH])
    nrm = torch.from_numpy(normals.astype(np.float32)).cuda()
    wts = torch.from_numpy(weights.astype(np.float32)).cuda()
    consts = (ix._grid_q, ix._grid_normals, ix._refl, ix._refl_i)
    knobs = dict(tol_rad=ix.tol_rad, vote_tol_rad=ix.vote_tol_rad, top_p=ix.top_p,
                 m_valid=ix.m_valid, i_weight=ix.i_weight, grid_chunk=ix.grid_chunk)

    def solve(iters):
        with torch.inference_mode(), full_f32_matmul():
            return _index_bands(nrm, wts, *consts, refine_iters=iters, **knobs)

    vote_only, full = _traced(lambda: solve(0)), _traced(lambda: solve(ix.refine_iters))
    vote_ms = cuda_ms(lambda: solve(0), iters=1, warmup=1)
    full_ms = cuda_ms(lambda: solve(ix.refine_iters), iters=1, warmup=1)
    # The (B, 8, rows, K) dot tensor written once and read once; 3 FMAs,
    # an abs and a max per element.
    elements = BATCH * 8 * ix._grid_normals.shape[0] * ix._refl.shape[0]
    vote_bound, vote_by = bound_ms(2 * 4 * elements, 8 * elements)
    out["per_batch_256"] = dict(
        detection=detect,
        vote=dict(ms=vote_ms, traced=vote_only, grid_rows=ix.m_valid,
                  chunks=ix._grid_normals.shape[0] // ix.grid_chunk,
                  vote_tensor_gb=4 * elements / 1e9, bound_ms=vote_bound, bound_by=vote_by),
        refinement=dict(ms=full_ms - vote_ms,
                        device_ms=full["device_ms"] - vote_only["device_ms"],
                        launches=full["launches"] - vote_only["launches"],
                        wall_ms=full["wall_ms"] - vote_only["wall_ms"]))
    emit("bands", card=smi, **out,
         timed_as="host wall unless named ms (CUDA events) or device_ms (profiler sums)")
    return launches


def _events_s(fn) -> tuple[float, object]:
    """Seconds between CUDA events recorded around one call of ``fn`` (which
    returns host arrays, so the end event follows its last device work)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3, result


def _hold_sphere_readings(name: str, got: dict, want: dict) -> None:
    """The card's accuracy against the JAX package's on the same inputs:
    the median no more than `SPHERE_MEDIAN_SLACK_DEG` above, each share
    within 1/2/4 degrees no more than `SPHERE_SHARE_SLACK` below."""
    if not got["median_deg"] <= want["median_deg"] + SPHERE_MEDIAN_SLACK_DEG:
        raise AssertionError(f"sphere {name}: median {got['median_deg']} degrees, JAX "
                             f"{want['median_deg']}")
    for d in (1, 2, 4):
        key = f"within_{d}deg"
        if not got[key] >= want[key] - SPHERE_SHARE_SLACK:
            raise AssertionError(f"sphere {name}: {key} {got[key]}, JAX {want[key]}")


_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaMemcpyAsync", "cudaMemsetAsync")


def _traced_stage(fn, calls: int = 3) -> dict:
    """Device busy ms (profiler sums of its kernel records) and launches (the
    runtime API's launch calls, counted on the host side of the same trace)
    per call of ``fn``, over ``calls`` calls in one trace after one untraced
    call. The launch calls are counted because a short trace can end before
    some kernel records reach it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    launches = sum(1 for e in prof.events() if e.name in _LAUNCH_CALLS)
    return dict(device_ms=sum(t for _, t, _ in _device_kernels(prof)) / calls,
                launches=launches / calls)


def _stage_ms(fn) -> dict:
    """Milliseconds per call of ``fn``: device time from CUDA events with
    the stream held while the host enqueues, or, for a call that waits for
    the device itself, the host-paced time between events."""
    if waits_for_device(fn):
        return dict(ms=host_bound_ms(fn, iters=5), ms_timed_as="host-paced")
    return dict(ms=cuda_ms(fn, iters=5, warmup=1), ms_timed_as="device")


def _sphere_stages(ix, pc: torch.Tensor) -> dict:
    """Device ms (CUDA events), launches and device busy ms (profiler) of each
    stage of one chunk, and each stage's bound with its counts: the bytes of
    its operands and results read or written once and its operations at the
    bf16 tensor-core peak (argmax and Newton: f32)."""
    from latice_tpu_torch.index import spherical as sp

    dev, bin_f = ix._dev, ix.config.detector_bin
    k_n, a_n = dev["k_n"], dev["a_n"]
    b = pc.shape[0]
    n_m = dev["br"].shape[0]
    with torch.inference_mode():
        xcn = sp._normalize(pc, dev["wvec"], bin_f)
        f = sp._project(xcn, dev["yt"], n_m)
        w16 = sp._l_contract(f, dev["br"], dev["bi"], False)
        w32 = sp._l_contract(f, dev["br"], dev["bi"], True)
        t2 = sp._alpha_dft(w16, dev["cct"], k_n)
        x32 = sp._gamma_dft(t2, dev["cgs"], b, k_n, True)
        x16 = sp._gamma_dft(t2, dev["cgs"], b, k_n, False)
        _, k, a, g = sp._grid_peak(x16)
    rows, d = dev["yt"].shape
    kv = dev["br"].shape[2]
    two_l = 2 * n_m
    v = kv // k_n
    el = lambda t: t.numel() * t.element_size()  # noqa: E731
    stages = {
        "projection": (lambda: sp._project(sp._normalize(pc, dev["wvec"], bin_f), dev["yt"], n_m),
                       el(pc) + el(dev["yt"]) + el(f), 2.0 * rows * d * b, PEAK_BF16_PER_S),
        "l_contraction": (lambda: sp._l_contract(f, dev["br"], dev["bi"], False),
                          el(f) + el(dev["br"]) + el(dev["bi"]) + el(w16),
                          2.0 * 2 * n_m * b * dev["br"].shape[1] * kv, PEAK_BF16_PER_S),
        "l_contraction_f32_out": (lambda: sp._l_contract(f, dev["br"], dev["bi"], True),
                                  el(f) + el(dev["br"]) + el(dev["bi"]) + el(w32),
                                  2.0 * 2 * n_m * b * dev["br"].shape[1] * kv, PEAK_BF16_PER_S),
        "alpha_dft": (lambda: sp._alpha_dft(w16, dev["cct"], k_n),
                      el(w16) + el(dev["cct"]) + el(t2), 2.0 * 2 * b * k_n * a_n * two_l * v,
                      PEAK_BF16_PER_S),
        "alpha_dft_from_f32": (lambda: sp._alpha_dft(w32, dev["cct"], k_n),
                               el(w32) + el(dev["cct"]) + el(t2),
                               2.0 * 2 * b * k_n * a_n * two_l * v, PEAK_BF16_PER_S),
        "gamma_dft": (lambda: sp._gamma_dft(t2, dev["cgs"], b, k_n, True),
                      el(t2) + el(dev["cgs"]) + el(x32), 2.0 * b * k_n * a_n * 2 * v * a_n,
                      PEAK_BF16_PER_S),
        "gamma_dft_bf16_out": (lambda: sp._gamma_dft(t2, dev["cgs"], b, k_n, False),
                               el(t2) + el(dev["cgs"]) + el(x16),
                               2.0 * b * k_n * a_n * 2 * v * a_n, PEAK_BF16_PER_S),
        "argmax": (lambda: sp._grid_peak(x32), el(x32), float(x32.numel()), PEAK_FP32_PER_S),
        "argmax_bf16": (lambda: sp._grid_peak(x16), el(x16), float(x16.numel()),
                        PEAK_FP32_PER_S),
        "neighborhood": (lambda: sp._neighborhood(x32, k, a, g), 27 * 4 * b, 27.0 * b,
                         PEAK_FP32_PER_S),
        # 9 evaluations of value, gradient and Hessian over (b, 3, L, ν):
        # ~40 operations per term, the 5 f32 rows of each pattern read once.
        "newton": (lambda: sp._newton(w32, k, a, g, k_n, a_n, ix.config.newton_steps),
                   2 * 5 * b * n_m * v * 4, 9 * 40.0 * b * 3 * n_m * v, PEAK_FP32_PER_S),
    }
    out = {}
    with torch.inference_mode():
        for name, (fn, n_bytes, n_ops, peak_ops) in stages.items():
            bound, by = bound_ms(n_bytes, n_ops, peak_ops)
            out[name] = dict(**_stage_ms(fn), **_traced_stage(fn), bound_ms=bound, bound_by=by,
                             bytes=n_bytes, ops=n_ops)
        for mode in ("grid", "newton"):
            fn = lambda m=mode: sp._correlate_chunk(pc, dev, bin_f, m, ix.config.newton_steps)  # noqa: E731
            tr = _traced(fn)
            out[f"chunk_{mode}"] = dict(**_stage_ms(fn), **_traced_stage(fn),
                                        wall_ms=tr["wall_ms"], top=tr["top"])
    # The whole chunk read once and written once (tables and patterns in,
    # one peak per pattern out) against all its products at the bf16 peak;
    # and the staged bound, each intermediate written once and read once.
    tables = sum(el(dev[key]) for key in ("yt", "br", "bi", "cct", "cgs"))
    ops = sum(stages[s][2] for s in ("projection", "l_contraction", "alpha_dft", "gamma_dft"))
    whole, whole_by = bound_ms(tables + el(pc), ops, PEAK_BF16_PER_S)
    staged = sum(out[s]["bound_ms"] for s in ("projection", "l_contraction", "alpha_dft",
                                              "gamma_dft", "argmax"))
    out["chunk_bound"] = dict(bound_ms=whole, bound_by=whole_by, bytes=tables + el(pc), ops=ops,
                              staged_bound_ms=staged, volume_mb=el(x32) / 1e6,
                              t2_mb=el(t2) / 1e6, w_mb=el(w16) / 1e6, tables_mb=tables / 1e6)
    return out


def phase_sphere(workdir: str, ckpt: str, smi: str) -> dict:
    """The master-pattern plane and spherical indexing at full width (master
    513, 128x128, L=64, bin 2, chunk 64, 432, Newton 8 steps): 1,024 fcc
    renders on the card against the CPU's; `SphericalIndexer` in the grid,
    parabolic and Newton modes, timed, split by stage per chunk with each
    stage's bound, held to the JAX package's accuracy on the same inputs
    (examples/sphere_jax_reference.py) and per pattern to the port's CPU
    path on 64; the ambiguity diagnostic on 256 and the multi-phase fcc +
    hcp run, both held to JAX's; then the CLI (``simulate --master
    --fit-bands`` over the 2-degree grid, ``build`` and ``query --engine
    fused --refine 10`` of 4,096, whose K2f and K1 launches are the path's;
    ``learn-master`` from 4,096 renders; ``sphere --ang`` of 1,024) and a
    ``cli.serve --sphere-master`` server's ``/sphere`` of 256 with and
    without ``?ambiguity=1``. One Wigner table is built: the library
    indexers share `projection_tables`, and the CLI and the server read it
    from the port's value-transparent cache in this run's directory."""
    import dataclasses
    import os

    from latice_tpu_torch.cli.serve import build_service, parse_args
    from latice_tpu_torch.crystal import write_anglefile
    from latice_tpu_torch.data import parse_angle_file, read_ang
    from latice_tpu_torch.index import (
        MultiPhaseSphericalIndexer,
        SphericalIndexer,
        SphericalIndexerConfig,
    )
    from latice_tpu_torch.index.spherical import projection_tables
    from latice_tpu_torch.ops import (
        candidate_consensus_fused,
        cosine_topk_fused,
        instance_norm_leaky_relu,
    )
    from latice_tpu_torch.serve import make_server
    from latice_tpu_torch.sim import (
        DetectorGeometry,
        hexagonal_reflectors,
        make_kinematical_master,
        render_from_master,
    )

    root = Path(workdir) / "sphere"
    root.mkdir()
    os.environ["LATICE_TPU_TORCH_SHT_CACHE"] = str(root / "sht_cache")
    out = {}

    # 1. The master and 1,024 renders on the card, against the CPU's.
    t0 = time.perf_counter()
    fcc = make_kinematical_master(size=SPHERE_MASTER)
    hcp = make_kinematical_master(size=SPHERE_MASTER, reflectors=hexagonal_reflectors(**HCP))
    master_s = time.perf_counter() - t0
    truth = _bands_truth(SPHERE_PATTERNS, SPHERE_SEEDS["fcc"])
    render_from_master(fcc, truth[:64])  # first call: allocations
    render_s, pats = _events_s(lambda: render_from_master(fcc, truth))
    cpu = render_from_master(fcc, truth, device="cpu")
    render_err = float(np.abs(pats - cpu).max())
    if not render_err <= SPHERE_RENDER_ATOL:
        raise AssertionError(f"render_from_master card vs CPU: {render_err}")
    render_tr = _traced(lambda: render_from_master(fcc, truth[:256]))
    out["render"] = dict(patterns=SPHERE_PATTERNS, s=render_s,
                         patterns_per_s=SPHERE_PATTERNS / render_s, master_s=master_s,
                         max_abs_err_vs_cpu=render_err, tolerance=SPHERE_RENDER_ATOL,
                         per_256=dict(device_ms=render_tr["device_ms"],
                                      launches=render_tr["launches"],
                                      wall_ms=render_tr["wall_ms"], top=render_tr["top"]))
    del cpu

    # 2. The indexer in its three modes, over one shared table build.
    t0 = time.perf_counter()
    tables = projection_tables(SPHERE_L, DetectorGeometry(), SPHERE_BIN)
    tables_s = time.perf_counter() - t0
    cfg = SphericalIndexerConfig(bandwidth=SPHERE_L, detector_bin=SPHERE_BIN, chunk=SPHERE_CHUNK)
    refine = dict(grid=False, parabolic="parabolic", newton="newton")
    modes = {}
    for mode in SPHERE_MODES:
        t0 = time.perf_counter()
        ix = SphericalIndexer(fcc, None, dataclasses.replace(cfg, refine=refine[mode]),
                              tables=tables)
        setup_s = time.perf_counter() - t0
        ix.index_patterns(pats[:SPHERE_CHUNK])  # first call: allocations
        s, res = _events_s(lambda: ix.index_patterns(pats))
        readings = sphere_readings(_disorientation_deg(res.quaternions, truth))
        _hold_sphere_readings(mode, readings, JAX_SPHERE[mode])
        modes[mode] = dict(ix=ix, res=res)
        out[mode] = dict(s=s, patterns_per_s=SPHERE_PATTERNS / s, setup_s=setup_s, **readings,
                         mean_score=float(res.scores.mean()), jax=JAX_SPHERE[mode])
    newton = modes["newton"]["ix"]
    out["tables"] = dict(build_s=tables_s, kept_degrees=len(newton._l_keep),
                         memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    pc = torch.from_numpy(pats[:SPHERE_CHUNK]).cuda()
    out["per_chunk_64"] = _sphere_stages(newton, pc)
    del pc

    # 3. Per pattern, the card against the port's CPU path at L=64 (f32
    # tables and products there, bf16 tables here).
    hold = {}
    for mode in SPHERE_MODES:
        cpu_ix = SphericalIndexer(fcc, None, dataclasses.replace(cfg, refine=refine[mode]),
                                  tables=tables, device="cpu")
        t0 = time.perf_counter()
        cres = cpu_ix.index_patterns(pats[:SPHERE_HOLD])
        cpu_s = time.perf_counter() - t0
        card = modes[mode]["res"]
        dev = _disorientation_deg(card.quaternions[:SPHERE_HOLD], cres.quaternions)
        dscore = np.abs(card.scores[:SPHERE_HOLD] - cres.scores)
        hold[mode] = dict(patterns=SPHERE_HOLD, cpu_s=cpu_s, max_deg=float(dev.max()),
                          median_deg=float(np.median(dev)),
                          beyond_tolerance=int((dev > SPHERE_HOLD_DEG).sum()),
                          max_score_diff=float(dscore.max()), tolerance_deg=SPHERE_HOLD_DEG,
                          score_tolerance=SPHERE_SCORE_ATOL)
        if hold[mode]["beyond_tolerance"] > SPHERE_HOLD_OUTLIERS or not (
                dscore.max() <= SPHERE_SCORE_ATOL):
            raise AssertionError(f"sphere {mode} card vs CPU: {hold[mode]}")
        if mode == "newton":
            camb = cpu_ix.ambiguity(pats[:SPHERE_HOLD], n_cells=SPHERE_AMB_CELLS)
        del cpu_ix
    out["vs_cpu"] = hold

    # 4. The ambiguity diagnostic (JAX's γ-first ranking) and multi-phase.
    amb_s, amb = _events_s(lambda: newton.ambiguity(pats[:SPHERE_AMBIGUITY],
                                                     n_cells=SPHERE_AMB_CELLS))
    gap = amb.score_gap[amb.has_rival]
    amb_read = dict(has_rival=float(amb.has_rival.mean()), median_gap=float(np.median(gap)),
                    median_angle_deg=float(np.median(amb.angle_deg[amb.has_rival])),
                    ambiguous=float(amb.ambiguous().mean()))
    want = JAX_SPHERE["ambiguity"]
    if not (abs(amb_read["has_rival"] - want["has_rival"]) <= SPHERE_SHARE_SLACK
            and abs(amb_read["median_gap"] - want["median_gap"]) <= SPHERE_GAP_ATOL
            and abs(amb_read["ambiguous"] - want["ambiguous"]) <= SPHERE_SHARE_SLACK):
        raise AssertionError(f"sphere ambiguity {amb_read}, JAX {want}")
    both = amb.has_rival[:SPHERE_HOLD] & camb.has_rival
    gap_dev = np.abs(amb.score_gap[:SPHERE_HOLD][both] - camb.score_gap[both])
    out["ambiguity"] = dict(patterns=SPHERE_AMBIGUITY, s=amb_s, **amb_read, jax=want,
                            vs_cpu=dict(patterns=SPHERE_HOLD,
                                        same_rival=float((amb.has_rival[:SPHERE_HOLD]
                                                          == camb.has_rival).mean()),
                                        max_gap_diff=float(gap_dev.max(initial=0.0)),
                                        median_gap_diff=float(np.median(gap_dev))
                                        if gap_dev.size else 0.0))
    q_f = _bands_truth(SPHERE_MULTI, SPHERE_SEEDS["multi_fcc"])
    q_h = _bands_truth(SPHERE_MULTI, SPHERE_SEEDS["multi_hcp"])
    mixed = np.concatenate([render_from_master(fcc, q_f), render_from_master(hcp, q_h)])
    multi_ix = MultiPhaseSphericalIndexer([fcc, hcp], None, cfg, symmetries=["432", "622"],
                                          tables=tables)
    multi_s, mres = _events_s(lambda: multi_ix.index_patterns(mixed))
    phase_truth = np.repeat([0, 1], SPHERE_MULTI)
    wrong = int((mres.phase != phase_truth).sum())
    multi = dict(patterns=len(mixed), s=multi_s, phase_wrong=wrong,
                 jax_phase_wrong=JAX_SPHERE["multi"]["phase_wrong"])
    for pid, (group, q) in enumerate((("432", q_f), ("622", q_h))):
        m = phase_truth == pid
        multi[group] = sphere_readings(_disorientation_deg(mres.quaternions[m], q, group))
        _hold_sphere_readings(f"multi-phase {group}", multi[group], JAX_SPHERE["multi"][group])
    if wrong > JAX_SPHERE["multi"]["phase_wrong"] + SPHERE_SHARE_SLACK * len(mixed):
        raise AssertionError(f"sphere multi-phase: {wrong} in the wrong phase (JAX "
                             f"{JAX_SPHERE['multi']['phase_wrong']})")
    out["multi_phase"] = multi
    del multi_ix, mixed, tables
    for m in modes.values():
        m.pop("ix")
    torch.cuda.empty_cache()

    # 5. The CLI: simulate --master --fit-bands over the 2-degree grid,
    # build, query --engine fused --refine 10 of 4,096 (the path's K2f and
    # K1 launches), learn-master, sphere --ang.
    master_npy = str(root / "fcc_master.npy")
    np.save(master_npy, fcc)
    grid = Path(workdir) / "dictionary" / "grid.txt"
    steps = {}
    if not grid.exists():  # --sphere-only runs no dictionary phase
        grid = root / "grid.txt"
        steps["sample"] = _index_cli(["sample", "--group", DICT_GROUP, "--resolution",
                                      str(DICT_RESOLUTION), "--out", str(grid)])
    dict_npy = str(root / "master_dict.npy")
    steps["simulate"] = _index_cli(["simulate", "--angles", str(grid), "--master", master_npy,
                                    "--fit-bands", "--uint8", "--out", dict_npy])
    sim_sum = steps["simulate"]["summary"]
    meta = json.loads(Path(dict_npy + ".simmeta.json").read_text())
    if not (sim_sum["n_patterns"] == GRID_ROWS and meta["kind"] == "master_fit"
            and sim_sum["fit_ncc"] > SPHERE_FIT_NCC_MIN):
        raise AssertionError(f"simulate --master --fit-bands: {sim_sum}")
    dict_u8 = np.load(dict_npy)
    query_npy = str(root / "query.npy")
    np.save(query_npy, dict_u8[:CLI_QUERY])
    db, oriented = str(root / "db.npz"), str(root / "orientations.npy")
    common = ["--checkpoint", ckpt, "--inplanes", str(INPLANES), "--latent-dim", str(LATENT),
              "--batch-size", str(BATCH)]
    counters = (instance_norm_leaky_relu, cosine_topk_fused, candidate_consensus_fused)
    for fn in counters:
        fn.launches = 0
    steps["build"] = _index_cli(["build", "--patterns", dict_npy, "--angles", str(grid), "--db", db]
                                + common)
    steps["query"] = _index_cli(["query", "--patterns", query_npy, "--db", db, "--out", oriented,
                                 "--engine", "fused", "--refine", "10"] + common)
    launches = {fn.__name__: fn.launches for fn in counters}
    build_batches, query_batches = -(-GRID_ROWS // BATCH), CLI_QUERY // BATCH
    want_launches = {"instance_norm_leaky_relu": 10 * (build_batches + query_batches),
                     "cosine_topk_fused": query_batches,
                     "candidate_consensus_fused": query_batches}
    if launches != want_launches:
        raise AssertionError(f"sphere CLI launches {launches}, want {want_launches}")
    q_sum = steps["query"]["summary"]
    angles = parse_angle_file(str(grid))
    q_err = _disorientation_deg(np.load(oriented), angles[:CLI_QUERY])
    if not (q_sum.get("refine_steps") == 10 and np.all(np.isfinite(q_err))):
        raise AssertionError(f"query --refine of the master dictionary: {q_sum}")
    learn_npy, learn_angles = str(root / "learn_patterns.npy"), str(root / "learn_angles.txt")
    np.save(learn_npy, dict_u8[:CLI_QUERY])
    write_anglefile(learn_angles, angles[:CLI_QUERY])
    # Half the source's edge (257, learn-master's default at full width):
    # every other source pixel lies on the learned grid.
    size = (SPHERE_MASTER - 1) // 2 + 1
    steps["learn_master"] = _index_cli(["learn-master", "--patterns", learn_npy, "--angles",
                                        learn_angles, "--size", str(size),
                                        "--out", str(root / "learned.npy")])
    learned = np.load(root / "learned.npy")
    src = fcc[::2, ::2]
    ij = (np.arange(size) - (size - 1) / 2) / ((size - 1) / 2)
    disc = (ij[None, :] ** 2 + ij[:, None] ** 2) <= 1.0
    a_, b_ = learned[disc] - learned[disc].mean(), src[disc] - src[disc].mean()
    learn_ncc = float(a_ @ b_ / np.sqrt((a_ @ a_) * (b_ @ b_)))
    if not learn_ncc > SPHERE_LEARN_NCC_MIN:
        raise AssertionError(f"learn-master NCC to the source master {learn_ncc}")
    del dict_u8
    sphere_npy = str(root / "sphere_patterns.npy")
    np.save(sphere_npy, pats)
    steps["sphere"] = _index_cli(["sphere", "--patterns", sphere_npy, "--master", master_npy,
                                  "--out", str(root / "sphere.npy"),
                                  "--ang", str(root / "sphere.ang"),
                                  "--scan-grid", str(SPHERE_PATTERNS // 32), "32"])
    cli_eulers = np.load(root / "sphere.npy")
    if not np.array_equal(cli_eulers, modes["newton"]["res"].eulers_deg):
        raise AssertionError("index sphere differs from the library's Newton result")
    if read_ang(str(root / "sphere.ang")).grid != (SPHERE_PATTERNS // 32, 32):
        raise AssertionError("sphere .ang grid")
    out["cli"] = dict(steps=steps, launches=launches, fit_ncc=sim_sum["fit_ncc"],
                      n_fitted_bands=sim_sum["n_fitted_bands"],
                      query_median_deg=float(np.median(q_err)), learned_master_ncc=learn_ncc)

    # 6. cli.serve --sphere-master alone: /healthz, /sphere, /sphere?ambiguity=1.
    t0 = time.perf_counter()
    service = build_service(parse_args(["--sphere-master", master_npy]))
    build_s = time.perf_counter() - t0
    warm_s = service.warmup()
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    x = np.round(pats[:SPHERE_AMBIGUITY] * 255.0).astype(np.uint8)
    try:
        health = _request(f"{url}/healthz")
        t0 = time.perf_counter()
        reply = _request(f"{url}/sphere", _npy(x))
        sphere_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        reply_amb = _request(f"{url}/sphere?ambiguity=1", _npy(x))
        amb_req_s = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if health["planes"] != ["sphere"] or health["mode"] != "zero-training":
        raise AssertionError(f"--sphere-master /healthz: {health}")
    direct = service._sphere.index_patterns(x)
    if not (reply["orientations"] == direct.eulers_deg.tolist() and reply["input_dtype"] == "uint8"
            and reply_amb["orientations"] == reply["orientations"]
            and len(reply_amb["ambiguity_gap"]) == len(x)):
        raise AssertionError("/sphere differs from a direct SphericalIndexer call")
    out["serve"] = dict(patterns=len(x), build_s=build_s, warmup_s=warm_s, sphere_s=sphere_s,
                        sphere_ambiguity_s=amb_req_s, health=dict(mode=health["mode"],
                                                                  planes=health["planes"]))
    del service
    for m in modes.values():
        m["res"] = None
    emit("sphere", card=smi, **out,
         timed_as="s: CUDA events around the call; ms: CUDA events per call; device_ms: "
                  "profiler sums; *_s else host wall")
    return launches


def _write_up2(path: str, patterns: np.ndarray, rows: int, cols: int) -> None:
    """An EDAX ``.up2`` file (version-3 header with the square scan grid,
    then the frames as little-endian uint16), as `data.up.read_up_header`
    reads it."""
    h, w = patterns.shape[1:]
    with open(path, "wb") as f:
        f.write(np.asarray([3, w, h, 42], "<u4").tobytes())  # version, width, height, offset
        f.write(np.uint8(0).tobytes() + np.asarray([cols, rows], "<u4").tobytes())
        f.write(np.uint8(0).tobytes() + np.asarray([1.0, 1.0], "<f8").tobytes())  # square; steps
        patterns.astype("<u2").tofile(f)


def _strain_stages(ref_dev: torch.Tensor, x: torch.Tensor, a: np.ndarray) -> dict:
    """Device ms (CUDA events), launches and device busy ms (profiler) of
    each stage of one chunk of `STRAIN_CHUNK` uint8 patterns, with each
    stage's bound: the bytes of its operands and results read or written
    once, and its operations at the FP32 peak."""
    from latice_tpu_torch import hrebsd as hr
    from latice_tpu_torch.device import full_f32_matmul
    from latice_tpu_torch.sim import DetectorGeometry

    geom = DetectorGeometry(shape=(STRAIN_SIZE, STRAIN_SIZE))
    centers = hr.default_roi_centers(geom, roi_size=STRAIN_ROI)
    rint = np.rint(centers).astype(int)
    dev = x.device
    hann = torch.from_numpy(hr._hann2(STRAIN_ROI)).to(dev)
    fmask = torch.from_numpy(hr._annular_mask(STRAIN_ROI, 1.5, None)).to(dev)
    idx = torch.from_numpy(hr._roi_index(rint, STRAIN_ROI, STRAIN_SIZE)).to(dev)
    base = torch.from_numpy(hr._pixel_screen_vectors(geom)).to(dev)
    f = torch.from_numpy((np.eye(3) + a).astype(np.float32)).to(dev)
    pc = torch.tensor([[0.5, 0.5, 0.7]], device=dev).expand(len(x), 3).contiguous()
    m = torch.from_numpy(hr._design_matrix(hr.roi_position_vectors(geom, centers), geom.dd)
                         .astype(np.float32)).to(dev)
    b, n_roi, s = len(x), len(centers), STRAIN_ROI
    u = 2 * round(STRAIN_UPSAMPLE) + 1
    panels, px = b * n_roi, b * n_roi * s * s
    with torch.no_grad(), full_f32_matmul():
        warped = hr._remap_core(x, f, base, pc)
        shifts, quality = hr._xcorr_shifts(ref_dev, x, hann, fmask, idx, s, STRAIN_UPSAMPLE, 1.0)
        q_xy = torch.stack([shifts[..., 1], -shifts[..., 0]], dim=-1) / STRAIN_SIZE
        stages = {
            # 3x3 product, projection and four taps per pixel: ~60 operations.
            "warp": (lambda: hr._remap_core(x, f, base, pc),
                     x.numel() * x.element_size() + warped.numel() * 4 + base.numel() * 4,
                     60.0 * x.numel()),
            # Per panel: two complex 64x64 FFTs (5 N log2 N each) and the
            # matrix DFT's (U x S)(S x S) and (U x S)(S x U) complex products
            # (8 operations per complex multiply-add).
            "xcorr": (lambda: hr._xcorr_shifts(ref_dev, x, hann, fmask, idx, s, STRAIN_UPSAMPLE,
                                               1.0),
                      x.numel() * x.element_size() + ref_dev.numel() * 4 + 3 * panels * 4,
                      panels * (2 * 5.0 * s * s * np.log2(s * s) + 8.0 * (u * s * s + u * s * u))),
            "xcorr_after_warp": (lambda: hr._xcorr_shifts(ref_dev, warped, hann, fmask, idx, s,
                                                          STRAIN_UPSAMPLE, 1.0),
                                 warped.numel() * 4 + ref_dev.numel() * 4 + 3 * panels * 4,
                                 panels * (2 * 5.0 * s * s * np.log2(s * s)
                                           + 8.0 * (u * s * s + u * s * u))),
            # M^T W M, M^T W q, the 8x8 solve and the prediction per pattern.
            "solve": (lambda: hr._solve_core(m, q_xy, quality),
                      (q_xy.numel() + quality.numel() + m.numel() + b * 9) * 4,
                      b * (2.0 * 64 * 2 * n_roi + 4.0 * 8 * 2 * n_roi + 2 * 8 ** 3 / 3)),
        }
        out = {}
        for name, (fn, n_bytes, n_ops) in stages.items():
            bound, by = bound_ms(n_bytes, n_ops)
            out[name] = dict(**_stage_ms(fn), **_traced_stage(fn), bound_ms=bound, bound_by=by,
                             bytes=n_bytes, ops=n_ops)
    # The staged floor of `_xcorr_shifts`: each (panels, S, S) intermediate
    # it writes, written once and read once (ROIs f32, centred, windowed,
    # spectrum c64, masked, cross c64, inverse c64, real part f32).
    staged = 2 * px * (4 + 4 + 4 + 8 + 8 + 8 + 8 + 4)
    out["xcorr"]["staged_bytes"] = staged
    out["xcorr"]["staged_bound_ms"] = staged / PEAK_BYTES_PER_S * 1e3
    out["xcorr"]["panel_c64_mb"] = px * 8 / 1e6
    return out


def _strain_anchors() -> dict:
    """tests/test_hrebsd.py's two accuracy anchors on the card, at their
    256x256 settings (64x64 ROIs, kappa 50), each held to the truth at
    `STRAIN_ANCHOR_ATOL`."""
    from latice_tpu_torch.hrebsd import hrebsd_map
    from latice_tpu_torch.sim import DetectorGeometry

    geom = DetectorGeometry(shape=(256, 256))
    f = _direction_function(11)
    rot = np.array([1.5e-3, -2.5e-3, 2e-3])
    a_rot = np.array([[0.0, -rot[2], rot[1]], [rot[2], 0.0, -rot[0]], [-rot[1], rot[0], 0.0]])
    res = hrebsd_map(_render_deformed(f, 256, a_rot)[None], _render_deformed(f, 256), geom,
                     upsample=50)
    rotation_only = dict(rotation_err=float(np.abs(res.rotation[0] - rot).max()),
                         strain_err=float(np.abs(res.strain[0]).max()))
    f = _direction_function(57)
    eps = np.array([[1e-3, 3e-4, 0.0], [3e-4, -8e-4, 2e-4], [0.0, 2e-4, 0.0]])
    a_true = _rotation_a(3.0, [0.3, -0.5, 0.8], eps)
    pat, ref = _render_deformed(f, 256, a_true)[None], _render_deformed(f, 256)
    bare = hrebsd_map(pat, ref, geom, upsample=50, remap_iterations=0)
    remap = hrebsd_map(pat, ref, geom, upsample=50, remap_iterations=1)
    three = dict(bare_err=float(np.abs(bare.a[0] - a_true).max()),
                 remap_err=float(np.abs(remap.a[0] - a_true).max()),
                 bare_residual_px=float(bare.residual_px[0]),
                 remap_residual_px=float(remap.residual_px[0]))
    if not (max(rotation_only.values()) < STRAIN_ANCHOR_ATOL
            and three["remap_err"] < STRAIN_ANCHOR_ATOL < three["bare_err"]
            and three["remap_residual_px"] < three["bare_residual_px"]):
        raise AssertionError(f"HR-EBSD anchors: {rotation_only} {three}")
    return dict(rotation_only=rotation_only, three_degree=three, tolerance=STRAIN_ANCHOR_ATOL)


def phase_strain(workdir: str, ckpt: str, smi: str) -> dict:
    """HR-EBSD and the scan readers at full width (bench.py's hrebsd row:
    128x128, 21 ROIs of 64x64, kappa 20, chunk 128). The library on 512
    truth patterns with 0 and 1 remap passes, without and with the Ni
    stiffness, held to the JAX package's readings on the same inputs
    (examples/hrebsd_jax_reference.py) and on 64 to the port's CPU path; the
    JAX suite's two anchors; each stage of a chunk timed with its bound, and
    patterns/s over a 64x64 uint8 scan; then through the entry points:
    ``strain --patterns scan.up2 --ref 0 --stiffness ni --remap 1`` (the
    scan grid from the UP header), a ``cli.serve --strain-ref`` server's
    ``/strain`` of 256, and ``build`` + ``query --engine fused`` of the
    ``.up2`` scan (its K2f and K1 launches are the path's)."""
    from latice_tpu_torch import hrebsd as hr
    from latice_tpu_torch.cli.serve import build_service, parse_args
    from latice_tpu_torch.crystal import CUBIC_STIFFNESS, cubic_stiffness
    from latice_tpu_torch.data import read_ang
    from latice_tpu_torch.ops import (
        candidate_consensus_fused,
        cosine_topk_fused,
        instance_norm_leaky_relu,
    )
    from latice_tpu_torch.serve import make_server
    from latice_tpu_torch.sim import DetectorGeometry

    root = Path(workdir) / "strain"
    root.mkdir()
    out = {}
    geom = DetectorGeometry(shape=(STRAIN_SIZE, STRAIN_SIZE))
    kw = dict(roi_size=STRAIN_ROI, upsample=STRAIN_UPSAMPLE, chunk=STRAIN_CHUNK)

    # 1. The library on the truth patterns against the JAX package's
    # readings, and on STRAIN_HOLD of them against the port's CPU path.
    t0 = time.perf_counter()
    ref, pats, a_true = strain_truth()
    out["render_s"] = time.perf_counter() - t0
    hr.hrebsd_map(pats[:8], ref, geom, **kw)  # first call: cuFFT plans, allocations
    library, hold = {}, {}
    for name, cfg in STRAIN_CONFIGS.items():
        stiff = cfg["stiffness"] and cubic_stiffness(*CUBIC_STIFFNESS[cfg["stiffness"]])
        run = dict(kw, remap_iterations=cfg["remap_iterations"], stiffness=stiff)
        sec, res = _events_s(lambda: hr.hrebsd_map(pats, ref, geom, **run))
        got = strain_readings(res.a, a_true, res.quality, res.residual_px)
        want = JAX_STRAIN[name]
        if not (got["median_err"] <= want["median_err"] + STRAIN_MEDIAN_SLACK
                and got["max_err"] <= want["max_err"] + STRAIN_MAX_SLACK
                and got["within_1e4"] >= want["within_1e4"] - STRAIN_SHARE_SLACK
                and got["within_5e4"] >= want["within_5e4"] - STRAIN_SHARE_SLACK
                and abs(got["mean_quality"] - want["mean_quality"]) <= STRAIN_QUALITY_ATOL
                and abs(got["median_residual_px"] - want["median_residual_px"])
                <= STRAIN_RESIDUAL_ATOL):
            raise AssertionError(f"strain {name}: card {got}, JAX {want}")
        if stiff is not None:
            normal_stress = np.abs(res.stress[:, 2, 2]).max() / np.abs(res.stress).max()
            if not normal_stress < 1e-4:
                raise AssertionError(f"strain {name}: sigma_33 / max|sigma| = {normal_stress}")
            got["max_sigma33_share"] = float(normal_stress)
        library[name] = dict(s=sec, patterns_per_s=len(pats) / sec, **got, jax=want)
        if name in ("remap0", "remap0_ni", "remap1_ni"):
            t0 = time.perf_counter()
            cres = hr.hrebsd_map(pats[:STRAIN_HOLD], ref, geom, device="cpu", **run)
            cpu_s = time.perf_counter() - t0
            a_err = float(np.abs(res.a[:STRAIN_HOLD] - cres.a).max())
            s_err = float(np.abs(res.shifts_px[:STRAIN_HOLD] - cres.shifts_px).max())
            a_tol, s_tol = ((STRAIN_REMAP_A_ATOL, STRAIN_REMAP_SHIFT_ATOL)
                            if cfg["remap_iterations"] else (STRAIN_A_ATOL, STRAIN_SHIFT_ATOL))
            hold[name] = dict(patterns=STRAIN_HOLD, cpu_s=cpu_s, max_a_diff=a_err,
                              max_shift_diff_px=s_err, a_tolerance=a_tol,
                              shift_tolerance_px=s_tol)
            if stiff is not None:
                scale = np.abs(cres.stress).max()
                hold[name]["max_stress_diff_share"] = float(
                    np.abs(res.stress[:STRAIN_HOLD] - cres.stress).max() / scale)
            if not (a_err <= a_tol and s_err <= s_tol):
                raise AssertionError(f"strain {name} card vs CPU: {hold[name]}")
    # The remap pass on the same deformation (the CPU's first-pass A), and
    # the acceptance decisions of the end-to-end run where their margin is
    # clear of the residuals' differences.
    centers = hr.default_roi_centers(geom, roi_size=STRAIN_ROI)
    first = {}
    for dev in ("cuda", "cpu"):
        s0, q0 = hr.measure_roi_shifts(ref, pats[:STRAIN_HOLD], centers, device=dev, **kw)
        first[dev] = hr.solve_deformation(s0, q0, geom, centers, 0.1, device=dev)
    same = {}
    for dev in ("cuda", "cpu"):
        s1, q1 = hr.measure_roi_shifts(ref, pats[:STRAIN_HOLD], centers,
                                       deformation=first["cpu"][0], geometry=geom, device=dev,
                                       **kw)
        same[dev] = (s1, q1) + hr.solve_deformation(s1, q1, geom, centers, 0.1, device=dev)
    margin = np.abs(first["cpu"][1] - same["cpu"][3]) * STRAIN_SIZE
    clear = margin > STRAIN_ACCEPT_MARGIN_PX
    accept = {dev: same[dev][3] < first[dev][1] for dev in ("cuda", "cpu")}
    remap = dict(patterns=STRAIN_HOLD,
                 max_shift_diff_px=float(np.abs(same["cuda"][0] - same["cpu"][0]).max()),
                 max_a_diff=float(np.abs(same["cuda"][2] - same["cpu"][2]).max()),
                 first_pass_max_a_diff=float(np.abs(first["cuda"][0] - first["cpu"][0]).max()),
                 accept_clear=int(clear.sum()),
                 accept_differs_where_clear=int((accept["cuda"] != accept["cpu"])[clear].sum()),
                 a_tolerance=STRAIN_A_ATOL, shift_tolerance_px=STRAIN_SHIFT_ATOL)
    hold["remap_pass_same_deformation"] = remap
    if not (remap["max_shift_diff_px"] <= STRAIN_SHIFT_ATOL and remap["max_a_diff"] <= STRAIN_A_ATOL
            and remap["accept_differs_where_clear"] == 0):
        raise AssertionError(f"strain remap pass card vs CPU: {remap}")
    out["library"], out["vs_cpu"] = library, hold
    out["anchors"] = _strain_anchors()

    # 2. The scan: the truth set tiled to 64x64, quantized to uint8.
    lo, hi = min(ref.min(), pats.min()), max(ref.max(), pats.max())
    quantize = lambda v: np.round((v - lo) / (hi - lo) * 255.0).astype(np.uint8)  # noqa: E731
    ref8 = quantize(ref)
    scan = np.tile(quantize(pats), (STRAIN_SCAN_SIDE ** 2 // len(pats), 1, 1))
    x = torch.from_numpy(scan[:STRAIN_CHUNK]).cuda()
    out["per_chunk_128"] = _strain_stages(torch.from_numpy(ref8).cuda(), x, a_true[:STRAIN_CHUNK])
    del x
    for name in ("remap0", "remap1"):
        run = dict(kw, remap_iterations=STRAIN_CONFIGS[name]["remap_iterations"])
        tr = _traced(lambda: hr.hrebsd_map(scan[:STRAIN_CHUNK], ref8, geom, **run))
        sec, _ = _events_s(lambda: hr.hrebsd_map(scan, ref8, geom, **run))
        out[f"scan_{name}"] = dict(
            patterns=len(scan), s=sec, patterns_per_s=len(scan) / sec,
            per_chunk=dict(device_ms=tr["device_ms"], launches=tr["launches"],
                           wall_ms=tr["wall_ms"], idle_share=1.0 - tr["device_ms"] / tr["wall_ms"],
                           top=tr["top"]))

    # 3. The CLI on an EDAX .up2 copy of the scan (16-bit frames, x257).
    up2 = str(root / "scan.up2")
    _write_up2(up2, scan.astype(np.uint16) * 257, STRAIN_SCAN_SIDE, STRAIN_SCAN_SIDE)
    steps = {"strain": _index_cli(["strain", "--patterns", up2, "--ref", "0", "--stiffness", "ni",
                                   "--remap", "1", "--out", str(root / "strain.npz")])}
    summary = steps["strain"]["summary"]
    cli_out = np.load(root / "strain.npz")
    frames = (scan.astype(np.uint16) * 257).astype(np.float32)
    lib = hr.hrebsd_map(frames, frames[0], geom, remap_iterations=1,
                        stiffness=cubic_stiffness(*CUBIC_STIFFNESS["ni"]), **kw)
    cli_diff = float(np.abs(cli_out["a"] - lib.a).max())
    if not (summary["n_patterns"] == len(scan) and cli_diff <= STRAIN_A_ATOL
            and np.isfinite(cli_out["stress"]).all()):
        raise AssertionError(f"strain CLI on the .up2 scan: {summary}, a differs by {cli_diff}")
    steps["strain"]["patterns_per_s"] = len(scan) / steps["strain"]["wall_s"]
    steps["strain"]["max_a_diff_vs_library"] = cli_diff
    del frames, lib

    # 4. cli.serve --strain-ref alone: /healthz, then /strain of 256 uint8.
    np.save(root / "ref.npy", ref8)
    t0 = time.perf_counter()
    service = build_service(parse_args(["--strain-ref", str(root / "ref.npy")]))
    build_s = time.perf_counter() - t0
    warm_s = service.warmup()
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    body = scan[:STRAIN_SERVE]
    try:
        health = _request(f"{url}/healthz")
        t0 = time.perf_counter()
        reply = _request(f"{url}/strain", _npy(body))
        strain_s = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    direct = hr.hrebsd_map(body, ref8, geom, remap_iterations=1, chunk=STRAIN_CHUNK)
    serve_diff = float(np.abs(np.asarray(reply["strain"]) - direct.strain).max())
    if not (health["planes"] == ["strain"] and health["mode"] == "zero-training"
            and reply["n"] == STRAIN_SERVE and reply["input_dtype"] == "uint8"
            and serve_diff <= STRAIN_A_ATOL):
        raise AssertionError(f"/strain: {health}, strain differs by {serve_diff}")
    out["serve"] = dict(patterns=STRAIN_SERVE, build_s=build_s, warmup_s=warm_s,
                        strain_s=strain_s, patterns_per_s=STRAIN_SERVE / strain_s,
                        max_strain_diff_vs_library=serve_diff,
                        health=dict(mode=health["mode"], planes=health["planes"]))
    del service

    # 5. build + query --engine fused of the .up2 scan: the slab reader on
    # the card, the scan grid from the header.
    np.save(root / "dict.npy", quantize(pats))
    angles = np.random.default_rng(STRAIN_SEED).uniform([0, 0, 0], [360, 180, 360],
                                                       size=(len(pats), 3))
    with open(root / "angles.txt", "w") as f:
        f.write(f"zxz\n{len(pats)}\n")
        np.savetxt(f, angles, fmt="%.4f")
    common = ["--checkpoint", ckpt, "--inplanes", str(INPLANES), "--latent-dim", str(LATENT),
              "--batch-size", str(BATCH)]
    counters = (instance_norm_leaky_relu, cosine_topk_fused, candidate_consensus_fused)
    for fn in counters:
        fn.launches = 0
    db = str(root / "db.npz")
    steps["build"] = _index_cli(["build", "--patterns", str(root / "dict.npy"), "--angles",
                                 str(root / "angles.txt"), "--db", db] + common)
    steps["query"] = _index_cli(["query", "--patterns", up2, "--db", db, "--engine", "fused",
                                 "--out", str(root / "orientations.npy"), "--ang",
                                 str(root / "scan.ang")] + common)
    launches = {fn.__name__: fn.launches for fn in counters}
    build_batches, query_batches = len(pats) // BATCH, len(scan) // BATCH
    want_launches = {"instance_norm_leaky_relu": 10 * (build_batches + query_batches),
                     "cosine_topk_fused": query_batches,
                     "candidate_consensus_fused": query_batches}
    q_sum = steps["query"]["summary"]
    grid = read_ang(str(root / "scan.ang")).grid
    if not (launches == want_launches and q_sum["n_patterns"] == len(scan)
            and grid == (STRAIN_SCAN_SIDE, STRAIN_SCAN_SIDE)
            and np.isfinite(np.load(root / "orientations.npy")).all()):
        raise AssertionError(f"query of the .up2 scan: {q_sum}, launches {launches} (want "
                             f"{want_launches}), .ang grid {grid}")
    out["cli"] = dict(steps=steps, launches=launches, ang_grid=list(grid))
    emit("strain", card=smi, **out,
         timed_as="s: CUDA events around the call; ms: CUDA events per call; device_ms: "
                  "profiler sums; wall_ms, *_s else host wall")
    return launches


def _progress(phase: str, t0: float, step: str) -> None:
    """A line per finished step of a long phase: a failure later in the
    phase still leaves the steps' times in the output."""
    print(json.dumps({"progress": phase, "step": step,
                      "elapsed_s": time.perf_counter() - t0}), flush=True)


def _index_cli(argv) -> dict:
    """One ``cli.index`` command in this process: its host wall seconds and
    its JSON summary line."""
    import contextlib
    import logging

    from latice_tpu_torch.cli.index import main as index_main

    stdout = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        index_main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    logging.getLogger().setLevel(logging.WARNING)  # the CLI turned INFO on
    lines = stdout.getvalue().strip().splitlines()
    return dict(wall_s=wall_s, summary=json.loads(lines[-1]) if lines else None)


def _traced_call(fn) -> tuple[dict, object]:
    """One call of ``fn`` under the profiler: device busy ms, device
    activities, host wall ms and the device's idle share of it; and the
    call's result."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_kernels(prof)
    busy = sum(t for _, t, _ in kernels)
    return dict(device_ms=busy, launches=sum(c for _, _, c in kernels), wall_ms=wall_ms,
                idle_share=1.0 - busy / wall_ms), result


def _eigh_chunk(beams, d: np.ndarray) -> dict:
    """``torch.linalg.eigh`` alone on one chunk's Bloch matrices (the real
    N×N or the embedded 2N×2N ones), CUDA events around one call, beside
    its bound: ~9n³ operations per matrix with vectors at the FP32 peak,
    each matrix read and its vectors written once."""
    from latice_tpu_torch.sim import dynamical as dyn

    dirs = torch.as_tensor(d, dtype=torch.float32, device="cuda")
    g, cr = (torch.as_tensor(a, device="cuda") for a in (beams.g, beams.coupling))
    a = cr[None] + torch.diag_embed(dyn._excitation_errors(dirs, g, beams.k_int))
    if not beams.is_centrosymmetric:
        ci = torch.as_tensor(beams.coupling_imag, device="cuda").expand(a.shape)
        a = torch.cat([torch.cat([a, -ci], dim=2), torch.cat([ci, a], dim=2)], dim=1)
    b, n = a.shape[0], a.shape[-1]
    ms, _ = _events_s(lambda: torch.linalg.eigh(a))
    bound, by = bound_ms(b * (2 * n * n + n) * 4, b * 9.0 * n**3)
    return dict(n=n, batch=b, ms=ms * 1e3, bound_ms=bound, bound_by=by)


def _hold_mc(got: dict, want: dict) -> dict:
    """The card's Monte-Carlo statistics against the JAX package's: the
    yield and each energy weight within `MC_SIGMAS` standard errors of the
    difference of two binomial estimates, the depth percentiles within
    `MC_DEPTH_RTOL`."""
    n_in = MC_ELECTRONS

    def sigma(p, q, n1, n2):
        return float(np.sqrt(p * (1 - p) / n1 + q * (1 - q) / n2))

    eta_sd = sigma(got["bse_yield"], want["bse_yield"], n_in, n_in)
    eta_z = abs(got["bse_yield"] - want["bse_yield"]) / eta_sd
    w_z = []
    for p, q in zip(got["energy_weights"], want["energy_weights"]):
        sd = sigma(p, q, got["n_bse"], want["n_bse"])
        w_z.append(0.0 if p == q else abs(p - q) / max(sd, 1e-12))
    depth_rel = {k: abs(got[k] - want[k]) / want[k]
                 for k in ("depth_p10_nm", "depth_p50_nm", "depth_p90_nm")}
    if not (eta_z <= MC_SIGMAS and max(w_z) <= MC_SIGMAS
            and max(depth_rel.values()) <= MC_DEPTH_RTOL):
        raise AssertionError(f"Monte Carlo vs JAX: eta {got['bse_yield']} vs "
                             f"{want['bse_yield']} ({eta_z:.2f} sigma), weights {w_z}, "
                             f"depths {depth_rel}")
    return dict(eta_sigmas=eta_z, energy_weight_sigmas=w_z, depth_rel=depth_rel)


def phase_master(workdir: str, ckpt: str, smi: str) -> dict:
    """The dynamical master at ``cli.index master``'s defaults (201x201, 64
    beams): 1,024 generic directions on the real path (fcc Ni), the 2N
    embedding (zincblende GaAs) and the measured-depth quadrature (fcc),
    each card against the port's CPU path and the JAX package's readings
    (examples/dynamical_jax_reference.py), traced; ``eigh`` alone per chunk
    against its bound; ``master`` (fcc, then zincblende) through the CLI,
    the fcc master held to the port's CPU master; the Monte-Carlo
    simulation at its defaults, traced and held to JAX's statistics;
    ``master --mc``; then the chain ``simulate --master --fit-bands``
    (source: the master's ``.mastermeta.json``), ``build`` of the 2-degree
    grid and ``query --engine fused`` of 4,096, whose K2f and K1 launches
    are the path's."""
    from latice_tpu_torch import sim as psim
    from latice_tpu_torch.data import parse_angle_file
    from latice_tpu_torch.ops import (
        candidate_consensus_fused,
        cosine_topk_fused,
        instance_norm_leaky_relu,
    )
    from latice_tpu_torch.sim.dynamical import lambert_master_directions

    t_phase = time.perf_counter()
    root = Path(workdir) / "master"
    root.mkdir()
    out = {}
    d = master_directions()
    zc, zw = master_quad_histogram()
    beams = {name: psim.dynamical_beams(master_structure(psim, name), n_beams=MASTER_BEAMS)
             for name in MASTER_CASES}
    psim.channeling_intensities(d[:8], beams["fcc"], chunk=8)  # cuSOLVER's set-up

    # 1. 1,024 generic directions per path, one chunk each, timed: the card
    # against the port's CPU path and JAX's readings. The device's share of
    # a chunk's wall comes from a traced chunk of MASTER_TRACED directions
    # (cuSOLVER launches ~75 kernels per matrix; a trace of a full chunk
    # holds 150,000 records), over the same chunk's untraced wall.
    cases = {}
    for name in ("fcc", "zincblende", "fcc_quad"):
        b = beams[name.removesuffix("_quad")]
        kw = dict(depth_centers_nm=zc, depth_weights=zw) if name.endswith("_quad") else {}
        t0 = time.perf_counter()
        card = psim.channeling_intensities(d, b, chunk=MASTER_CHUNK, **kw)
        chunk_wall_ms = (time.perf_counter() - t0) * 1e3

        def small():
            return psim.channeling_intensities(d[:MASTER_TRACED], b, chunk=MASTER_TRACED, **kw)

        small()
        t0 = time.perf_counter()
        small()
        small_wall_ms = (time.perf_counter() - t0) * 1e3
        trace, _ = _traced_call(small)
        trace.update(directions=MASTER_TRACED, untraced_wall_ms=small_wall_ms,
                     idle_share=1.0 - trace["device_ms"] / small_wall_ms,
                     launches_per_matrix=trace["launches"] / MASTER_TRACED)
        cpu = psim.channeling_intensities(d, b, chunk=MASTER_CHUNK, device="cpu", **kw)
        want = JAX_MASTER[name]
        rel_cpu = np.abs(card - cpu) / np.abs(cpu)
        shown = np.asarray(want["shown"])
        rel_jax = np.abs(card[:MASTER_SHOWN] - shown) / np.abs(shown)
        got = master_readings(card)
        spread = {k: abs(got[k] - want[k]) / abs(want[k]) for k in ("mean", "median", "p01", "p99")}
        if (len(b), b.u0) != (want["n_beams"], want["u0"]):
            raise AssertionError(f"master {name}: beams {len(b)}, u0 {b.u0}; JAX {want}")
        if not (rel_cpu.max() <= MASTER_RTOL and rel_jax.max() <= MASTER_RTOL
                and max(spread.values()) <= MASTER_RTOL):
            raise AssertionError(f"master {name}: card vs CPU {rel_cpu.max()}, vs JAX "
                                 f"{rel_jax.max()}, spread {spread}")
        cases[name] = dict(n_beams=len(b), chunk_wall_ms=chunk_wall_ms, traced=trace,
                           card_vs_cpu=dict(median=float(np.median(rel_cpu)),
                                            p99=float(np.percentile(rel_cpu, 99)),
                                            max=float(rel_cpu.max())),
                           card_vs_jax_shown_max=float(rel_jax.max()), card_vs_jax_spread=spread)
    out["directions"] = cases
    _progress("master", t_phase, "directions")

    # 2. eigh alone on one chunk of 2,048, real and embedded; cuSOLVER's
    # loop over matrices against MAGMA's on the real one.
    dc = lambert_master_directions(MASTER_SIZE).reshape(-1, 3)[:MASTER_CHUNK]
    eigh = {name: _eigh_chunk(b, dc) for name, b in beams.items()}
    try:
        torch.backends.cuda.preferred_linalg_library("magma")
        eigh["fcc_magma"] = _eigh_chunk(beams["fcc"], dc)
    finally:
        torch.backends.cuda.preferred_linalg_library("default")
    out["eigh_per_chunk"] = eigh
    _progress("master", t_phase, "eigh")

    # 3. `master` through the CLI; the fcc master against the port's CPU
    # master (normalized as the CLI does), pixels inside the equator.
    steps = {}
    for name, (structure, element, lattice) in MASTER_CASES.items():
        steps[name] = _index_cli(["master", "--structure", structure, "--element", element,
                                  "--lattice", str(lattice), "--out", str(root / f"{name}.npy")])
        meta = json.loads(Path(root / f"{name}.npy.mastermeta.json").read_text())
        if (steps[name]["summary"]["n_beams"] != JAX_MASTER[name]["n_beams"]
                or meta["centrosymmetric"] != (name == "fcc")):
            raise AssertionError(f"master {name}: {steps[name]['summary']}, {meta}")
        _progress("master", t_phase, f"master {name}")
    fcc_card = np.load(root / "fcc.npy")
    t0 = time.perf_counter()
    fcc_cpu = psim.dynamical_master_pattern(master_structure(psim, "fcc"), beams=beams["fcc"],
                                            size=MASTER_SIZE, device="cpu")
    cpu_master_s = time.perf_counter() - t0
    ij = (np.arange(MASTER_SIZE) - (MASTER_SIZE - 1) / 2) / ((MASTER_SIZE - 1) / 2)
    disc = (ij[None, :] ** 2 + ij[:, None] ** 2) <= 1.0
    err = np.abs(fcc_card - fcc_cpu)[disc]
    master_hold = dict(median=float(np.median(err)), p99=float(np.percentile(err, 99)),
                       max=float(err.max()), above_rtol=int((err > MASTER_RTOL).sum()),
                       pixels=int(disc.sum()), cpu_master_s=cpu_master_s,
                       measured_as="|card - CPU| of the min-max normalized masters")
    if not (master_hold["median"] <= MASTER_MEDIAN_RTOL and master_hold["p99"] <= MASTER_P99_RTOL):
        raise AssertionError(f"fcc master card vs CPU: {master_hold}")
    out["master_cli"] = dict(steps=steps, fcc_vs_cpu=master_hold)
    _progress("master", t_phase, "fcc master vs CPU")

    # 4. Monte Carlo at its defaults, traced (the walk's launches and the
    # device's idle share), held to JAX's statistics; then `master --mc`.
    fcc = master_structure(psim, "fcc")

    def simulate():
        return psim.simulate_bse_monte_carlo(
            fcc, kv=20.0, tilt_deg=MC_TILT_DEG, n_electrons=MC_ELECTRONS,
            energy_bins=MC_ENERGY_BINS, depth_bins=MC_DEPTH_BINS)

    t0 = time.perf_counter()
    mc = simulate()
    mc_wall_ms = (time.perf_counter() - t0) * 1e3
    mc_trace, _ = _traced_call(simulate)
    mc_trace.update(untraced_wall_ms=mc_wall_ms,
                    idle_share=1.0 - mc_trace["device_ms"] / mc_wall_ms)
    mc_got = mc_readings(mc)
    mc_hold = _hold_mc(mc_got, JAX_MASTER["mc_seed0"])
    print(f"master: `master --mc` keeps {MC_ENERGY_BINS_RUN} exit-energy bins of the default "
          f"{MC_ENERGY_BINS} (each kept bin is one more 201x201 Bloch solve)", flush=True)
    steps["mc"] = _index_cli(["master", "--mc", "--mc-electrons", str(MC_ELECTRONS),
                              "--mc-energy-bins", str(MC_ENERGY_BINS_RUN),
                              "--out", str(root / "fcc_mc.npy")])
    mc_meta = json.loads(Path(root / "fcc_mc.npy.mastermeta.json").read_text())
    if not (steps["mc"]["summary"]["mc_bse_yield"] == round(mc.bse_yield, 4)
            and mc_meta["mc"] and len(mc_meta["mc_energy_weights"]) == MC_ENERGY_BINS_RUN):
        raise AssertionError(f"master --mc: {steps['mc']['summary']}, {mc_meta}")
    mc_img = np.load(root / "fcc_mc.npy")
    if not (np.all(np.isfinite(mc_img)) and mc_img.min() == 0.0 and mc_img.max() == 1.0):
        raise AssertionError("master --mc: the master is not finite and normalized")
    # The weighted master from this run's simulation (8 bins), card against
    # the port's CPU path, at MC_HOLD_SIZE.
    kw = dict(size=MC_HOLD_SIZE, chunk=MC_HOLD_SIZE**2)
    mc_card_s, mc_card = _events_s(lambda: psim.mc_weighted_master_pattern(fcc, mc, **kw))
    mc_cpu = psim.mc_weighted_master_pattern(fcc, mc, device="cpu", **kw)
    mc_err = float(np.abs(mc_card - mc_cpu).max())
    if not mc_err <= MASTER_RTOL:
        raise AssertionError(f"MC-weighted master card vs CPU: {mc_err}")
    out["monte_carlo"] = dict(walk=mc_trace, readings=mc_got, jax_seed0=JAX_MASTER["mc_seed0"],
                              hold=mc_hold, mc_energy_bins_run=MC_ENERGY_BINS_RUN,
                              mc_master_corr_to_plain=float(
                                  np.corrcoef(mc_img[disc], fcc_card[disc])[0, 1]),
                              weighted_master_card_vs_cpu=mc_err,
                              weighted_master_card_s=mc_card_s)
    _progress("master", t_phase, "monte_carlo")

    # 5. The chain: simulate --master --fit-bands (the master's sidecar),
    # build of the grid, query --engine fused of 4,096.
    grid = Path(workdir) / "dictionary" / "grid.txt"
    if not grid.exists():  # --master-only runs no dictionary phase
        grid = root / "grid.txt"
        steps["sample"] = _index_cli(["sample", "--group", DICT_GROUP, "--resolution",
                                      str(DICT_RESOLUTION), "--out", str(grid)])
    dict_npy = str(root / "master_dict.npy")
    steps["simulate"] = _index_cli(["simulate", "--angles", str(grid), "--master",
                                    str(root / "fcc.npy"), "--uint8", "--out", dict_npy])
    sim_sum = steps["simulate"]["summary"]
    meta = json.loads(Path(dict_npy + ".simmeta.json").read_text())
    if not (sim_sum["n_patterns"] == GRID_ROWS and meta["kind"] == "master_fit"
            and meta["fit_source"] == "mastermeta"):
        raise AssertionError(f"simulate --master of the dynamical master: {sim_sum}, "
                             f"{meta['kind']}, {meta.get('fit_source')}")
    query_npy = str(root / "query.npy")
    np.save(query_npy, np.load(dict_npy)[:MASTER_QUERY])
    db, oriented = str(root / "db.npz"), str(root / "orientations.npy")
    common = ["--checkpoint", ckpt, "--inplanes", str(INPLANES), "--latent-dim", str(LATENT),
              "--batch-size", str(BATCH)]
    counters = (instance_norm_leaky_relu, cosine_topk_fused, candidate_consensus_fused)
    for fn in counters:
        fn.launches = 0
    steps["build"] = _index_cli(["build", "--patterns", dict_npy, "--angles", str(grid),
                                 "--db", db] + common)
    steps["query"] = _index_cli(["query", "--patterns", query_npy, "--db", db, "--out", oriented,
                                 "--engine", "fused"] + common)
    launches = {fn.__name__: fn.launches for fn in counters}
    build_batches, query_batches = -(-GRID_ROWS // BATCH), MASTER_QUERY // BATCH
    want_launches = {"instance_norm_leaky_relu": 10 * (build_batches + query_batches),
                     "cosine_topk_fused": query_batches,
                     "candidate_consensus_fused": query_batches}
    if launches != want_launches:
        raise AssertionError(f"master chain launches {launches}, want {want_launches}")
    q_err = _disorientation_deg(np.load(oriented), parse_angle_file(str(grid))[:MASTER_QUERY])
    if not np.all(np.isfinite(q_err)):
        raise AssertionError("query of the dynamical-master dictionary: non-finite orientations")
    out["chain"] = dict(launches=launches, fit_ncc=sim_sum["fit_ncc"],
                        n_fitted_bands=sim_sum["n_fitted_bands"],
                        query_median_deg=float(np.median(q_err)))
    emit("master", card=smi, **out,
         timed_as="chunk_wall_ms, untraced_wall_ms, wall_s: host clock; traced: profiler "
                  "sums and records of one call; idle_share: 1 - traced device / untraced "
                  "wall; eigh ms: CUDA events around one call")
    return launches


def _analysis_stage(fn, n_bytes: float | None = None,
                    n_ops: float | None = None) -> tuple[dict, object]:
    """One call of ``fn`` under the profiler, between CUDA events recorded
    inside the trace (its teardown is not timed): events ms, the device's
    busy ms and launches (the runtime API's launch calls), the host's wall
    ms and its ms beside the device's, the device's idle share, the peak of
    memory allocated above what was allocated before, and the bound of the
    work the stage gives the card (None for a stage that runs on the host)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        result = fn()
        end.record()
        end.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms = sum(t for _, t, _ in _device_kernels(prof))
    out = dict(events_ms=start.elapsed_time(end), device_ms=device_ms, wall_ms=wall_ms,
               host_ms=wall_ms - device_ms, idle_share=1.0 - device_ms / wall_ms,
               launches=sum(1 for e in prof.events() if e.name in _LAUNCH_CALLS),
               peak_mb=(torch.cuda.max_memory_allocated() - base) / 2**20)
    if n_ops is None:
        out.update(bound_ms=None, bound_by="host")
    else:
        out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, n_ops)
    return out, result


def _analysis_bounds(side: int) -> tuple[dict, dict]:
    """(bytes, FP32 operations) of each device stage at a side x side map:
    every input read once, every output written once; operations counted
    per edge or pixel and per symmetry operator or orbit row (a Hamilton
    product 28, a four-term dot 8, an angle 10, a power 2 as exp and log at
    the FP32 rate: the data sheet gives no special-function rate)."""
    from latice_tpu_torch.crystal import (
        CSL_CUBIC,
        TEXTURE_COMPONENTS,
        component_orbit,
        csl_orbit,
        csl_rotation,
    )

    n, e, s = side * side, 2 * side * (side - 1), 24
    k_csl = max(len(csl_orbit(csl_rotation(x))) for x in CSL_CUBIC)
    k_comp = max(len(component_orbit(v)) for v in TEXTURE_COMPONENTS.values())
    t_csl, t_comp, points = (len(CSL_CUBIC) + 1) * k_csl, len(TEXTURE_COMPONENTS) * k_comp, 16384
    return dict(
        fields=(n * 12 + 2 * n * 4, e * s * (28 + 28 + 10)),
        grain_statistics=(n * 12 + n * 16, n * s * (28 + 28 + 10)),
        cleanup=(n * 12 + 2 * n * 4, e * s * (28 + 28 + 10)),
        csl=(n * 12 + 2 * n * 2, e * (28 + t_csl * 10)),
        schmid=(n * 12 + n * 8, n * (40 + 18 + 12 * 14)),
        components=(n * 12 + n * 6, n * (40 + t_comp * 10)),
        texture_index=(n * 12 + n * 16 + points * 20, points * s * n * (8 + 2 + 2)),
        gnd=(n * 12 + n * 2 * 3 * 8, e * s * (28 + 28) + e * 30),
    ), dict(csl_columns=t_csl, component_columns=t_comp)


def _near_edges(crop: np.ndarray, sigmas) -> tuple[np.ndarray, np.ndarray]:
    """Masks of the crop's edges (east, south) and pixels whose angle lies
    within ANALYZE_NEAR_DEG of the boundary threshold, a Brandon limit, the
    component radius or a tie between two components, on the card."""
    from latice_tpu_torch.crystal import (
        TEXTURE_COMPONENTS,
        brandon_tolerance_deg,
        component_orbit,
        csl_orbit,
        csl_rotation,
    )
    from latice_tpu_torch.crystal.components import _component_deviations
    from latice_tpu_torch.crystal.csl import _deviation_fields

    def packed(orbits):
        k = max(len(o) for o in orbits)
        out, valid = np.zeros((len(orbits), k, 4), np.float32), np.zeros((len(orbits), k), bool)
        for i, o in enumerate(orbits):
            out[i, :len(o)], valid[i, :len(o)] = o, True
        return torch.as_tensor(out, device="cuda"), torch.as_tensor(valid, device="cuda")

    e = torch.as_tensor(crop.astype(np.float32), device="cuda")
    limits = np.asarray([5.0] + [brandon_tolerance_deg(x) for x in sigmas])
    orbits = [csl_orbit(np.asarray([1.0, 0.0, 0.0, 0.0]))] + [csl_orbit(csl_rotation(x))
                                                              for x in sigmas]
    near = []
    for dev in _deviation_fields(e, *packed(orbits)):
        near.append((np.abs(dev.cpu().numpy() - limits) < ANALYZE_NEAR_DEG).any(-1))
    east = np.zeros(crop.shape[:2], bool)
    south = np.zeros(crop.shape[:2], bool)
    east[:, :-1], south[:-1] = near
    comp = _component_deviations(e.reshape(-1, 3), *packed(
        [component_orbit(v) for v in TEXTURE_COMPONENTS.values()])).cpu().numpy()
    top2 = np.sort(comp, axis=1)[:, :2]
    px = ((np.abs(comp - 15.0) < ANALYZE_NEAR_DEG).any(1)
          | ((top2[:, 1] - top2[:, 0] < ANALYZE_NEAR_DEG) & (top2[:, 0] <= 15.0)))
    return np.concatenate([east.ravel(), south.ravel()]), px.reshape(crop.shape[:2])


def _hold_analysis(card: str, cpu: str, near_edges: np.ndarray, near_px: np.ndarray) -> dict:
    """The card's `analyze` files against the CPU's at the phase's
    tolerances; what differs is reported."""
    def load(prefix, tag):
        return np.load(f"{prefix}_{tag}.npy")

    out = {}
    for tag in ("grains", "boundaries", "cleaned", "taylor", "youngs"):
        if not np.array_equal(load(card, tag), load(cpu, tag)):
            raise AssertionError(f"analyze crop: {tag} card != CPU")
    kam = float(np.abs(load(card, "kam") - load(cpu, "kam")).max())
    csl = np.concatenate([np.concatenate([load(p, "csl_east").ravel(), load(p, "csl_south").ravel()])
                          [None] for p in (card, cpu)])
    csl_off = int(((csl[0] != csl[1]) & ~near_edges).sum())
    comp_off = int(((load(card, "components") != load(cpu, "components")) & ~near_px).sum())
    schmid = float(np.abs(load(card, "schmid") / load(cpu, "schmid") - 1).max())
    gnd_c, gnd_p = load(card, "gnd"), load(cpu, "gnd")
    gnd_valid_equal = bool(np.array_equal(np.isfinite(gnd_c), np.isfinite(gnd_p)))
    scale = float(np.nanmedian(gnd_p))
    gnd = float(np.nanmax(np.abs(gnd_c - gnd_p) / (np.abs(gnd_p) + scale)))
    with np.load(f"{card}_grain_stats.npz") as a, np.load(f"{cpu}_grain_stats.npz") as b:
        sizes_equal = bool(np.array_equal(a["sizes_px"], b["sizes_px"]))
        mean_deg = float(_disorientation_deg(a["mean_orientation"], b["mean_orientation"]).max())
        gos = float(np.abs(np.cos(np.radians(a["gos_deg"].astype(np.float64)) / 2)
                           - np.cos(np.radians(b["gos_deg"].astype(np.float64)) / 2)).max())
    out = dict(kam_max_deg=kam, csl_off_near=csl_off, csl_near_edges=int(near_edges.sum()),
               components_off_near=comp_off, components_near_px=int(near_px.sum()),
               schmid_max_rel=schmid, gnd_max_rel=gnd, gnd_valid_equal=gnd_valid_equal,
               stats_sizes_equal=sizes_equal, stats_mean_max_deg=mean_deg, gos_cos_max=gos)
    if not (kam <= ANALYZE_NEAR_DEG and csl_off == 0 and comp_off == 0
            and schmid <= ANALYZE_RTOL and gnd <= ANALYZE_RTOL and gnd_valid_equal
            and sizes_equal and mean_deg < 1e-3 and gos <= 1e-6):
        raise AssertionError(f"analyze crop, card vs CPU: {out}")
    return out


def _hold_analyze_readings(got: dict, want: dict, near_edges: int, near_px: int) -> dict:
    """The card's crop readings against the JAX package's (JAX_ANALYZE)."""
    equal = ("n_grains", "cleaned_px", "grains_sha", "boundaries_sha", "sizes_sha", "gnd_valid")
    off = {k: (got[k], want[k]) for k in equal if got[k] != want[k]}
    for k in ("mean_kam_deg", "mean_gos_deg"):
        if abs(got[k] - want[k]) > ANALYZE_NEAR_DEG:
            off[k] = (got[k], want[k])
    for k in ("mean_schmid", "mean_taylor", "mean_youngs_gpa", "mean_gnd_per_m2"):
        if abs(got[k] / want[k] - 1) > ANALYZE_RTOL:
            off[k] = (got[k], want[k])
    if abs(got["texture_index"] - want["texture_index"]) > ANALYZE_RTOL * want["texture_index"] + 1e-4:
        off["texture_index"] = (got["texture_index"], want["texture_index"])
    mean_deg = float(_disorientation_deg(got["mean_orientation_first"],
                                         want["mean_orientation_first"]).max())
    if not mean_deg < 1e-3:
        off["mean_orientation_first"] = mean_deg

    def count_diff(a, b):
        a, b = ({int(k): v for k, v in x.items()} for x in (a, b))
        return sum(abs(a.get(k, 0) - b.get(k, 0)) for k in set(a) | set(b))

    csl_diff = count_diff(got["csl_counts"], want["csl_counts"])
    comp_diff = count_diff(got["component_counts"], want["component_counts"])
    if csl_diff > 2 * near_edges:
        off["csl_counts"] = (csl_diff, near_edges)
    if comp_diff > 2 * near_px:
        off["component_counts"] = (comp_diff, near_px)
    if off:
        raise AssertionError(f"analyze crop vs JAX_ANALYZE: {off}")
    return dict(csl_count_diff=csl_diff, component_count_diff=comp_diff,
                mean_orientation_max_deg=mean_deg)


def phase_analyze(workdir: str, ckpt: str, smi: str) -> dict:
    """The orientation-map analysis plane. The chain users run: ``query
    --engine fused --ang --scan-grid 64 64`` of the dictionary phase's scan
    (its K2f and K1 launches are the path's), then ``analyze`` of that
    ``.ang`` with ANALYZE_FLAGS. Then a seeded 1024x1024 map of 4,096
    grains with planted Σ3 twins and Cube and Goss grains through
    ``analyze`` (traced: wall, device busy, idle share), held to its
    truth: its grains are the noise-free map's, every planted twin edge is
    Σ3 and the Σ3 and Cube and Goss shares exceed the planted ones by no
    more than the maps with nothing planted give; each stage alone, with
    its bound, launches and peak memory; the top-left 128x128 crop, card
    against the port's CPU path and against the JAX package's readings
    (JAX_ANALYZE); and ``analyze --parent ks`` of a 512x512 martensite map,
    whose planted parents must come back."""
    from latice_tpu_torch import crystal as cr
    from latice_tpu_torch.ops import (
        candidate_consensus_fused,
        cosine_topk_fused,
        instance_norm_leaky_relu,
    )
    from latice_tpu_torch.sim import simulate_patterns

    root = Path(workdir) / "analyze"
    root.mkdir()
    out = {}
    t_phase = time.perf_counter()
    common = ["--checkpoint", ckpt, "--inplanes", str(INPLANES), "--latent-dim", str(LATENT),
              "--batch-size", str(BATCH)]

    # 1. The chain: query of the dictionary phase's scan, analyze of its .ang.
    steps = {}
    dictionary = Path(workdir) / "dictionary"
    db, scan_npy = dictionary / "dict_db.npz", dictionary / "scan_u8.npy"
    if not db.exists():  # --analyze-only runs no dictionary phase: its files, made here
        db, scan_npy = root / "dict_db.npz", root / "scan_u8.npy"
        grid, dict_npy = str(root / "grid.txt"), str(root / "dict.npy")
        steps["sample"] = _index_cli(["sample", "--group", DICT_GROUP, "--resolution",
                                      str(DICT_RESOLUTION), "--out", grid])
        steps["simulate"] = _index_cli(["simulate", "--angles", grid, "--out", dict_npy,
                                        "--uint8"])
        steps["build"] = _index_cli(["build", "--patterns", dict_npy, "--angles", grid, "--db",
                                     str(db)] + common)
        rng = np.random.default_rng(20)  # the dictionary phase's scan, drawn as it draws it
        clean = simulate_patterns(_grain_scan(rng))
        noisy = clean + rng.standard_normal(clean.shape, dtype=np.float32) * SCAN_NOISE
        np.save(scan_npy, np.round(np.clip(noisy, 0.0, 1.0) * 255.0).astype(np.uint8))
    counters = (instance_norm_leaky_relu, cosine_topk_fused, candidate_consensus_fused)
    for fn in counters:
        fn.launches = 0
    ang = str(root / "scan.ang")
    steps["query"] = _index_cli(["query", "--patterns", str(scan_npy), "--db", str(db), "--out",
                                 str(root / "scan.npy"), "--engine", "fused", "--ang", ang,
                                 "--scan-grid", str(SCAN_SIDE), str(SCAN_SIDE)] + common)
    steps["analyze"] = _index_cli(["analyze", "--orientations", ang, "--out-prefix",
                                   str(root / "chain")] + ANALYZE_FLAGS)
    launches = {fn.__name__: fn.launches for fn in counters}
    query_batches = SCAN_SIDE**2 // BATCH
    want_launches = {"instance_norm_leaky_relu": 10 * query_batches,
                     "cosine_topk_fused": query_batches,
                     "candidate_consensus_fused": query_batches}
    chain = steps["analyze"]["summary"]
    keys = ("grain_stats", "csl_fractions", "mean_schmid", "mean_taylor", "mean_youngs_gpa",
            "gnd_valid_fraction", "component_fractions", "texture_index", "cleaned_px")
    if not (launches == want_launches and all(k in chain for k in keys)
            and np.load(root / "chain_grains.npy").shape == (SCAN_SIDE, SCAN_SIDE)
            and np.isfinite(chain["texture_index"]) and chain["n_grains"] >= 1):
        raise AssertionError(f"analyze chain: launches {launches} (want {want_launches}), "
                             f"summary {chain}")
    out["chain"] = dict(steps=steps, launches=launches)
    _progress("analyze", t_phase, "chain")

    # 2. The full-size map through the CLI, traced, and held to its truth.
    t0 = time.perf_counter()
    truth = analyze_truth()
    out["truth_s"] = time.perf_counter() - t0
    side = ANALYZE_SIDE
    euler = truth["euler"].astype(np.float32)
    big, prefix = str(root / "map.npy"), str(root / "map")
    np.save(big, euler.reshape(-1, 3))
    torch.cuda.reset_peak_memory_stats()
    cli_trace, cli = _traced_call(lambda: _index_cli(
        ["analyze", "--orientations", big, "--grid", str(side), str(side), "--out-prefix",
         prefix] + ANALYZE_FLAGS))
    summary = cli["summary"]
    out["cli"] = dict(**cli_trace, peak_mb=torch.cuda.max_memory_allocated() / 2**20,
                      summary={k: v for k, v in summary.items() if k != "outputs"})
    _progress("analyze", t_phase, "cli")
    grains = np.load(f"{prefix}_grains.npy")
    # The noise-free map through the same cleanup (fragments of under 4 px,
    # left where a Voronoi cell touches itself only diagonally, dissolve
    # into a neighbour) and segmentation.
    clean, clean_filled, _ = cr.clean_orientation_map(truth["clean"], min_grain_px=4)
    clean_grains, _ = cr.label_grains(cr.misorientation_maps(clean))
    # The plants are held on the pixels the cleanup left as they were, and
    # on the edges between two such pixels.
    valid = (np.load(f"{prefix}_cleaned.npy").reshape(euler.shape) == euler).all(-1)
    valid_edges = np.concatenate([np.pad(valid[:, :-1] & valid[:, 1:], ((0, 0), (0, 1))),
                                  np.pad(valid[:-1] & valid[1:], ((0, 1), (0, 0)))]).reshape(-1)
    owner = truth["owner"]
    twin_key = set((truth["twins"].min(1) * ANALYZE_GRAINS + truth["twins"].max(1)).tolist())

    def edge_keys(a, b):
        return np.minimum(a, b) * ANALYZE_GRAINS + np.maximum(a, b)

    twin_edges = np.concatenate([
        np.pad(np.isin(edge_keys(owner[:, :-1], owner[:, 1:]), list(twin_key)), ((0, 0), (0, 1))),
        np.pad(np.isin(edge_keys(owner[:-1], owner[1:]), list(twin_key)), ((0, 1), (0, 0)))
    ]).reshape(-1) & valid_edges

    def csl_of(east, south):
        return np.concatenate([east.ravel(), south.ravel()])

    csl = csl_of(np.load(f"{prefix}_csl_east.npy"), np.load(f"{prefix}_csl_south.npy"))
    none = cr.classify_csl_boundaries(truth["no_twins"])
    csl_none = csl_of(none.east, none.south)
    s3 = summary["csl_sigmas"].index("3")
    boundary = (csl != -2) & valid_edges
    f3 = float(((csl == s3) & valid_edges).sum() / boundary.sum())
    planted3 = float(twin_edges.sum() / boundary.sum())
    f3_none = float(((csl_none == s3) & valid_edges).sum() / ((csl_none != -2) & valid_edges).sum())
    comps = np.load(f"{prefix}_components.npy")
    names = summary["component_names"]
    none_comp = cr.texture_component_fractions(truth["no_components"])
    shares = {}
    for name in ("cube", "goss"):  # in valid pixels
        k = names.index(name)
        shares[name] = dict(planted=int((np.isin(owner, truth[name]) & valid).sum()),
                            got=int(((comps == k) & valid).sum()),
                            nothing_planted=int(((none_comp.labels == k) & valid).sum()))
        if not (shares[name]["planted"] <= shares[name]["got"]
                <= shares[name]["planted"] + shares[name]["nothing_planted"]):
            raise AssertionError(f"analyze {name} pixels: {shares[name]}")
    held = dict(n_grains=summary["n_grains"], clean_n_grains=int(clean_grains.max()) + 1,
                grains_equal_noise_free=bool(np.array_equal(grains, clean_grains)),
                twin_edges=int(twin_edges.sum()),
                twin_edges_sigma3=int((csl[twin_edges] == s3).sum()), sigma3=f3,
                sigma3_planted=planted3, sigma3_no_twins=f3_none, components=shares,
                cleaned_px=summary["cleaned_px"], clean_cleaned_px=int(clean_filled.sum()),
                unchanged_px=int(valid.sum()))
    if not (held["grains_equal_noise_free"] and held["twin_edges_sigma3"] == held["twin_edges"]
            and planted3 <= f3 <= planted3 + f3_none
            and held["cleaned_px"] == held["clean_cleaned_px"]):
        raise AssertionError(f"analyze full-size map against its truth: {held}")
    out["truth"] = held
    _progress("analyze", t_phase, "truth")

    # 3. Each stage alone on the full-size map.
    bounds, columns = _analysis_bounds(side)
    stages = {}

    def run(name, fn, device=True):
        stages[name], result = _analysis_stage(fn, *(bounds.get(name, (None, None))
                                                     if device else (None, None)))
        return result

    maps = run("fields", lambda: cr.misorientation_maps(euler))
    labels, _ = run("labelling", lambda: cr.label_grains(maps), device=False)
    run("kam", lambda: (cr.kernel_average_misorientation(maps), cr.grain_boundary_mask(maps)),
        device=False)
    run("grain_statistics", lambda: cr.grain_statistics(euler, labels))
    run("cleanup", lambda: cr.clean_orientation_map(euler, min_grain_px=4))
    run("csl", lambda: cr.classify_csl_boundaries(euler))
    run("schmid", lambda: cr.schmid_factors(euler, (0.0, 0.0, 1.0)))
    run("taylor", lambda: cr.taylor_factors(euler, (0.0, 0.0, 1.0)), device=False)
    run("components", lambda: cr.texture_component_fractions(euler))
    run("texture_index", lambda: cr.texture_index(cr.make_odf(euler)))
    run("gnd", lambda: cr.gnd_density(euler, 1.0, 0.25))
    run("youngs", lambda: cr.directional_youngs_modulus(euler, stiffness="ni"), device=False)
    out["stages"] = dict(side=side, **columns, by_stage=stages)
    _progress("analyze", t_phase, "stages")

    # 4. The crop: card against the port's CPU path and the JAX readings.
    crop = euler[:ANALYZE_CROP, :ANALYZE_CROP]
    crop_npy = str(root / "crop.npy")
    np.save(crop_npy, crop.reshape(-1, 3))
    argv = ["analyze", "--orientations", crop_npy, "--grid", str(ANALYZE_CROP),
            str(ANALYZE_CROP)] + ANALYZE_FLAGS
    card = _index_cli(argv + ["--out-prefix", str(root / "crop_card")])
    cpu = _index_cli(argv + ["--out-prefix", str(root / "crop_cpu"), "--device", "cpu"])
    near_edges, near_px = _near_edges(crop, card["summary"]["csl_sigmas"])
    vs_cpu = _hold_analysis(str(root / "crop_card"), str(root / "crop_cpu"), near_edges, near_px)
    ti = (card["summary"]["texture_index"], cpu["summary"]["texture_index"])
    if abs(ti[0] - ti[1]) > ANALYZE_RTOL * ti[1] + 1e-4:
        raise AssertionError(f"analyze crop texture index card {ti[0]}, CPU {ti[1]}")
    readings = analyze_readings(card["summary"], str(root / "crop_card"))
    if JAX_ANALYZE is None:
        raise AssertionError("JAX_ANALYZE is empty: run examples/analyze_jax_reference.py")
    vs_jax = _hold_analyze_readings(readings, JAX_ANALYZE["readings"], int(near_edges.sum()),
                                    int(near_px.sum()))
    out["crop"] = dict(side=ANALYZE_CROP, input_sha=_sha(crop), jax_input_sha=JAX_ANALYZE[
        "input_sha"], card_s=card["wall_s"], cpu_s=cpu["wall_s"], vs_cpu=vs_cpu, vs_jax=vs_jax,
        texture_index=ti, readings=readings)
    _progress("analyze", t_phase, "crop")

    # 5. Parent reconstruction of a forward-simulated martensite map.
    parent = analyze_parent_truth()
    p_npy = str(root / "parent.npy")
    np.save(p_npy, parent["euler"].astype(np.float32).reshape(-1, 3))
    rec = _index_cli(["analyze", "--orientations", p_npy, "--grid", str(ANALYZE_PARENT_SIDE),
                      str(ANALYZE_PARENT_SIDE), "--parent", "ks", "--out-prefix",
                      str(root / "parent")])
    got = np.load(root / "parent_parent_grains.npy")
    orient = np.load(root / "parent_parent_orientations.npy").reshape(-1, 3)
    children = np.load(root / "parent_grains.npy")
    truth_id = parent["parent"]
    # Each planted parent: the label most of its pixels carry, which must
    # be its own, and that label's orientation. A child whose candidate fan
    # meets a neighbouring parent's within the tolerance may join it (the
    # JAX package's reconstruction does the same on this map): counted,
    # and held to ANALYZE_PARENT_STRAY_SHARE of the child grains.
    majority = [np.bincount(got[truth_id == p]).argmax() for p in range(ANALYZE_PARENTS)]
    at = [np.argmax(((truth_id == p) & (got == m)).ravel()) for p, m in enumerate(majority)]
    truth_euler = cr.to_euler_zxz_deg(torch.from_numpy(parent["parent_q"])).numpy()
    err = _disorientation_deg(orient[at], truth_euler, compose="sample")
    _, first = np.unique(children, return_index=True)  # a pixel of each child grain
    n_children = len(first)
    stray = int((got.ravel()[first] != np.asarray(majority)[truth_id.ravel()[first]]).sum())
    recovered = dict(n_parents=rec["summary"]["n_parents"], n_child_grains=n_children,
                     distinct=len(set(majority)) == ANALYZE_PARENTS, max_err_deg=float(err.max()),
                     stray_children=stray, mean_fit_deg=rec["summary"]["mean_parent_fit_deg"],
                     wall_s=rec["wall_s"])
    if not (recovered["distinct"] and err.max() < ANALYZE_PARENT_HOLD_DEG
            and stray <= ANALYZE_PARENT_STRAY_SHARE * n_children):
        raise AssertionError(f"analyze --parent ks: {recovered}")
    out["parent"] = recovered
    emit("analyze", card=smi, **out,
         timed_as="events_ms: CUDA events around one call; device_ms: profiler sums; "
                  "launches: runtime launch calls (stages), device activities (cli); wall_ms, "
                  "host_ms (= wall - device), "
                  "wall_s: host clock; idle_share: 1 - device busy / wall; peak_mb: "
                  "max_memory_allocated above the stage's start")
    return launches


def _gate_launches() -> dict:
    """The K2f, K2b, K4 and K5 launches one gate run makes: 19 K2f and K2b
    per train step; 10 K2f per encoded batch of 512 (the dictionary three
    times, the on-grid queries twice, the off-grid queries four times); 1 K4
    per indexed batch (those six pipelines and pattern DI's); 1 K5 per
    pattern DI batch (the exact engine over its bf16 table)."""
    g = EXAMPLES_GATE
    dict_batches = -(-g["grid"] ** 3 // 512)
    query_batches = -(-g["n_query"] // g["pipe_batch"])
    encodes = 3 * dict_batches + 6 * query_batches
    return {"instance_norm_leaky_relu": 19 * g["steps"] + 10 * encodes,
            "instance_norm_leaky_relu_backward": 19 * g["steps"],
            "candidate_consensus_fused": 7 * query_batches,
            "cosine_topk_wide": query_batches}


def _gate_row(readings: dict, tag: str) -> dict:
    return {k: v for k, v in readings[tag].items() if k != "result"}


def phase_examples(workdir: str, smi: str) -> dict:
    """The examples' twins on the card: the accuracy gate
    (`examples.accuracy_benchmark_torch.main`) in the default and
    ``--kinematical`` modes at the script's sizes, each row held to
    `EXAMPLES_BANDS` and its launches to `_gate_launches`; then the six
    demos at their defaults, each holding its own asserts. The launches of
    the whole phase are the ``examples`` path's."""
    from examples import accuracy_benchmark_torch as gate
    from latice_tpu_torch.ops import (
        candidate_consensus_fused,
        cosine_topk_wide,
        instance_norm_leaky_relu,
        instance_norm_leaky_relu_backward,
    )

    t_phase = time.perf_counter()
    counters = (instance_norm_leaky_relu, instance_norm_leaky_relu_backward,
                candidate_consensus_fused, cosine_topk_wide)
    totals = dict.fromkeys((fn.__name__ for fn in counters), 0)
    out: dict = {"card": smi, "gate": {}, "demos": {}}

    def counted(fn, *args, **kw):
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            result = fn(*args, **kw)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        for k, v in launches.items():
            totals[k] += v
        return result, launches, time.perf_counter() - t0, buf.getvalue().splitlines()

    for mode in EXAMPLES_GATE_MODES:
        readings, launches, wall_s, lines = counted(gate.main, render=mode, device="cuda",
                                                    **EXAMPLES_GATE)
        want = _gate_launches()
        if launches != want:
            raise AssertionError(f"gate {mode}: launches {launches}, want {want}")
        rows = {tag: _gate_row(readings, tag) for tag in readings
                if isinstance(readings[tag], dict)}
        for tag, (least, most) in EXAMPLES_BANDS[mode].items():
            row = rows[tag]
            if not ((least is None or row["success"] >= least)
                    and row["median_err_deg"] <= most):
                raise AssertionError(f"gate {mode} {tag}: {row} outside ({least}, {most})")
        if not np.isfinite(readings["final_loss"]):
            raise AssertionError(f"gate {mode}: final loss {readings['final_loss']}")
        out["gate"][mode] = dict(rows=rows, final_loss=readings["final_loss"],
                                 train_s=readings["train_s"], di_s=readings["di_s"],
                                 wall_s=wall_s, launches=launches, printed=lines)
        _progress("examples", t_phase, f"gate {mode}")

    import importlib

    args = {
        "end_to_end": ["--workdir", f"{workdir}/end_to_end"],
        "orientation_map": ["--out", f"{workdir}/orientation_map.png"],
        "multiphase": [],
        "raw_data": [],
        "full_workflow": [],
        "parent_reconstruction": ["--out", f"{workdir}/parent_reconstruction.png"],
    }
    for name in EXAMPLES_DEMOS:
        demo = importlib.import_module(f"examples.{name}_demo_torch")
        # The demo's own asserts raise here, failing the phase.
        result, launches, wall_s, lines = counted(demo.main, args[name], device="cuda")
        figures = {k: v for k, v in result.items() if isinstance(v, (int, float, str, bool))}
        if name == "full_workflow":
            os.remove(result["ang_path"])
        out["demos"][name] = dict(figures=figures, launches=launches, wall_s=wall_s,
                                  printed=lines)
        _progress("examples", t_phase, name)
    for name in ("orientation_map", "multiphase"):
        if not (out["demos"][name]["launches"]["instance_norm_leaky_relu_backward"] > 0
                and np.isfinite(out["demos"][name]["figures"]["final_loss"])):
            raise AssertionError(f"{name}: {out['demos'][name]}")
    for name in ("raw_data", "full_workflow", "end_to_end"):
        if not out["demos"][name]["launches"]["instance_norm_leaky_relu"] > 0:
            raise AssertionError(f"{name} encoded without K2f: {out['demos'][name]}")
    emit("examples", **out, launches=totals, phase_s=time.perf_counter() - t_phase)
    return totals


def _synthetic_patterns(n: int, seed: int) -> np.ndarray:
    """``n`` seeded 128x128 float32 patterns in [0, 1]: three bright bands
    (Kikuchi-like lines) each, over a smooth background."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:128, 0:128].astype(np.float32) / 127.0 - 0.5
    background = 0.3 + 0.2 * (1.0 - 2.0 * (xx * xx + yy * yy))
    out = np.empty((n, 128, 128), np.float32)
    for start in range(0, n, 64):
        m = min(64, n - start)
        theta = rng.uniform(0, np.pi, (m, 3, 1, 1)).astype(np.float32)
        offset = rng.uniform(-0.4, 0.4, (m, 3, 1, 1)).astype(np.float32)
        width = rng.uniform(0.02, 0.06, (m, 3, 1, 1)).astype(np.float32)
        d = xx * np.cos(theta) + yy * np.sin(theta) - offset
        bands = np.exp(-((d / width) ** 2)).sum(axis=1)
        out[start : start + m] = np.clip(background + 0.5 * bands, 0.0, 1.0)
    return out


def phase_train(workdir: str, smi: str) -> tuple[dict, torch.nn.Module]:
    """Two epochs of ``cli.train``'s path at the conf defaults, on the card."""
    from latice_tpu_torch.cli.train import train
    from latice_tpu_torch.config import load_config
    from latice_tpu_torch.models import load_checkpoint
    from latice_tpu_torch.ops import instance_norm_leaky_relu, instance_norm_leaky_relu_backward

    root = Path(workdir) / "train"
    root.mkdir()
    patterns = _synthetic_patterns(TRAIN_PATTERNS, seed=3)
    np.save(root / "patterns.npy", patterns)
    with open(root / "angles.txt", "w") as f:
        f.write(f"zxz\n{TRAIN_PATTERNS}\n")
        np.savetxt(f, np.random.default_rng(4).uniform(0, 360, (TRAIN_PATTERNS, 3)), fmt="%.4f")
    overrides = [
        f"data_module.path={root / 'patterns.npy'}",
        f"data_module.rot_angles_path={root / 'angles.txt'}",
        "trainer.max_epochs=2",
        f"trainer.checkpoint_dir={root / 'checkpoints'}",
        f"trainer.logger.save_dir={root / 'logs'}",
        "trainer.log_every_n_steps=1",
    ]
    config = load_config(Path(__file__).resolve().parent / "conf", "train.yaml", overrides)
    used = dict(precision=config["trainer"]["precision"],
                batch_size=config["data_module"]["batch_size"],
                inplanes=config["lightning_module"]["model"]["inplanes"],
                latent_dim=config["lightning_module"]["model"]["latent_dim"],
                kl_lambda=config["lightning_module"]["kl_lambda"],
                optimizer=config["lightning_module"]["optimizer_partial"])
    if (used["precision"], used["batch_size"], used["inplanes"], used["latent_dim"]) != (
        "16-mixed", TRAIN_BATCH, INPLANES, LATENT
    ):
        raise AssertionError(f"conf defaults are not the full-width run: {used}")

    counters = (instance_norm_leaky_relu, instance_norm_leaky_relu_backward)
    bar_stream, figure_log = io.StringIO(), _Captured("latice_tpu_torch.train.trainer")
    rich_installed = importlib.util.find_spec("rich") is not None
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    # rich draws nothing on a stream that is not a terminal; hidden, the
    # bar draws its plain line, which the phase reads back.
    with contextlib.redirect_stderr(bar_stream), figure_log, _hidden("rich"):
        trainer, model = train(config, device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    if not model.decoder.fuse_upsample:
        raise AssertionError("the trained decoder is not the fused one (the default)")
    bar = dict(_bar_lines(bar_stream.getvalue(), trainer.steps_run, 2),
               rich_installed=rich_installed)
    figure = _figure_outcome(root / "logs", figure_log.messages, 2)

    n_train, n_val = trainer.steps_run["train"], trainer.steps_run["val"]
    if (n_train, n_val) != (20, 4):
        raise AssertionError(f"ran {n_train} train and {n_val} eval steps, want 20 and 4")
    want = {"instance_norm_leaky_relu": 19 * (n_train + n_val),
            "instance_norm_leaky_relu_backward": 19 * n_train}
    if launches != want:
        raise AssertionError(f"train launches {launches}, want {want}")

    with open(root / "logs" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    step_losses = [float(r["train_loss"]) for r in rows if r.get("train_loss")]
    if len(step_losses) != n_train or not all(np.isfinite(step_losses)):
        raise AssertionError(f"step losses {step_losses}")
    if not step_losses[-1] < step_losses[0]:
        raise AssertionError(f"loss did not fall: first {step_losses[0]}, last {step_losses[-1]}")
    for epoch in trainer.history:
        if not all(np.isfinite(v) for v in epoch.values()):
            raise AssertionError(f"non-finite epoch metrics {epoch}")
    kept = sorted(p.name for p in (root / "checkpoints").iterdir())

    loaded = load_checkpoint(str(root / "checkpoints" / "last.pt"), INPLANES, LATENT, device="cuda")
    model.set_precision("32").eval()
    x = torch.from_numpy(patterns[:64, None]).cuda()
    with torch.no_grad():
        want_mu, got_mu = model.encode(x)[0], loaded.encode(x)[0]
    ckpt_err = (want_mu - got_mu).abs().max().item()
    if not ckpt_err <= 1e-6:
        raise AssertionError(f"last.pt encodes {ckpt_err} away from the trained model")

    last = trainer.history[-1]
    n_rows = TRAIN_PATTERNS - int(TRAIN_PATTERNS * config["data_module"]["val_data_ratio"])
    emit("train", config=used, wall_s=wall_s, train_steps=n_train, eval_steps=n_val,
         launches=launches, launches_per_train_step=dict(
             instance_norm_leaky_relu=19, instance_norm_leaky_relu_backward=19),
         first_step_loss=step_losses[0], last_step_loss=step_losses[-1],
         history=trainer.history, checkpoints=kept, checkpoint_encode_max_abs_err=ckpt_err,
         epoch2_train_steps_per_s=(n_train // 2) / last["epoch_time_s"],
         epoch2_patterns_per_s=n_rows / last["epoch_time_s"],
         timed_as="epoch 2's wall clock, its 2 eval steps included",
         decoder="fused", progress_bar=bar, reconstruction_figure=figure, card=smi)
    return launches, model


class _Captured(logging.Handler):
    """The messages one logger emits inside the block."""

    def __init__(self, name: str) -> None:
        super().__init__(logging.INFO)
        self.target, self.messages = logging.getLogger(name), []

    def emit(self, record: logging.LogRecord) -> None:
        self.messages.append(record.getMessage())

    def __enter__(self):
        self.level = self.target.level
        self.target.setLevel(logging.INFO)
        self.target.addHandler(self)
        return self

    def __exit__(self, *exc) -> None:
        self.target.removeHandler(self)
        self.target.setLevel(self.level)


@contextlib.contextmanager
def _hidden(package: str):
    """``package`` cannot be imported inside the block."""
    saved = {n: m for n, m in sys.modules.items()
             if n == package or n.startswith(package + ".")}
    hidden = set(saved) | {package}
    sys.modules.update(dict.fromkeys(hidden))
    try:
        yield
    finally:
        for n in hidden:
            del sys.modules[n]
        sys.modules.update(saved)


def _bar_lines(text: str, steps_run: dict, epochs: int) -> dict:
    """The trainer's plain progress bar, read from its stderr: each epoch's
    last state, printed on stderr as one line per epoch. Held: every epoch
    drew its train and val steps."""
    states = [t.strip() for t in text.split("\r") if t.strip()]
    train_steps = steps_run["train"] // epochs
    lines = []
    for epoch in range(epochs):
        train = [t for t in states if t.startswith(f"epoch {epoch} train: ")]
        val = [t for t in states if t.startswith(f"epoch {epoch} val: ")]
        if not (train and val and train[-1].startswith(
                f"epoch {epoch} train: {train_steps}/{train_steps} ")):
            raise AssertionError(f"progress bar of epoch {epoch}: {train[-1:]} {val[-1:]}")
        lines.append(f"{train[-1]} | {val[-1][len(f'epoch {epoch} '):]}")
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    return dict(lines=lines, bytes=len(text))


def _figure_outcome(log_dir: Path, messages: list[str], epochs: int) -> str:
    """What became of the reconstruction figure, as the logger shows it: the
    images the CSV logger wrote, or the trainer's warning when matplotlib is
    absent. Anything else fails."""
    images = sorted(p.name for p in (log_dir / "images").glob("reconstruction_eval_check_*"))
    failed = [m for m in messages if m.startswith("Reconstruction figure logging failed")]
    if len(images) == epochs and not failed:
        return f"logged: {', '.join(images)}"
    if (not images and len(failed) == epochs
            and importlib.util.find_spec("matplotlib") is None
            and all("matplotlib" in m for m in failed)):
        return "skipped: matplotlib absent"
    raise AssertionError(f"reconstruction figure: images {images}, warnings {failed}")


def _one_step_grads(model, x: torch.Tensor, eps: torch.Tensor, loss_fn) -> tuple[dict, int, int]:
    """One step's gradients of ``model`` on batch ``x`` with noise ``eps``
    (no update), the peak device memory of the step, and the K2f launches
    it made."""
    from latice_tpu_torch.ops import instance_norm_leaky_relu

    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    instance_norm_leaky_relu.launches = 0
    out = model(x, eps=eps)
    loss_fn(*out, x, None)["loss"].backward()
    torch.cuda.synchronize()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return grads, torch.cuda.max_memory_allocated(), instance_norm_leaky_relu.launches


def phase_train_robust(workdir: str, smi: str) -> dict:
    """``cli.train trainer=robust data_module=streamed`` at full width
    (inplanes 32, latent 16, batch 64, 16-mixed; the conf's augmentation
    with the denoising objective) for 2 epochs over a seeded ``.up2`` scan
    of `ROBUST_PATTERNS`, streamed batch by batch; the counters, zeroed just
    before, must show 19 K2f + 19 K2b launches per train step and 19 + 0
    per eval step. Then the augmentation's application on the card against
    the CPU on the same draws, and one step's gradients with ``remat=stage``
    against ``remat=none`` from the same weights, batch and noise, with the
    peak memory of each and the recompute's K2f launches."""
    from latice_tpu_torch.cli.train import train
    from latice_tpu_torch.config import load_config
    from latice_tpu_torch.data import AugmentConfig
    from latice_tpu_torch.data.augment import apply_augment, draw_augment
    from latice_tpu_torch.models import VariationalAutoEncoderRawData
    from latice_tpu_torch.ops import instance_norm_leaky_relu, instance_norm_leaky_relu_backward
    from latice_tpu_torch.train import VAELoss

    root = Path(workdir) / "train_robust"
    root.mkdir()
    patterns = _synthetic_patterns(ROBUST_PATTERNS, seed=5)
    scan = str(root / "scan.up2")
    _write_up2(scan, np.round(patterns * 65535.0), *ROBUST_GRID)
    overrides = [
        "trainer=robust", "data_module=streamed", f"data_module.path={scan}",
        "trainer.max_epochs=2", f"trainer.checkpoint_dir={root / 'checkpoints'}",
        f"trainer.logger.save_dir={root / 'logs'}", "trainer.log_every_n_steps=1",
    ]
    config = load_config(Path(__file__).resolve().parent / "conf", "train.yaml", overrides)
    tcfg, model_cfg = config["trainer"], config["lightning_module"]["model"]
    used = dict(precision=tcfg["precision"], batch_size=config["data_module"]["batch_size"],
                inplanes=model_cfg["inplanes"], latent_dim=model_cfg["latent_dim"],
                augment={k: v for k, v in tcfg["augment"].items() if k != "_target_"},
                denoising=tcfg["denoising"], data_module=config["data_module"]["_target_"])
    if (used["precision"], used["batch_size"], used["inplanes"], used["latent_dim"],
            used["denoising"]) != ("16-mixed", TRAIN_BATCH, INPLANES, LATENT, True):
        raise AssertionError(f"trainer=robust is not the full-width denoising run: {used}")

    counters = (instance_norm_leaky_relu, instance_norm_leaky_relu_backward)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    trainer, model = train(config, device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    n_train, n_val = trainer.steps_run["train"], trainer.steps_run["val"]
    n_val_rows = int(ROBUST_PATTERNS * config["data_module"]["val_data_ratio"])
    want_steps = (2 * -(-(ROBUST_PATTERNS - n_val_rows) // TRAIN_BATCH),
                  2 * -(-n_val_rows // TRAIN_BATCH))
    if (n_train, n_val) != want_steps:
        raise AssertionError(f"ran {n_train} train and {n_val} eval steps, want {want_steps}")
    want = {"instance_norm_leaky_relu": 19 * (n_train + n_val),
            "instance_norm_leaky_relu_backward": 19 * n_train}
    if launches != want:
        raise AssertionError(f"train_robust launches {launches}, want {want}")
    with open(root / "logs" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    step_losses = [float(r["train_loss"]) for r in rows if r.get("train_loss")]
    if len(step_losses) != n_train or not all(np.isfinite(step_losses)):
        raise AssertionError(f"step losses {step_losses}")
    if not np.mean(step_losses[-5:]) < np.mean(step_losses[:5]):
        raise AssertionError(f"loss did not fall: {step_losses[:5]} ... {step_losses[-5:]}")
    for epoch in trainer.history:
        if not all(np.isfinite(v) for v in epoch.values()):
            raise AssertionError(f"non-finite epoch metrics {epoch}")
    epoch2_s = trainer.history[-1]["epoch_time_s"]
    del trainer, model
    torch.cuda.empty_cache()

    # The augmentation's application, card against CPU on the same draws.
    cfg = AugmentConfig(**used["augment"])
    x = torch.from_numpy(patterns[:TRAIN_BATCH, :, :, None]).cuda()
    draws = draw_augment(cfg, torch.Generator(device="cuda").manual_seed(7), x)
    card = apply_augment(cfg, x, draws)
    cpu = apply_augment(cfg, x.cpu(), type(draws)(*(t.cpu() for t in draws)))
    aug_err = (card.cpu() - cpu).abs().max().item()
    if not aug_err <= AUGMENT_ATOL:
        raise AssertionError(f"augmentation card vs CPU: {aug_err}")

    # remat=stage against remat=none: one step's gradients, peak memory and
    # K2f launches (the stage recompute runs 18 of the 19 norms again).
    gen = torch.Generator().manual_seed(8)
    batch = torch.from_numpy(patterns[:TRAIN_BATCH, None]).cuda()
    eps = torch.randn((TRAIN_BATCH, LATENT), generator=gen).cuda()
    loss_fn = VAELoss(kl_lambda=config["lightning_module"]["kl_lambda"])
    remat = {}
    for mode in ("none", "none", "stage"):
        m = VariationalAutoEncoderRawData(INPLANES, LATENT, remat=mode)
        m.init_weights(torch.Generator().manual_seed(9)).cuda().set_precision("16-mixed").train()
        key = mode if mode not in remat else "none_again"
        remat[key] = _one_step_grads(m, batch, eps, loss_fn)
        del m
    leaf_err = {}
    for name, g in remat["none"][0].items():
        scale = g.abs().max().item() or 1.0
        leaf_err[name] = ((remat["stage"][0][name] - g).abs().max().item() / scale,
                          (remat["none_again"][0][name] - g).abs().max().item() / scale)
    worst = max(leaf_err, key=lambda k: leaf_err[k][0] - 2 * leaf_err[k][1])
    stage_err, repeat_err = leaf_err[worst]
    if not stage_err <= 2 * repeat_err + REMAT_RTOL:
        raise AssertionError(f"remat=stage gradient of {worst}: {stage_err} of its largest, "
                             f"none repeated {repeat_err}")
    recompute = remat["stage"][2] - remat["none"][2]
    if recompute != 18:
        raise AssertionError(f"remat=stage ran {recompute} extra K2f launches, want 18")
    emit("train_robust", config=used, wall_s=wall_s, train_steps=n_train, eval_steps=n_val,
         launches=launches, launches_per_train_step=dict(
             instance_norm_leaky_relu=19, instance_norm_leaky_relu_backward=19),
         first_step_loss=step_losses[0], last_step_loss=step_losses[-1],
         epoch2_patterns_per_s=(ROBUST_PATTERNS - n_val_rows) / epoch2_s,
         timed_as="epoch 2's wall clock, its eval steps included",
         augment_card_vs_cpu=aug_err,
         remat=dict(worst_leaf=worst, stage_vs_none=stage_err, none_repeated=repeat_err,
                    max_memory_mb={k: v[1] / 2**20 for k, v in remat.items()},
                    k2f_launches_per_step={k: v[2] for k, v in remat.items()}),
         card=smi)
    return launches


_NORMED_BIAS = ("encoder.", "decoder.")


def _before_norm_bias(name: str, model) -> bool:
    """A conv bias that an InstanceNorm follows: its exact gradient is 0."""
    from latice_tpu_torch.models import InstanceNormLeakyReLU

    if not (name.startswith(_NORMED_BIAS) and name.endswith(".0.bias")):
        return False
    block = model.get_submodule(name[: -len(".0.bias")])
    return isinstance(block[-1], InstanceNormLeakyReLU)


def _backward_without_means(x, mean, rstd, g, negative_slope=0.02):
    """A wrong norm backward, ``rstd * g_y`` with both mean terms dropped:
    what the parity check must reject."""
    y = (x.float() - mean[..., None, None]) * rstd[..., None, None]
    g_y = torch.where(y >= 0, g.float(), negative_slope * g.float())
    return (rstd[..., None, None] * g_y).to(x.dtype)


def _aten_norm(self, x):
    """ATen's own InstanceNorm + LeakyReLU, differentiated by autograd: the
    gradient reference, independent of the port's fused op."""
    F = torch.nn.functional
    return F.leaky_relu(F.instance_norm(x, eps=1e-5), 0.02)


def _grad_step(state: dict, dev: str, batch, patch=None, dtype=torch.float32, seen=None):
    """One train step on ``dev`` in ``dtype`` from ``state``, under the
    context ``patch`` if given: (loss, {name: grad as f64 on the CPU}). With
    ``seen``, collect the cuDNN flags each convolution ran with into it."""
    import contextlib

    from latice_tpu_torch.models import VariationalAutoEncoderRawData
    from latice_tpu_torch.train import VAELoss, make_optimizer, make_train_step

    model = VariationalAutoEncoderRawData(INPLANES, LATENT)
    model.load_state_dict(state)
    model.to(dev, dtype)
    if seen is not None:
        _conv_flag_probe(model, seen)
    x, mask, eps = (t.to(dev, dtype) for t in batch)
    step = make_train_step(VAELoss(kl_lambda=5e-6))
    with patch or contextlib.nullcontext():
        m = step(model, make_optimizer(model.parameters()), x, mask, 0, eps)
    return float(m["loss"]), {k: p.grad.detach().cpu().double()
                              for k, p in model.named_parameters()}


def phase_train_parity() -> None:
    """One f32 train step at full width, card against CPU, same weights and eps.

    At full width one f32 step's gradient is conditioned at about 1e-2 of
    each leaf's scale: an f32 rounding moves a few activations across
    LeakyReLU's kink or swaps a max-pool's argmax, and each such flip
    reaches every leaf upstream. The CPU's f32 step is as far from an f64
    step as the card's is. So each leaf of the card's gradient is held to
    be as close to a float64 reference (ATen's InstanceNorm + LeakyReLU
    under autograd, on the CPU) as the CPU's f32 gradient is:
    ``card <= GRAD_RATIO * cpu + GRAD_FLOOR``, each the leaf's max abs
    error over its largest reference |grad|. The same step on the card
    with a wrong norm backward (the mean terms dropped) must break that.
    """
    from unittest import mock

    from latice_tpu_torch.models import InstanceNormLeakyReLU, VariationalAutoEncoderRawData
    from latice_tpu_torch.ops import fused_norm

    n = 8
    state = VariationalAutoEncoderRawData(INPLANES, LATENT).init_weights(
        torch.Generator().manual_seed(5)
    ).state_dict()
    batch = (
        torch.from_numpy(_synthetic_patterns(n, seed=6)[:, None]),
        torch.ones(n),
        torch.from_numpy(np.random.default_rng(7).normal(size=(n, LATENT)).astype(np.float32)),
    )
    _tf32_at_defaults()
    l_cpu, g_cpu = _grad_step(state, "cpu", batch)
    seen = set()
    l_gpu, g_gpu = _grad_step(state, "cuda", batch, seen=seen)
    if seen != {(False, True)}:
        raise AssertionError(f"f32 step's convolutions ran with cuDNN (allow_tf32, enabled) "
                             f"in {sorted(seen)}")
    _tf32_at_defaults()
    _, g_wrong = _grad_step(state, "cuda", batch, mock.patch.object(
        fused_norm, "instance_norm_leaky_relu_backward", _backward_without_means))
    _, g_ref = _grad_step(state, "cpu", batch, mock.patch.object(
        InstanceNormLeakyReLU, "forward", _aten_norm), dtype=torch.float64)
    layout = VariationalAutoEncoderRawData(INPLANES, LATENT)  # names the before-norm biases
    # Before-norm biases: roundoff around an exact 0; reported, not held.
    held = [k for k in g_ref if not _before_norm_bias(k, layout)]

    def rel(got: dict) -> dict[str, float]:
        return {k: ((got[k] - g_ref[k]).abs().max() / g_ref[k].abs().max()).item() for k in held}

    card, cpu, wrong = rel(g_gpu), rel(g_cpu), rel(g_wrong)
    limit = {k: GRAD_RATIO * cpu[k] + GRAD_FLOOR for k in held}
    share = {k: card[k] / limit[k] for k in held}  # of its limit, per leaf
    wrong_share = {k: wrong[k] / limit[k] for k in held}
    worst = max(share, key=share.get)
    wrong_worst = max(wrong_share, key=wrong_share.get)
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    dead = [k for k in g_gpu if k.startswith("encoder.") and k.endswith(".weight")
            and not bool(g_gpu[k].abs().max() > 0)]
    fused = _fused_vs_materialized(state)
    emit("train_parity", patterns=n, loss_cpu=l_cpu, loss_cuda=l_gpu, loss_rel_err=loss_rel,
         grad_ratio=GRAD_RATIO, grad_floor=GRAD_FLOOR,
         max_share_of_limit=share[worst], worst_leaf=worst,
         wrong_k2b_max_share_of_limit=wrong_share[wrong_worst], wrong_k2b_worst_leaf=wrong_worst,
         wrong_k2b_leaves_past_limit=sum(v > 1 for v in wrong_share.values()),
         card_vs_cpu_grad_max_abs_err=max((g_gpu[k] - g_cpu[k]).abs().max().item()
                                          for k in held),
         before_norm_bias_grad_max_abs_err=max((g_gpu[k] - g_cpu[k]).abs().max().item()
                                               for k in g_ref if k not in held),
         leaves={k: dict(scale=g_ref[k].abs().max().item(), card=card[k], cpu=cpu[k],
                         wrong_k2b=wrong[k]) for k in held},
         conv_flags_seen=sorted(seen), encoder_weights_with_grad=sum(1 for k in g_gpu if k.startswith("encoder.")
                                       and k.endswith(".weight")) - len(dead),
         fused_vs_materialized_decoder=fused)
    if not loss_rel <= 1e-5:
        raise AssertionError(f"train step loss: card {l_gpu}, CPU {l_cpu}")
    if not share[worst] <= 1.0:
        raise AssertionError(f"gradient of {worst}: card {card[worst]} from f64, CPU {cpu[worst]}")
    if not wrong_share[wrong_worst] > 1.0:
        raise AssertionError("a norm backward without its mean terms passes the gradient check")
    if dead:
        raise AssertionError(f"encoder conv weights without a gradient on the card: {dead}")
    if not fused["output_max_abs_err"] <= FUSED_ATOL:
        raise AssertionError(f"fused decoder output from the materialized one: {fused}")
    if not fused["grad_max_abs_err"] <= FUSED_ATOL:
        raise AssertionError(f"fused decoder gradients from the materialized ones: {fused}")


def _fused_vs_materialized(state: dict) -> dict:
    """The fused decoder (the default) against the materialized one on the
    card, from the same weights and input, in float32 with TF32 off: the
    output's and every parameter's gradient's (of ``mean(x_hat ** 2)``)
    largest distance, each held to `FUSED_ATOL`, the bound of
    tests/models/test_fused_upsample.py, by the caller."""
    from latice_tpu_torch.device import no_tf32
    from latice_tpu_torch.models.vae import Decoder

    dec_state = {k[len("decoder."):]: v for k, v in state.items() if k.startswith("decoder.")}
    h = torch.from_numpy(np.random.default_rng(9).normal(
        size=(TRAIN_BATCH, 4 * INPLANES, 4, 4)).astype(np.float32)).cuda()
    runs = {}
    for fuse in (True, False):
        dec = Decoder(INPLANES, fuse_upsample=fuse)
        if dec.fuse_upsample != fuse:
            raise AssertionError("LATICE_TPU_FUSED_UPSAMPLE is set around train_parity")
        dec.load_state_dict(dec_state)
        dec.cuda()
        with no_tf32():
            y = dec(h)
            (y**2).mean().backward()
        runs[fuse] = (y.detach(), {n: p.grad for n, p in dec.named_parameters()})
    (y_f, g_f), (y_m, g_m) = runs[True], runs[False]
    out_err = (y_f - y_m).abs().max().item()
    grad_err = {n: (g_f[n] - g_m[n]).abs().max().item() for n in g_m}
    worst = max(grad_err, key=grad_err.get)
    return dict(batch=TRAIN_BATCH, dtype="float32", tf32=False, atol=FUSED_ATOL,
                output_max_abs_err=out_err, output_scale=y_m.abs().max().item(),
                grad_max_abs_err=grad_err[worst], worst_leaf=worst,
                grad_scale=max(g.abs().max().item() for g in g_m.values()),
                leaves=len(grad_err))


def _phase_of(evt, spans, trace_start_ns: int) -> str:
    """The labelled region (or the backward pass) a host event ran in: the
    innermost ``train:*`` program span (`utils.profiling.span`) open at the
    event's start, on the profiler's clock."""
    node = evt
    while node.cpu_parent is not None:
        node = node.cpu_parent
    if node.name.startswith("autograd::engine"):
        return "backward"
    at = trace_start_ns + int(evt.time_range.start * 1e3)
    inside = [s for s in spans if s.start_ns <= at <= s.end_ns]
    if inside:
        return min(inside, key=lambda s: s.end_ns - s.start_ns).name[len("train:"):]
    return "unlabelled"


def phase_train_profile(model) -> None:
    """Where the device time of 3 steady train steps goes (B=64, 16-mixed),
    with the fused decoder (the default, ``model``'s) and with the
    materialized one (``LATICE_TPU_FUSED_UPSAMPLE=0``) from the same
    weights, in turns (fused, materialized, materialized, fused): one
    `_train_profile` line each."""
    from latice_tpu_torch.models import VariationalAutoEncoderRawData

    os.environ["LATICE_TPU_FUSED_UPSAMPLE"] = "0"
    try:
        plain = VariationalAutoEncoderRawData(INPLANES, LATENT)
    finally:
        del os.environ["LATICE_TPU_FUSED_UPSAMPLE"]
    if plain.decoder.fuse_upsample or not model.decoder.fuse_upsample:
        raise AssertionError("the two decoders are not fused and materialized")
    plain.load_state_dict(model.state_dict())
    models = {"fused": model, "materialized": plain.cuda()}
    for decoder in ("fused", "materialized", "materialized", "fused"):
        _train_profile(models[decoder], decoder)
    _train_wall(models)


def _train_wall(models: dict, pairs: int = 10, steps: int = 10) -> None:
    """Wall ms per step of the trainer's epoch loop with each decoder and
    no profiler: `pairs` pairs of `steps` steps (B=64, 16-mixed), the two
    decoders taking turns at going first. Reported: each decoder's median
    and quartiles, and the pairs the fused decoder won."""
    from latice_tpu_torch.train import Trainer, VAELoss, make_optimizer, make_train_step

    trainer = Trainer(precision="16-mixed", device="cuda")
    patterns = _synthetic_patterns(steps * TRAIN_BATCH, seed=10)[..., None]
    batches = [(patterns[i : i + TRAIN_BATCH], None) for i in range(0, len(patterns), TRAIN_BATCH)]
    runs = {}
    for name, model in models.items():
        model.set_precision("16-mixed")
        runs[name] = (model, make_optimizer(model.parameters()),
                      make_train_step(VAELoss(kl_lambda=5e-6)))
        trainer.train_epoch(*runs[name], batches[:3], TRAIN_BATCH, 0)
    ms = {name: [] for name in models}
    order = list(models)
    for i in range(pairs):
        for name in order if i % 2 == 0 else order[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_epoch(*runs[name], batches, TRAIN_BATCH, 0)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3 / steps)
    emit("train_step_wall", pairs=pairs, steps=steps, batch=TRAIN_BATCH, ms_per_step=ms,
         median={k: float(np.median(v)) for k, v in ms.items()},
         quartiles={k: [float(q) for q in np.percentile(v, [25, 75])] for k, v in ms.items()},
         fused_won=sum(f < m for f, m in zip(ms["fused"], ms["materialized"])),
         timed_as="host clock around Trainer.train_epoch of 10 batches, synchronized")


def _train_profile(model, decoder: str) -> None:
    """The trainer's own epoch loop (prefetch, step, metric reads) over 3
    batches, after 3 warm-up batches, traced."""
    from torch.profiler import ProfilerActivity, profile

    from latice_tpu_torch.train import Trainer, VAELoss, make_optimizer, make_train_step
    from latice_tpu_torch.utils.profiling import recorded

    model.set_precision("16-mixed")
    trainer = Trainer(precision="16-mixed", device="cuda")
    optimizer = make_optimizer(model.parameters())
    train_step = make_train_step(VAELoss(kl_lambda=5e-6))
    patterns = _synthetic_patterns(6 * TRAIN_BATCH, seed=8)[..., None]
    batches = [(patterns[i : i + TRAIN_BATCH], None) for i in range(0, len(patterns), TRAIN_BATCH)]
    trainer.train_epoch(model, optimizer, train_step, batches[:3], TRAIN_BATCH, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_epoch(model, optimizer, train_step, batches[3:], TRAIN_BATCH, 3)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_kernels(prof)
    by_name: dict[str, float] = {}
    for name, dev_ms, _ in kernels:
        by_name[_kernel_group(name)] = by_name.get(_kernel_group(name), 0.0) + dev_ms
    by_part: dict[str, float] = {}
    spans = [s for s in recorded().spans if s.name.startswith("train:")]
    trace_start_ns = prof.profiler.kineto_results.trace_start_ns()
    for evt in prof.events():
        for k in getattr(evt, "kernels", []):
            group = _kernel_group(k.name)
            part = _phase_of(evt, spans, trace_start_ns)
            if group == "convolution":
                group = f"convolution ({part})"
            elif group in ("other", "copy", "optimizer"):
                group = f"{group} ({part})"
            by_part[group] = by_part.get(group, 0.0) + k.duration / 1e3
    busy = sum(by_name.values())
    top = sorted(kernels, key=lambda k: -k[1])[:12]
    host_top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:10]
    per_step = {k: v / 3 for k, v in by_part.items()}
    emit("train_profile", decoder=decoder, steps=3, batch=TRAIN_BATCH, wall_ms=wall_ms,
         ms_per_step=wall_ms / 3, device_busy_ms=busy, device_busy_ms_per_step=busy / 3,
         idle_share=1.0 - busy / wall_ms,
         upsample_ms_per_step=by_name.get("upsample", 0.0) / 3,
         convolution_forward_ms_per_step=per_step.get("convolution (forward)", 0.0),
         convolution_backward_ms_per_step=per_step.get("convolution (backward)", 0.0),
         device_launches_per_step=sum(c for _, _, c in kernels) / 3,
         device_ms_by_kernel=by_name, device_ms_by_part=by_part,
         top=[dict(kernel=n[:100], ms=t, calls=c) for n, t, c in top],
         host_top=[dict(op=e.key[:80], self_cpu_ms=e.self_cpu_time_total / 1e3, calls=e.count)
                   for e in host_top])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    import latice_tpu_torch  # noqa: F401  (fail before any output outside a checkout)

    smi = phase_env()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    if sys.argv[1:] == ["--topk-only"]:  # K1's checks and times alone; no verdict line
        k1 = check_topk(gen)
        sweep_topk_plan(gen)
        print(json.dumps({"kernels": [k1]}), flush=True)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--stage0-only"]:  # K3's checks and times alone; no verdict line
        print(json.dumps({"kernels": [check_stage0(gen)]}), flush=True)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--mesh-only"]:  # the multi-device paths alone; no verdict line
        with tempfile.TemporaryDirectory() as workdir:
            ckpt, npz, _ = _serve_files(workdir)
            launches = phase_mesh(workdir, ckpt, npz)
        print(json.dumps({"kernels": [{"name": k, "launches_by_path": {"mesh": v}}
                                      for k, v in launches.items()]}), flush=True)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--examples-only"]:  # the examples' twins alone; no verdict line
        with tempfile.TemporaryDirectory() as workdir:
            launches = phase_examples(workdir, smi)
        print(json.dumps({"kernels": [{"name": k, "launches_by_path": {"examples": v}}
                                      for k, v in launches.items()]}), flush=True)
        print(smi, flush=True)
        return 0
    only = {"--sphere-only": phase_sphere, "--strain-only": phase_strain,
            "--master-only": phase_master, "--analyze-only": phase_analyze}
    if len(sys.argv) == 2 and sys.argv[1] in only:  # one plane's phase alone; no verdict line
        from latice_tpu_torch.models import VariationalAutoEncoderRawData

        with tempfile.TemporaryDirectory() as workdir:
            ckpt = f"{workdir}/vae.pt"
            model = VariationalAutoEncoderRawData(INPLANES, LATENT)
            torch.save(model.init_weights(torch.Generator().manual_seed(0)).state_dict(), ckpt)
            only[sys.argv[1]](workdir, ckpt, smi)
        print(smi, flush=True)
        return 0
    k2f, k1 = check_norm(gen), check_topk(gen)
    k2f["bf16_serve"] = check_norm_serve_bf16(gen)
    k2f["bf16_serve_nhwc"] = check_norm_serve_nhwc(gen)
    k2f["bf16_train"], k2b = check_norm_train(gen)
    k3 = check_stage0(gen)
    k4 = check_consensus()
    k5 = check_topk_wide(gen)
    kernels = [k1, k2f, k2b, k3, k4, k5]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        serve_launches, per_batch, service, ckpt, npz = phase_serve(workdir)
        phase_parity(service, ckpt, npz)
        phase_profile(service)
        reload_launches = phase_reload(service, workdir, npz)
        del service
        torch.cuda.empty_cache()
        engine_launches = phase_engines(ckpt, npz)
        torch.cuda.empty_cache()
        stage0_launches = phase_stage0_path(ckpt, npz)
        cli_launches = phase_index_cli(workdir, ckpt)
        preprocess_launches = phase_preprocess(workdir, ckpt)
        torch.cuda.empty_cache()
        tools_launches = phase_tools(workdir, ckpt, npz)
        mesh_launches = phase_mesh(workdir, ckpt, npz)
        torch.cuda.empty_cache()
        dictionary_launches = phase_dictionary(workdir, ckpt, smi)
        torch.cuda.empty_cache()
        bands_launches = phase_bands(workdir, ckpt, smi)
        torch.cuda.empty_cache()
        sphere_launches = phase_sphere(workdir, ckpt, smi)
        torch.cuda.empty_cache()
        strain_launches = phase_strain(workdir, ckpt, smi)
        torch.cuda.empty_cache()
        master_launches = phase_master(workdir, ckpt, smi)
        torch.cuda.empty_cache()
        analyze_launches = phase_analyze(workdir, ckpt, smi)
        torch.cuda.empty_cache()
        examples_launches = phase_examples(workdir, smi)
        torch.cuda.empty_cache()
        train_launches, model = phase_train(workdir, smi)
        robust_launches = phase_train_robust(workdir, smi)
    phase_train_parity()
    phase_train_profile(model)
    # Each path's counts were zeroed just before it ran and read just after;
    # a path lists the kernels it runs.
    paths = {
        "serve": serve_launches,
        "reload": reload_launches,
        "engines": engine_launches,
        "stage0_path": stage0_launches,
        "index_cli": {k: v for k, v in cli_launches.items() if k != "stage0_fused"},
        "preprocess": preprocess_launches,
        "tools": tools_launches,
        "mesh": mesh_launches,
        "dictionary": dictionary_launches,
        "bands": bands_launches,
        "sphere": sphere_launches,
        "strain": strain_launches,
        "master": master_launches,
        "analyze": analyze_launches,
        "examples": examples_launches,
        "train": train_launches,
        "train_robust": robust_launches,
    }
    for k in kernels:
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items() if k["name"] in c}
        k["launches"] = sum(k["launches_by_path"].values())
        if k["name"] in per_batch:
            k["launches_per_serve_batch"] = per_batch[k["name"]]
        for path, count in k["launches_by_path"].items():
            if count < 1:
                raise AssertionError(f"{k['name']} was never launched on the {path} path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
