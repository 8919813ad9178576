"""The JAX package's `index.py analyze` readings on the input of
``chip_smoke.py``'s ``analyze`` phase crop, on the CPU, for comparison with
the port's on the GPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python examples/analyze_jax_reference.py

Builds the phase's seeded 1024x1024 map (``chip_smoke.analyze_truth``),
takes its top-left 128x128 crop (``chip_smoke.ANALYZE_CROP``) in float32,
runs ``index.py analyze`` with the phase's flags (``chip_smoke.ANALYZE_FLAGS``:
grain statistics, CSL, Schmid, Taylor, Young's modulus, GND, components,
texture index, cleanup) and prints one JSON line: a digest of the crop,
``chip_smoke.analyze_readings`` of the command's files and summary, and the
seconds the map and the command took (about 7 and 35 s on an 8-core CPU;
CSL's untiled score matrices take ~1.3 GB a direction). The line is
chip_smoke's ``JAX_ANALYZE``.
"""

from __future__ import annotations

import contextlib
import io
import json
import sys
import tempfile
import time

import numpy as np

import chip_smoke as cs
from latice_tpu.cli.index import main as index_main


def main() -> int:
    t0 = time.perf_counter()
    crop = cs.analyze_truth()["euler"].astype(np.float32)[:cs.ANALYZE_CROP, :cs.ANALYZE_CROP]
    map_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        np.save(f"{d}/crop.npy", crop.reshape(-1, 3))
        side = str(cs.ANALYZE_CROP)
        sys.argv = ["index.py", "analyze", "--orientations", f"{d}/crop.npy", "--grid", side,
                    side, "--out-prefix", f"{d}/jax"] + cs.ANALYZE_FLAGS
        stdout = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            index_main()
        analyze_s = time.perf_counter() - t0
        summary = json.loads(stdout.getvalue().strip().splitlines()[-1])
        readings = cs.analyze_readings(summary, f"{d}/jax")
    print(json.dumps(dict(input_sha=cs._sha(crop), readings=readings, map_s=map_s,
                          analyze_s=analyze_s)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
