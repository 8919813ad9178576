"""The JAX package's HR-EBSD readings on the inputs of ``chip_smoke.py``'s
``strain`` phase, on the CPU, for comparison with the port's on the GPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python examples/hrebsd_jax_reference.py

Renders the phase's 512 seeded truth patterns (``chip_smoke.strain_truth``
in float64 on the CPU, as the card renders them in float64: 128x128, strains
up to 2e-3, rotations up to 3 degrees) and runs
`latice_tpu.hrebsd.hrebsd_map` at the phase's configuration (the 21 default
ROIs of 64x64, kappa 20, chunk 128) with 0 and 1 remap passes, without and
with the Ni stiffness (``chip_smoke.STRAIN_CONFIGS``). Prints one JSON line:
per configuration, ``chip_smoke.strain_readings`` (median and largest
``max|a - a_true|``, the shares under 1e-4 and 5e-4, the mean quality and
the median residual in px) and the seconds it took.
"""

from __future__ import annotations

import json
import sys
import time

import chip_smoke as cs
from latice_tpu.crystal.elastic import CUBIC_STIFFNESS, cubic_stiffness
from latice_tpu.hrebsd import hrebsd_map
from latice_tpu.sim import DetectorGeometry


def main() -> int:
    t0 = time.perf_counter()
    ref, pats, a_true = cs.strain_truth(device="cpu")
    geom = DetectorGeometry(shape=(cs.STRAIN_SIZE, cs.STRAIN_SIZE))
    out = {"render_s": time.perf_counter() - t0}
    for name, cfg in cs.STRAIN_CONFIGS.items():
        t0 = time.perf_counter()
        stiffness = cfg["stiffness"] and cubic_stiffness(*CUBIC_STIFFNESS[cfg["stiffness"]])
        res = hrebsd_map(pats, ref, geom, roi_size=cs.STRAIN_ROI, upsample=cs.STRAIN_UPSAMPLE,
                         chunk=cs.STRAIN_CHUNK, remap_iterations=cfg["remap_iterations"],
                         stiffness=stiffness)
        out[name] = dict(**cs.strain_readings(res.a, a_true, res.quality, res.residual_px),
                         seconds=time.perf_counter() - t0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
