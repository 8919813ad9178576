"""The JAX package's dynamical-master readings on the inputs of
``chip_smoke.py``'s ``master`` phase, on the CPU, for comparison with the
port's on the GPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python examples/dynamical_jax_reference.py

Evaluates `latice_tpu.sim.channeling_intensities` at the phase's 1,024
seeded generic directions (``chip_smoke.master_directions``) at the
``master`` CLI's defaults: fcc Ni on the real path, zincblende GaAs on the
2N embedding, and fcc with the phase's fixed depth histogram on the
quadrature path; then `simulate_bse_monte_carlo` at the phase's Monte-Carlo
settings (200,000 electrons, tilt 70 degrees, 8 energy bins, 40 depth bins)
with seeds 0 and 1. Prints one JSON line: ``chip_smoke.master_readings`` per
case (with the realized beam count and the mean inner potential),
``chip_smoke.mc_readings`` per seed, and the seconds each took.
"""

from __future__ import annotations

import json
import sys
import time

import chip_smoke as cs
from latice_tpu import sim


def main() -> int:
    d = cs.master_directions()
    out = {}
    for name, quad in (("fcc", False), ("zincblende", False), ("fcc_quad", True)):
        t0 = time.perf_counter()
        structure = cs.master_structure(sim, name.removesuffix("_quad"))
        beams = sim.dynamical_beams(structure, n_beams=cs.MASTER_BEAMS)
        kw = {}
        if quad:
            zc, zw = cs.master_quad_histogram()
            kw = dict(depth_centers_nm=zc, depth_weights=zw)
        values = sim.channeling_intensities(d, beams, chunk=cs.MASTER_CHUNK, **kw)
        out[name] = dict(n_beams=len(beams), u0=beams.u0, **cs.master_readings(values),
                         seconds=time.perf_counter() - t0)
    for seed in (0, 1):
        t0 = time.perf_counter()
        mc = sim.simulate_bse_monte_carlo(
            cs.master_structure(sim, "fcc"), kv=20.0, tilt_deg=cs.MC_TILT_DEG,
            n_electrons=cs.MC_ELECTRONS, energy_bins=cs.MC_ENERGY_BINS,
            depth_bins=cs.MC_DEPTH_BINS, seed=seed,
        )
        out[f"mc_seed{seed}"] = dict(**cs.mc_readings(mc), seconds=time.perf_counter() - t0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
