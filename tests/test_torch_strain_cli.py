"""``python -m latice_tpu_torch.cli.index strain`` against the JAX package's
``index.py strain`` on the same arguments and files, on the CPU.

* The parser takes every option string of the JAX parser, and ``--device``.
* The ``.npz`` keys are JAX's; ``a``, strain, rotation within 1e-6, shifts
  within 1e-3 px, stress within 1e-4 of its largest entry
  (`test_torch_hrebsd.py`'s tolerances); the summary's keys are JAX's.
* ``--stiffness`` as a preset and as ``C11,C12,C44``; ``--euler``;
  ``--calibration`` with ``--scan-grid``; ``--map`` writes the PNG.

A 3x4 scan of 64x64 uint8 patterns with 32x32 ROIs, ``--batch-size 8``.
"""

import argparse
import json
import sys

import numpy as np
import pytest
import torch

from latice_tpu.cli import _strain_cmds as jax_strain_cmds
from latice_tpu.cli import index as jax_cli
from latice_tpu_torch.cli import _strain_cmds as port_strain_cmds
from latice_tpu_torch.cli import index as port_cli

A_ATOL, SHIFT_ATOL, STRESS_RTOL = 1e-6, 1e-3, 1e-4
SMALL = ["--roi-size", "32", "--batch-size", "8"]


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


def _scan(seed: int = 5) -> np.ndarray:
    """12 uint8 64x64 patterns of one grain (tests/test_hrebsd.py's
    direction-function oracle), strains and rotations of ~2e-3."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(60, 3))
    k /= np.linalg.norm(k, axis=1, keepdims=True)
    mag = rng.uniform(100.0, 500.0, size=(60, 1))
    k *= mag
    phase = rng.uniform(0, 2 * np.pi, 60)
    x = (np.arange(64) + 0.5) / 64 - 0.5
    r = np.stack([np.broadcast_to(x[None, :], (64, 64)), np.broadcast_to(-x[:, None], (64, 64)),
                  np.full((64, 64), 0.7)], axis=-1)
    out = []
    for _ in range(12):
        a = rng.normal(scale=2e-3, size=(3, 3))
        a[2, 2] = 0.0
        rr = r @ np.linalg.inv(np.eye(3) + a).T
        u = rr / np.linalg.norm(rr, axis=-1, keepdims=True)
        out.append((mag[:, 0] ** -0.5 * np.cos(u @ k.T + phase)).sum(axis=-1))
    out = np.stack(out)
    return np.round((out - out.min()) / np.ptp(out) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    t = tmp_path_factory.mktemp("straincli")
    np.save(t / "scan.npy", _scan())
    np.savez(t / "cal.npz", pc0=np.array([0.5, 0.5, 0.7]),
             gradient=np.array([[2e-3, 0.0], [0.0, -1.5e-3], [1e-3, 0.0]]))
    return t


def _run(side, argv, monkeypatch, capsys):
    """One ``strain`` command through either CLI, the port's on the CPU;
    its JSON summary line."""
    if side == "jax":
        monkeypatch.setattr(sys, "argv", ["index.py", "strain"] + argv)
        jax_cli.main()
    else:
        port_cli.main(["strain"] + argv + ["--device", "cpu"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _options(register) -> set:
    parser = argparse.ArgumentParser()
    register(parser.add_subparsers(dest="cmd"), argparse.ArgumentParser(add_help=False))
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {o for a in sub.choices["strain"]._actions for o in a.option_strings}


def test_strain_parser_matches_jax():
    port, jax = _options(port_strain_cmds.register), _options(jax_strain_cmds.register)
    assert port - {"--device"} == jax
    assert "--device" in port


@pytest.mark.parametrize(
    "flags",
    [
        ["--remap", "0"],
        ["--stiffness", "ni"],
        ["--stiffness", "246.5,147.3,124.7", "--euler", "30", "40", "50", "--tilt", "10",
         "--f-max", "12", "--min-quality", "0.2"],
        ["--calibration", "CAL", "--scan-grid", "3", "4", "--calibration-step", "0.5",
         "--ref", "5", "--upsample", "10"],
    ],
    ids=["remap0", "preset", "triplet_euler_tilt", "calibration"],
)
def test_strain_matches_jax(files, monkeypatch, capsys, flags):
    t = files
    flags = [str(t / "cal.npz") if f == "CAL" else f for f in flags]
    summaries = {}
    for side in ("jax", "port"):
        summaries[side] = _run(side, ["--patterns", str(t / "scan.npy"), "--out",
                                      str(t / f"{side}.npz")] + SMALL + flags,
                               monkeypatch, capsys)
    js, ps = summaries["jax"], summaries["port"]
    assert set(ps) == set(js)
    for key in ("n_patterns", "ref_index", "remap_iterations", "first_order_valid"):
        assert ps[key] == js[key]
    want, got = np.load(t / "jax.npz"), np.load(t / "port.npz")
    assert sorted(got.files) == sorted(want.files)
    for key in ("a", "strain", "rotation", "von_mises"):
        np.testing.assert_allclose(got[key], want[key], atol=A_ATOL, rtol=0)
    np.testing.assert_allclose(got["shifts_px"], want["shifts_px"], atol=SHIFT_ATOL, rtol=0)
    np.testing.assert_allclose(got["quality"], want["quality"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["residual_px"], want["residual_px"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["pc"], want["pc"])
    assert int(got["ref_index"]) == int(want["ref_index"])
    if "stress" in want:
        scale = np.abs(want["stress"]).max()
        np.testing.assert_allclose(got["stress"], want["stress"], atol=STRESS_RTOL * scale,
                                   rtol=0)


def test_strain_stiffness_forms_agree(files, capsys):
    """The preset name and its GPa triplet are the same stiffness."""
    t = files
    for name, spec in (("preset", "cu"), ("triplet", "168.4,121.4,75.4")):
        port_cli.main(["strain", "--patterns", str(t / "scan.npy"), "--out",
                       str(t / f"{name}.npz"), "--stiffness", spec, "--device", "cpu"] + SMALL)
    capsys.readouterr()
    a, b = np.load(t / "preset.npz"), np.load(t / "triplet.npz")
    np.testing.assert_array_equal(a["stress"], b["stress"])
    np.testing.assert_array_equal(a["a"], b["a"])


def test_strain_map_and_refusals(files, capsys):
    t = files
    base = ["strain", "--patterns", str(t / "scan.npy"), "--device", "cpu"] + SMALL
    port_cli.main(base + ["--out", str(t / "m.npz"), "--scan-grid", "3", "4",
                          "--map", str(t / "vm.png")])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["map"] == str(t / "vm.png")
    assert (t / "vm.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(SystemExit, match="--map needs --scan-grid"):
        port_cli.main(base + ["--out", str(t / "m.npz"), "--map", str(t / "x.png")])
    with pytest.raises(SystemExit, match="out of range"):
        port_cli.main(base + ["--ref", "12"])
    with pytest.raises(SystemExit, match="--stiffness 'unobtainium'"):
        port_cli.main(base + ["--stiffness", "unobtainium"])
    with pytest.raises(SystemExit, match="needs --scan-grid"):
        port_cli.main(base + ["--calibration", str(t / "cal.npz")])
    with pytest.raises(SystemExit, match="does not hold"):
        port_cli.main(base + ["--calibration", str(t / "cal.npz"), "--scan-grid", "2", "2"])
    np.savez(t / "bad_cal.npz", pc=np.zeros(3))
    with pytest.raises(SystemExit, match="missing 'pc0'"):
        port_cli.main(base + ["--calibration", str(t / "bad_cal.npz"), "--scan-grid", "3", "4"])
