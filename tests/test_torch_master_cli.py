"""``python -m latice_tpu_torch.cli.index master`` against the JAX package's
``index.py master`` on the same arguments, on the CPU.

* fcc and hcp (real path) and zincblende (2N embedding) at ``--size 17
  --beams 15``: the same summary line but its ``seconds`` and ``out``, the
  same ``.mastermeta.json``, and masters within `MASTER_ATOL` (measured:
  1.0e-5, 3.9e-6 and 4.9e-6).
* ``--mc`` at 2,000 electrons: the same summary and sidecar keys, the same
  beams, bins and edges; the yield and the energy weights come from other
  draws and are held by `SIGMAS` binomial standard errors.
* The element parser's errors, ``--devices 2`` (a mesh of two CPU entries
  with ``--device cpu``, the one-device master bit for bit) and a machine
  without a card.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest
import torch

from latice_tpu.cli import index as jax_cli
from latice_tpu_torch.cli import index as port_cli

SMALL = ["--size", "17", "--beams", "15", "--max-hkl", "2"]
MASTER_ATOL = 1e-4
SIGMAS = 4.0


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


def _run(side, argv, monkeypatch, capsys):
    """One ``master`` through either CLI, the port's on the CPU; its summary."""
    if side == "jax":
        monkeypatch.setattr(sys, "argv", ["index.py", "master"] + argv)
        jax_cli.main()
    else:
        port_cli.main(["master"] + argv + ["--device", "cpu"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _both(argv, tmp_path, monkeypatch, capsys):
    out = {}
    for side in ("port", "jax"):
        path = str(tmp_path / f"{side}.npy")
        summary = _run(side, argv + ["--out", path], monkeypatch, capsys)
        meta = json.loads(open(path + ".mastermeta.json").read())
        out[side] = (summary, meta, np.load(path))
    return out


@pytest.mark.parametrize("argv", [
    ["--structure", "fcc", "--element", "ni", "--lattice", "3.52"],
    ["--structure", "zincblende", "--element", "ga,as", "--lattice", "5.65"],
    ["--structure", "hcp", "--element", "ti", "--lattice", "2.95", "--kv", "15",
     "--depth-nm", "30", "--absorption", "0.08"],
], ids=["fcc", "zincblende", "hcp"])
def test_master_matches_jax(argv, tmp_path, monkeypatch, capsys):
    out = _both(argv + SMALL, tmp_path, monkeypatch, capsys)
    (ps, pm, pimg), (js, jm, jimg) = out["port"], out["jax"]
    assert set(ps) == set(js)
    assert {k: v for k, v in ps.items() if k not in ("seconds", "out")} == \
        {k: v for k, v in js.items() if k not in ("seconds", "out")}
    assert pm == jm
    assert pimg.shape == (17, 17) and pimg.dtype == np.float32
    np.testing.assert_allclose(pimg, jimg, rtol=0, atol=MASTER_ATOL)


def test_master_mc_matches_jax(tmp_path, monkeypatch, capsys):
    argv = SMALL + ["--mc", "--mc-electrons", "2000", "--mc-energy-bins", "4",
                    "--mc-depth-bins", "10"]
    out = _both(argv, tmp_path, monkeypatch, capsys)
    (ps, pm, pimg), (js, jm, _) = out["port"], out["jax"]
    assert set(ps) == set(js) and set(pm) == set(jm)
    assert ps["n_beams"] == js["n_beams"] and pm["mc_energy_edges_kev"] == jm["mc_energy_edges_kev"]
    assert {k: pm[k] for k in pm if not k.startswith("mc_") or k == "mc_electrons"} == \
        {k: jm[k] for k in jm if not k.startswith("mc_") or k == "mc_electrons"}
    n = 2000
    p, q = ps["mc_bse_yield"], js["mc_bse_yield"]
    assert pm["mc_bse_yield"] == p
    assert abs(p - q) <= SIGMAS * np.sqrt(p * (1 - p) / n + q * (1 - q) / n), (p, q)
    for a, b in zip(pm["mc_energy_weights"], jm["mc_energy_weights"]):
        m = n * min(p, q)
        assert abs(a - b) <= SIGMAS * np.sqrt((a * (1 - a) + b * (1 - b)) / m) + 1e-4, (a, b)
    assert np.all(np.isfinite(pimg)) and pimg.min() == 0.0 and pimg.max() == 1.0


@pytest.mark.parametrize("argv,message", [
    (["--structure", "zincblende", "--element", "ga"], "needs --element CATION,ANION"),
    (["--structure", "fcc", "--element", "ni,al"], "takes a single --element"),
])
def test_element_errors_match_jax(argv, message, monkeypatch, capsys):
    for side in ("port", "jax"):
        with pytest.raises(SystemExit, match=message):
            _run(side, argv + SMALL + ["--out", "never.npy"], monkeypatch, capsys)


def test_master_devices_and_missing_card(tmp_path):
    for devices in ("0", "2"):
        port_cli.main(["master", "--devices", devices, "--out", str(tmp_path / f"m{devices}.npy"),
                       "--device", "cpu"] + SMALL)
    np.testing.assert_array_equal(np.load(tmp_path / "m2.npy"), np.load(tmp_path / "m0.npy"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(["master", "--out", str(tmp_path / "m.npy")] + SMALL)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(["master", "--mc", "--out", str(tmp_path / "m.npy")] + SMALL)
