"""The port's result export (``.ang``/``.ctf``) and ambiguity diagnostic
against the JAX package's on the same results.

The writers format the same numbers the same way, so the files must be
byte-equal, and each package's reader must parse the other's file. The
ambiguity diagnostic runs in float32 on both sides: rival masks are equal,
score gaps agree to float32 roundoff and disorientation angles to 1e-3
degrees (arccos near 1 amplifies the last bit of a quaternion product).
"""

import numpy as np
import pytest

from latice_tpu.data.export import read_ang as jax_read_ang
from latice_tpu.data.export import read_ctf as jax_read_ctf
from latice_tpu.data.export import write_ang as jax_write_ang
from latice_tpu.data.export import write_ctf as jax_write_ctf
from latice_tpu.index import DenseIndexResult as JaxResult
from latice_tpu.index import candidate_ambiguity as jax_ambiguity
from latice_tpu_torch.data import read_ang, read_ctf, write_ang, write_ctf
from latice_tpu_torch.index import DenseIndexResult, candidate_ambiguity

N_DICT, B, K = 60, 24, 6


def _dictionary(rng, two_phase):
    angles = rng.uniform([0, 0, 0], [360, 180, 360], size=(N_DICT, 3))
    # Grid neighbours (within 1.5 degrees) of the first rows: not rivals.
    angles[30:40] = angles[:10] + rng.uniform(-1.0, 1.0, size=(10, 3))
    phases = (np.arange(N_DICT) % 2).astype(np.int32) if two_phase else None
    return angles, phases


def _results(rng, angles, phases):
    """The same dense result as the JAX and the port's NamedTuple."""
    idx = np.stack([rng.permutation(N_DICT)[:K] for _ in range(B)])
    # Rows 0-7: only a first row and its grid neighbour, so no rival; rows
    # 8-15: the neighbour right after the top-1, then random rivals.
    first = np.arange(16) % 10
    idx[:8] = np.where(np.arange(K) % 2 == 0, first[:8, None], first[:8, None] + 30)
    idx[8:16, 0], idx[8:16, 1] = first[8:], first[8:] + 30
    scores = np.sort(rng.uniform(0.5, 1.0, size=(B, K)), axis=1)[:, ::-1].astype(np.float32)
    success = rng.uniform(size=B) < 0.7
    mean = np.where(success[:, None], angles[idx[:, 0]] + 0.25, np.nan)
    fields = dict(
        mean_orientation=mean,
        best_orientation=np.where(success[:, None], mean, angles[idx[:, 0]]),
        success=success,
        n_similar=rng.integers(0, K + 1, size=B).astype(np.int64),
        indices=idx,
        scores=scores,
        phase=None if phases is None else phases[idx[:, 0]].astype(np.int64),
    )
    return JaxResult(**fields), DenseIndexResult(**fields)


@pytest.mark.parametrize("two_phase", [False, True], ids=["one_phase", "two_phase"])
def test_ambiguity_matches_jax(two_phase):
    rng = np.random.default_rng(11 + two_phase)
    angles, phases = _dictionary(rng, two_phase)
    jres, pres = _results(rng, angles, phases)
    kw = dict(phase_groups=["432", "622"], dictionary_phases=phases) if two_phase else {}
    want = jax_ambiguity(jres, angles, chunk=16, **kw)
    got = candidate_ambiguity(pres, angles, chunk=16, device="cpu", **kw)
    np.testing.assert_array_equal(got.has_rival, want.has_rival)
    assert 0 < got.has_rival.sum() < B  # both branches are exercised
    np.testing.assert_allclose(got.angle_deg, want.angle_deg, atol=1e-3, equal_nan=True)
    np.testing.assert_allclose(got.score_gap, want.score_gap, atol=1e-6, equal_nan=True)
    for gap in (0.01, 0.1):
        np.testing.assert_array_equal(got.ambiguous(gap), want.ambiguous(gap))


def test_ambiguity_needs_two_candidates():
    angles, _ = _dictionary(np.random.default_rng(0), False)
    res = DenseIndexResult(
        mean_orientation=np.zeros((2, 3)), best_orientation=np.zeros((2, 3)),
        success=np.ones(2, bool), n_similar=np.ones(2, np.int64),
        indices=np.zeros((2, 1), np.int64), scores=np.ones((2, 1), np.float32),
    )
    with pytest.raises(ValueError, match="top_n >= 2"):
        candidate_ambiguity(res, angles, device="cpu")


@pytest.mark.parametrize(
    "two_phase, grid, step",
    [(False, (4, 6), 0.5), (True, None, 1.0)],
    ids=["one_phase_grid", "two_phase_line"],
)
def test_ang_and_ctf_files_match_jax(tmp_path, two_phase, grid, step):
    rng = np.random.default_rng(21 + two_phase)
    angles, phases = _dictionary(rng, two_phase)
    jres, pres = _results(rng, angles, phases)
    kw = dict(grid=grid, step=step)
    if two_phase:
        kw.update(phase_names=["Ni", "Ti"], phase_groups=["432", "622"],
                  phase_lattices=[(3.52, 3.52, 3.52), (2.95, 2.95, 4.68)])
    iq = rng.uniform(size=B)
    for ext, jax_write, port_write, jax_read, port_read in (
        ("ang", jax_write_ang, write_ang, jax_read_ang, read_ang),
        ("ctf", jax_write_ctf, write_ctf, jax_read_ctf, read_ctf),
    ):
        extra = dict(iq=iq) if ext == "ang" else {}
        jax_path, port_path = str(tmp_path / f"jax.{ext}"), str(tmp_path / f"port.{ext}")
        jax_write(jax_path, jres, **kw, **extra)
        port_write(port_path, pres, **kw, **extra)
        assert (tmp_path / f"port.{ext}").read_bytes() == (tmp_path / f"jax.{ext}").read_bytes()
        # Each package reads the other's file to the same map.
        a, b = port_read(jax_path), jax_read(port_path)
        for field in a._fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, field)),
                                          np.asarray(getattr(b, field)))
        assert len(a.success) == B
        np.testing.assert_array_equal(a.success, pres.success)


def test_ang_rejects_bad_iq_and_grid(tmp_path):
    angles, _ = _dictionary(np.random.default_rng(1), False)
    _, pres = _results(np.random.default_rng(2), angles, None)
    with pytest.raises(ValueError, match="iq must be"):
        write_ang(str(tmp_path / "x.ang"), pres, iq=np.zeros(B + 1))
    with pytest.raises(ValueError, match="does not hold"):
        write_ctf(str(tmp_path / "x.ctf"), pres, grid=(5, 5))
