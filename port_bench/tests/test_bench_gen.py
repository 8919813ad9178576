"""The traffic generators: the same seed gives the same inputs."""

import numpy as np
import torch

from port_bench import gen
from port_bench.reference import vae as ref

CFG = dict(inplanes=2, latent_dim=8, n_stages=3, bottleneck_hw=4, phases=["432", "622"],
           rows_per_phase=300, cluster_rows=25, cluster_spread=0.005, cluster_degrees=0.5)
TRAFFIC = dict(scan_rows=4, scan_cols=6, grains=3, grain_spread_degrees=0.5, image_size=32,
               detector_distance=0.6, counts=60.0, band_contrast=0.6, render_chunk=8)
BIG_SEED = 2**31 + 987_654_321


def _inputs(seed):
    return (gen.weights(ref.param_layout(CFG), "cpu", seed), gen.dictionary(CFG, "cpu", seed),
            gen.scan(CFG, TRAFFIC, "cpu", seed))


def test_same_seed_same_inputs():
    a, b, c = _inputs(BIG_SEED), _inputs(BIG_SEED), _inputs(BIG_SEED + 1)
    for name in a[0]:
        assert torch.equal(a[0][name], b[0][name])
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a[2], b[2])
    assert not np.array_equal(a[2], c[2])
    assert not np.array_equal(a[1][0], c[1][0])


def test_patterns_are_uint8_frames_with_bands():
    scan = gen.scan(CFG, TRAFFIC, "cpu", 3)
    assert scan.shape == (24, 32, 32) and scan.dtype == np.uint8
    assert 10 < scan.mean() < 200 and scan.max() > scan.mean() + 20


def test_dictionary_rows_cluster_in_latent_and_orientation():
    vec, euler, phases = gen.dictionary(CFG, "cpu", 4)
    assert vec.shape == (600, 8) and np.allclose(np.linalg.norm(vec, axis=1), 1, atol=1e-5)
    assert sorted(set(phases.tolist())) == [0, 1]
    from port_bench.reference import rotations as rot

    q = rot.from_euler_zxz_deg(euler)
    assert np.rad2deg(rot.misorientation(q[0], q[1:25])).max() < 1.0
    assert vec[0] @ vec[1] > 0.99
