"""The port's streamed data module (`latice_tpu_torch.data.StreamedDPDataModule`)
against the JAX package's and against the port's in-memory `DPDataModule`,
on the CPU; and ``cli.train trainer=robust data_module=streamed`` end to
end.

* ``.npy`` (memory-mapped), ``.h5`` and ``.up2`` stores of 45 uint16
  36x36 frames: every batch of two training epochs, the validation and the
  test split equal to JAX's streamed module's, bitwise, angles included;
  and, over the ``.npy``, equal to the port's `DPDataModule` on the same
  file and anglefile.
* The store errors, with the JAX package's messages.
* The training CLI at a small size (inplanes 2, 3 stages, 32x32, batch 8)
  with ``trainer=robust data_module=streamed`` over the ``.up2``, with
  ``remat=stage``: two epochs, finite losses, a checkpoint, and the norm's
  forward run as often as the recompute implies (11 norms a step at this
  depth, 10 of them again in each backward).
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np
import pytest
import torch

from latice_tpu.data import StreamedDPDataModule as JaxStreamed
from latice_tpu_torch.cli.train import main as train_main
from latice_tpu_torch.data import DPDataModule, StreamedDPDataModule

ROOT = Path(__file__).resolve().parents[1]
N, SIDE, ROWS, COLS = 45, 36, 5, 9
KW = dict(image_size=(32, 32), val_data_ratio=0.2, batch_size=8, seed=3)


@pytest.fixture(scope="module", autouse=True)
def _restore_global_rng():
    """Leave torch's global RNG as this module found it."""
    with torch.random.fork_rng(devices=[]):
        yield


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The same 45 frames as ``.npy``, ``.h5`` and ``.up2``, and an anglefile."""
    import h5py

    d = tmp_path_factory.mktemp("streamed")
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 65535, (N, SIDE, SIDE)).astype(np.uint16)
    np.save(d / "scan.npy", frames)
    with h5py.File(d / "scan.h5", "w") as f:
        f.create_dataset("Scan 1/EBSD/Data/Pattern", data=frames)
    with open(d / "scan.up2", "wb") as f:
        f.write(np.asarray([3, SIDE, SIDE, 42], "<u4").tobytes())
        f.write(np.uint8(0).tobytes() + np.asarray([COLS, ROWS], "<u4").tobytes())
        f.write(np.uint8(0).tobytes() + np.asarray([1.0, 1.0], "<f8").tobytes())
        frames.astype("<u2").tofile(f)
    with open(d / "angles.txt", "w") as f:
        f.write(f"eu\n{N}\n")
        np.savetxt(f, rng.uniform(0, 90, (N, 3)), fmt="%.4f")
    return d


def _epochs(dm):
    """Every batch the trainer reads: two training epochs, val, test."""
    dm.setup("fit")
    out = [list(dm.train_batches(epoch=e)) for e in (0, 1)]
    out += [list(dm.val_batches()), list(dm.test_batches())]
    return out, (dm.train_size, dm.val_size, dm.num_train_batches(), dm.num_test_batches())


def _assert_same(a, b):
    (ba, sa), (bb, sb) = a, b
    assert sa == sb
    for stream_a, stream_b in zip(ba, bb, strict=True):
        assert len(stream_a) == len(stream_b)
        for (xa, ya), (xb, yb) in zip(stream_a, stream_b):
            assert xa.dtype == xb.dtype == np.float32 and xa.shape == xb.shape
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)


@pytest.mark.parametrize("ext", ["npy", "h5", "up2"])
@pytest.mark.parametrize("angles", [True, False])
def test_batches_equal_jax_streamed(stores, ext, angles):
    path = stores / f"scan.{ext}"
    rot = stores / "angles.txt" if angles else None
    port = StreamedDPDataModule(path, rot, **KW)
    jax = JaxStreamed(path, rot, **KW)
    try:
        _assert_same(_epochs(port), _epochs(jax))
        assert port.train_size == 36 and port.val_size == 9
    finally:
        port.close()
        jax.close()


def test_streamed_npy_equals_in_memory_module(stores):
    streamed = StreamedDPDataModule(stores / "scan.npy", stores / "angles.txt", **KW)
    eager = DPDataModule(stores / "scan.npy", stores / "angles.txt", **KW)
    _assert_same(_epochs(streamed), _epochs(eager))


def test_zero_val_ratio_trains_on_everything(stores):
    kw = dict(KW, val_data_ratio=0.0)
    port = StreamedDPDataModule(stores / "scan.up2", **kw)
    _assert_same(_epochs(port), _epochs(JaxStreamed(stores / "scan.up2", **kw)))
    assert sum(len(x) for x, _ in port.train_batches(epoch=0)) == N


def test_store_errors_match_jax(stores, tmp_path):
    np.save(tmp_path / "flat.npy", np.zeros((4, 16), np.float32))
    (tmp_path / "scan.tif").write_bytes(b"")
    with open(tmp_path / "short.txt", "w") as f:
        f.write("eu\n2\n0 0 0\n0 0 0\n")
    cases = [
        ((tmp_path / "scan.tif",), "supports .h5"),
        ((tmp_path / "flat.npy",), "3-D"),
        ((stores / "scan.npy", tmp_path / "short.txt"), "angle count"),
    ]
    for args, message in cases:
        for cls in (StreamedDPDataModule, JaxStreamed):
            with pytest.raises(ValueError, match=message):
                cls(*args)
    dm = StreamedDPDataModule(stores / "scan.npy")
    with pytest.raises(RuntimeError, match="setup"):
        next(dm.val_batches())


def test_train_cli_robust_streamed(stores, tmp_path):
    from latice_tpu_torch.ops import fused_norm

    overrides = [
        "trainer=robust", "data_module=streamed", f"data_module.path={stores / 'scan.up2'}",
        "data_module.image_size=[32,32]", "data_module.batch_size=8",
        "lightning_module.model.inplanes=2", "lightning_module.model.n_stages=3",
        "lightning_module.model.remat=stage", "trainer.precision=32",
        f"trainer.checkpoint_dir={tmp_path / 'ck'}", f"trainer.logger.save_dir={tmp_path / 'logs'}",
        "trainer.logger.tensorboard=false", "trainer.log_every_n_steps=1",
    ]
    calls = []
    plain = fused_norm.instance_norm_leaky_relu_plain

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    fused_norm.instance_norm_leaky_relu_plain = counted
    try:
        train_main(["--config-path", str(ROOT / "conf"), "--device", "cpu"] + overrides)
    finally:
        fused_norm.instance_norm_leaky_relu_plain = plain
    with open(tmp_path / "logs" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    steps = [float(r["train_loss"]) for r in rows if r.get("train_loss")]
    assert len(steps) == 2 * 6 and all(np.isfinite(steps))  # 41 rows in batches of 8
    epochs = [r for r in rows if r.get("Epoch_val_loss")]
    assert len(epochs) == 2 and all(np.isfinite(float(r["Epoch_val_loss"])) for r in epochs)
    # 3 stages: 11 norms forward; remat=stage runs the 6 encoder and 4 of
    # the 5 decoder norms again in each backward; eval steps recompute none.
    assert len(calls) == 12 * (11 + 10) + 2 * 11  # 12 train steps, 2 eval steps
    assert (tmp_path / "ck" / "last.pt").exists()


def test_train_cli_robust_defaults_to_cuda(stores, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--config-path", str(ROOT / "conf"), "trainer=robust", "data_module=streamed",
                    f"data_module.path={stores / 'scan.up2'}",
                    f"trainer.checkpoint_dir={tmp_path / 'ck'}",
                    f"trainer.logger.save_dir={tmp_path / 'logs'}"])
