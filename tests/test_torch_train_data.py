"""The port's training data path against latice_tpu.data: angle files,
splits and per-epoch batch orders bit for bit, padding, and prefetch."""

import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from latice_tpu.data import DPDataModule as JaxDataModule
from latice_tpu.data import parse_angle_file as jax_parse_angle_file
from latice_tpu_torch.data import (
    DPDataModule,
    batch_iterator,
    pad_batch,
    parse_angle_file,
    prefetch_host,
    prefetch_to_device,
)

SAMPLE_ANGLES = Path(__file__).resolve().parents[1] / "data" / "anglefile_sample.txt"


def write_dataset(directory, n=53, size=20, seed=0):
    """A seeded ``.npy`` pattern stack and its reference-format anglefile."""
    rng = np.random.default_rng(seed)
    path = directory / "patterns.npy"
    np.save(path, rng.integers(0, 256, (n, size, size), dtype=np.uint8))
    angles = directory / "angles.txt"
    with open(angles, "w") as f:
        f.write(f"eu\n{n}\n")
        np.savetxt(f, rng.uniform(0, 360, (n, 3)), fmt="%.4f")
    return path, angles


def test_parse_reference_anglefile_matches_jax():
    got = parse_angle_file(SAMPLE_ANGLES)
    want = jax_parse_angle_file(SAMPLE_ANGLES)
    assert got.shape == (625, 3) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_parse_ang_file_matches_jax(tmp_path):
    path = tmp_path / "scan.ang"
    rows = np.random.default_rng(1).uniform(0, 6, (7, 8))
    with open(path, "w") as f:
        f.write("# header\n# TEM_PIXperUM 1.0\n")
        np.savetxt(f, rows, fmt="%.5f")
    np.testing.assert_array_equal(parse_angle_file(path), jax_parse_angle_file(path))


def test_parse_angle_file_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        parse_angle_file(tmp_path / "missing.txt")
    bad = tmp_path / "bad.txt"
    bad.write_text("eu\n2\n1 2\n3 4\n")
    with pytest.raises(ValueError, match="rotation angles"):
        parse_angle_file(bad)


@pytest.mark.parametrize("val_ratio", [0.1, 0.0])
def test_splits_and_epoch_orders_bit_identical(tmp_path, val_ratio):
    path, angles = write_dataset(tmp_path)
    kw = dict(image_size=(16, 16), val_data_ratio=val_ratio, batch_size=8, seed=7)
    ours, theirs = DPDataModule(path, angles, **kw), JaxDataModule(path, angles, **kw)
    ours.setup("fit")
    theirs.setup("fit")
    assert (ours.train_size, ours.val_size) == (theirs.train_size, theirs.val_size)
    assert ours.num_train_batches() == theirs.num_train_batches()
    np.testing.assert_array_equal(ours.dataset_full.patterns, theirs.dataset_full.patterns)
    for epoch in (0, 1, 5):
        got = list(ours.train_batches(epoch=epoch))
        want = list(theirs.train_batches(epoch=epoch))
        assert len(got) == len(want)
        for (gx, ga), (wx, wa) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(ga, wa)
    for (gx, _), (wx, _) in zip(ours.val_batches(), theirs.val_batches()):
        np.testing.assert_array_equal(gx, wx)
    test_rows = sum(len(b) for b, _ in ours.test_batches())
    assert test_rows == len(ours.dataset_full) == 53


def test_pad_batch_and_iterator():
    x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    batches = list(batch_iterator((x,), 4))
    assert [len(b[0]) for b in batches] == [4, 4, 2]
    padded, mask, n = pad_batch(batches[-1][0], 4)
    assert padded.shape == (4, 3) and n == 2
    np.testing.assert_array_equal(mask, [1, 1, 0, 0])
    np.testing.assert_array_equal(padded[2:], 0)
    with pytest.raises(ValueError, match="exceeds"):
        pad_batch(x, 4)


def test_prefetch_to_device_on_cpu_keeps_order_and_structure():
    items = [(np.full((2, 2), i, np.float32), np.ones(2, np.float32) * i) for i in range(5)]
    out = list(prefetch_to_device(iter(items), size=2, device="cpu"))
    assert len(out) == 5
    for i, (a, b) in enumerate(out):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert float(a[0, 0]) == float(b[0]) == i
    with pytest.raises(ValueError, match="size"):
        next(prefetch_to_device(iter(items), size=0, device="cpu"))


def test_prefetch_host_order_errors_and_close():
    assert list(prefetch_host(iter(range(20)), size=3)) == list(range(20))

    def failing():
        yield 1
        raise RuntimeError("producer broke")

    it = prefetch_host(failing())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer broke"):
        next(it)

    def endless():
        i = 0
        while True:
            yield i
            i += 1

    before = set(threading.enumerate())
    gen = prefetch_host(endless(), size=2)
    assert next(gen) == 0
    gen.close()  # joins the producer
    assert not [t for t in threading.enumerate() if t not in before and t.is_alive()]
