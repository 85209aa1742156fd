"""MNIST (reference: python/paddle/v2/dataset/mnist.py) — yields
(image[784] float in [-1,1], label int).  Loads the real IDX files from the
cache dir when present; otherwise serves a deterministic synthetic set with
class-dependent structure (so LeNet demonstrably learns on it)."""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from paddle_tpu_torch.dataset import common

SYNTH_TRAIN = 4096
SYNTH_TEST = 512


def _load_idx_images(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051
        data = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows * cols)
    return data.astype(np.float32) / 127.5 - 1.0


def _load_idx_labels(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        assert magic == 2049
        return np.frombuffer(f.read(), dtype=np.uint8).astype(np.int64)


def _real_files(prefix: str):
    img = common.data_path("mnist", f"{prefix}-images-idx3-ubyte.gz")
    lbl = common.data_path("mnist", f"{prefix}-labels-idx1-ubyte.gz")
    if os.path.exists(img) and os.path.exists(lbl):
        return img, lbl
    return None


def _synthetic(n: int, seed: int):
    """Class-structured synthetic digits: each class k gets a fixed random
    prototype; samples are prototype + noise.  Linearly separable enough to
    validate end-to-end learning."""
    protos = (
        np.random.RandomState(1234).uniform(-1, 1, size=(10, 784)).astype(np.float32)
    )
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.int64)
    imgs = protos[labels] + 0.3 * rng.randn(n, 784).astype(np.float32)
    return np.clip(imgs, -1, 1), labels


def _reader(imgs: np.ndarray, labels: np.ndarray):
    def reader():
        for i in range(imgs.shape[0]):
            yield imgs[i], int(labels[i])

    return reader


def train():
    files = _real_files("train")
    if files:
        return _reader(_load_idx_images(files[0]), _load_idx_labels(files[1]))
    return _reader(*_synthetic(SYNTH_TRAIN, seed=7))


def test():
    files = _real_files("t10k")
    if files:
        return _reader(_load_idx_images(files[0]), _load_idx_labels(files[1]))
    return _reader(*_synthetic(SYNTH_TEST, seed=11))
def convert(path):
    """Export to recordio shards for the master (reference mnist.py:118)."""
    common.convert(path, train(), 1000, "mnist_train")
    common.convert(path, test(), 1000, "mnist_test")
