"""CIFAR-10/100 (reference: python/paddle/v2/dataset/cifar.py) — yields
(image[3072] float in [0,1], label int).  Loads real pickled batches from the
cache dir when present (cifar-10-batches-py / cifar-100-python); otherwise
serves deterministic class-structured synthetic data."""

from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["train100", "test100", "train10", "test10"]

SYNTH_TRAIN = 2048
SYNTH_TEST = 256
DIM = 3 * 32 * 32


def _iter_archive(path: str, sub_name: str):
    with tarfile.open(path, mode="r") as f:
        names = [n for n in f.getnames() if sub_name in n]
        for name in names:
            batch = pickle.load(f.extractfile(name), encoding="latin1")  # wire: allow[A206] upstream CIFAR distribution IS pickle; the archive is md5-verified by dataset.common.download before any byte is read
            data = batch["data"]
            labels = batch.get("labels") or batch.get("fine_labels")
            for sample, label in zip(data, labels):
                yield (sample.astype(np.float32) / 255.0, int(label))


def _synthetic(n: int, classes: int, seed: int):
    protos = (
        np.random.RandomState(99)
        .uniform(0, 1, size=(classes, DIM))
        .astype(np.float32)
    )
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, classes, size=n)
    imgs = np.clip(protos[labels] + 0.15 * rng.randn(n, DIM), 0, 1)
    return imgs.astype(np.float32), labels


def _reader(archive: str, sub_name: str, classes: int, n: int, seed: int):
    path = common.data_path("cifar", archive)

    def reader():
        if os.path.exists(path):
            yield from _iter_archive(path, sub_name)
        else:
            imgs, labels = _synthetic(n, classes, seed)
            for i in range(n):
                yield imgs[i], int(labels[i])

    return reader


def train10():
    return _reader("cifar-10-python.tar.gz", "data_batch", 10, SYNTH_TRAIN, 3)


def test10():
    return _reader("cifar-10-python.tar.gz", "test_batch", 10, SYNTH_TEST, 5)


def train100():
    return _reader("cifar-100-python.tar.gz", "train", 100, SYNTH_TRAIN, 7)


def test100():
    return _reader("cifar-100-python.tar.gz", "test", 100, SYNTH_TEST, 9)
def convert(path):
    """Export to recordio shards for the master (reference cifar.py:132)."""
    common.convert(path, train100(), 1000, "cifar_train100")
    common.convert(path, test100(), 1000, "cifar_test100")
    common.convert(path, train10(), 1000, "cifar_train10")
    common.convert(path, test10(), 1000, "cifar_test10")
