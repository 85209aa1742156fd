"""UCI housing regression (reference: python/paddle/v2/dataset/uci_housing.py)
— yields (features[13] float, [price] float). Synthetic linear task fallback."""

from __future__ import annotations

import os

import numpy as np

from paddle_tpu_torch.dataset import common

feature_names = [
    "CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE",
    "DIS", "RAD", "TAX", "PTRATIO", "B", "LSTAT",
]

SYNTH_N = 506


def _load_real():
    path = common.data_path("uci_housing", "housing.data")
    if not os.path.exists(path):
        return None
    data = np.loadtxt(path).astype(np.float32)
    x, y = data[:, :13], data[:, 13:]
    x = (x - x.mean(0)) / (x.std(0) + 1e-8)
    return x, y


def _synthetic(seed=3):
    rng = np.random.RandomState(seed)
    w = rng.randn(13, 1).astype(np.float32)
    x = rng.randn(SYNTH_N, 13).astype(np.float32)
    y = x @ w + 0.1 * rng.randn(SYNTH_N, 1).astype(np.float32)
    return x, y


def _reader(x, y, lo, hi):
    def reader():
        for i in range(lo, hi):
            yield x[i], y[i]

    return reader


def train():
    d = _load_real() or _synthetic()
    n = int(d[0].shape[0] * 0.8)
    return _reader(d[0], d[1], 0, n)


def test():
    d = _load_real() or _synthetic()
    n = int(d[0].shape[0] * 0.8)
    return _reader(d[0], d[1], n, d[0].shape[0])
def convert(path):
    """Export to recordio shards for the master (reference uci_housing.py)."""
    common.convert(path, train(), 1000, "uci_housing_train")
    common.convert(path, test(), 1000, "uci_housing_test")
