"""Oxford 102 Flowers (reference: python/paddle/v2/dataset/flowers.py) —
yields (image[3*H*W] float in [0,1], label∈[0,102)).  Synthetic
class-structured images at 64x64 when the real archives are absent."""

from __future__ import annotations

import os

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["train", "test", "valid"]

CLASSES = 102
SIZE = 64
DIM = 3 * SIZE * SIZE
_SYNTH = {"train": 612, "test": 204, "valid": 102}


def _have_real() -> bool:
    if not all(
        common.exists("flowers", f)
        for f in ("102flowers.tgz", "imagelabels.mat", "setid.mat")
    ):
        return False
    try:  # real decoding needs optional deps
        import scipy.io  # noqa: F401
        from PIL import Image  # noqa: F401
    except ImportError:
        return False
    return True


def _synthetic(split: str):
    protos = (
        np.random.RandomState(101)
        .uniform(0, 1, size=(CLASSES, DIM))
        .astype(np.float32)
    )
    seed = {"train": 103, "test": 107, "valid": 109}[split]
    rng = np.random.RandomState(seed)
    n = _SYNTH[split]
    labels = rng.randint(0, CLASSES, size=n)
    imgs = np.clip(protos[labels] + 0.1 * rng.randn(n, DIM), 0, 1).astype(
        np.float32
    )
    return imgs, labels


def _real_reader(split: str):
    # Real pipeline needs image decoding (jpeg) — iterate the tgz lazily.
    import tarfile

    try:
        from PIL import Image  # optional dependency
    except ImportError as exc:  # pragma: no cover
        raise RuntimeError(
            "real flowers data needs PIL; use the synthetic fallback"
        ) from exc
    import io

    import scipy.io as sio

    labels = sio.loadmat(common.data_path("flowers", "imagelabels.mat"))["labels"][0]
    setids = sio.loadmat(common.data_path("flowers", "setid.mat"))
    key = {"train": "trnid", "test": "tstid", "valid": "valid"}[split]
    indexes = set(int(i) for i in setids[key][0])

    def reader():
        with tarfile.open(common.data_path("flowers", "102flowers.tgz")) as tf:
            for member in tf.getmembers():
                if not member.name.endswith(".jpg"):
                    continue
                idx = int(member.name[-9:-4])
                if idx not in indexes:
                    continue
                img = Image.open(io.BytesIO(tf.extractfile(member).read()))
                img = img.convert("RGB").resize((SIZE, SIZE))
                arr = np.asarray(img, dtype=np.float32) / 255.0
                yield arr.transpose(2, 0, 1).reshape(-1), int(labels[idx - 1]) - 1

    return reader


def _reader(split: str):
    if _have_real():
        return _real_reader(split)
    imgs, labels = _synthetic(split)

    def reader():
        for i in range(imgs.shape[0]):
            yield imgs[i], int(labels[i])

    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")


def valid():
    return _reader("valid")
