"""PASCAL VOC2012 segmentation (reference: python/paddle/v2/dataset/voc2012.py)
— yields (image[3,H,W] float in [0,1], label_map[H,W] int∈[0,21)).  Synthetic
blob-structured scenes at 64x64 when the real VOCtrainval archive is absent."""

from __future__ import annotations

import os

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["train", "test", "val"]

CLASSES = 21  # background + 20 object classes
SIZE = 64
_SYNTH = {"train": 160, "test": 40, "val": 40}


def _have_real() -> bool:
    return os.path.exists(
        common.data_path("VOC2012", "VOCtrainval_11-May-2012.tar")
    )


def _synthetic(split: str):
    """Each image: uniform background plus one rectangle of a random class,
    with the class determining the rectangle's colour."""
    seed = {"train": 113, "test": 127, "val": 131}[split]
    rng = np.random.RandomState(seed)
    palette = np.random.RandomState(137).rand(CLASSES, 3).astype(np.float32)
    for _ in range(_SYNTH[split]):
        cls = int(rng.randint(1, CLASSES))
        img = np.full((3, SIZE, SIZE), 0.2, np.float32)
        img += 0.05 * rng.randn(3, SIZE, SIZE).astype(np.float32)
        label = np.zeros((SIZE, SIZE), np.int64)
        x0, y0 = rng.randint(0, SIZE // 2, size=2)
        w, h = rng.randint(SIZE // 4, SIZE // 2, size=2)
        label[y0 : y0 + h, x0 : x0 + w] = cls
        img[:, y0 : y0 + h, x0 : x0 + w] = palette[cls][:, None, None]
        yield np.clip(img, 0, 1), label


def _real_reader(split: str):
    import io
    import tarfile

    from PIL import Image  # optional dependency

    archive = common.data_path("VOC2012", "VOCtrainval_11-May-2012.tar")
    seg_dir = "VOCdevkit/VOC2012/SegmentationClass/"
    img_dir = "VOCdevkit/VOC2012/JPEGImages/"
    list_file = f"VOCdevkit/VOC2012/ImageSets/Segmentation/{split}.txt"

    def reader():
        with tarfile.open(archive) as tf:
            names = tf.extractfile(list_file).read().decode().split()
            for name in names:
                img = Image.open(
                    io.BytesIO(tf.extractfile(img_dir + name + ".jpg").read())
                ).convert("RGB")
                seg = Image.open(
                    io.BytesIO(tf.extractfile(seg_dir + name + ".png").read())
                )
                arr = np.asarray(img, dtype=np.float32).transpose(2, 0, 1) / 255.0
                lab = np.asarray(seg, dtype=np.int64)
                # VOC marks void/boundary pixels as 255 — remap to background
                # so labels stay in [0, CLASSES) for 21-class losses.
                lab = np.where(lab == 255, 0, lab)
                yield arr, lab

    return reader


def _reader(split: str):
    if _have_real():
        # VOC's real test annotations are withheld; serve val for test()
        # rather than trainval (which would overlap the training images).
        real_split = {"train": "train", "val": "val", "test": "val"}[split]
        return _real_reader(real_split)

    def reader():
        yield from _synthetic(split)

    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")


def val():
    return _reader("val")
