"""Image-dataset preprocessing — the ``paddle/utils/preprocess_img.py`` +
``preprocess_util.py`` capability (reference: resize_image:25, DiskImage:38,
ImageClassificationDatasetCreater:78; DatasetCreater/DataBatcher in
preprocess_util.py:193-343); a copy of ``paddle_tpu/utils/preprocess_img.py``.

Turns a directory tree of labeled images::

    data_path/train/<label>/*.jpg     (or .png/.bmp/.npy)
    data_path/test/<label>/*.jpg

into shuffled pickled batch files + ``train.list``/``test.list`` + a meta
file holding the label set and the training-set mean image — the on-disk
layout the reference's image demos feed from.  A ``batch_reader`` bridges
the batch files into the reader/DataFeeder plane (CHW float vectors, the
v1 "paddle format").
"""

from __future__ import annotations

import os
import pickle
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp"}


def resize_image(img, target_size: int):
    """Resize a PIL image so its SHORT side equals target_size (reference
    preprocess_img.resize_image keeps aspect ratio the same way)."""
    w, h = img.size
    if w < h:
        nw, nh = target_size, max(1, int(round(h * target_size / w)))
    else:
        nw, nh = max(1, int(round(w * target_size / h))), target_size
    return img.resize((nw, nh))


def _center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top = max(0, (h - size) // 2)
    left = max(0, (w - size) // 2)
    return arr[top : top + size, left : left + size]


class DiskImage:
    """One on-disk image: load, resize to target, expose the flattened CHW
    float vector (reference DiskImage.convert_to_paddle_format)."""

    def __init__(self, path: str, target_size: int, color: bool = True):
        self.path = path
        self.target_size = target_size
        self.color = color

    def convert_to_array(self) -> np.ndarray:
        if self.path.endswith(".npy"):
            arr = np.load(self.path)
            if arr.ndim == 2:
                arr = arr[:, :, None]
            if arr.shape[0] != self.target_size or arr.shape[1] != self.target_size:
                if arr.dtype != np.uint8:
                    raise ValueError(
                        f"{self.path}: non-uint8 .npy images must already be "
                        f"{self.target_size}x{self.target_size}, got "
                        f"{arr.shape[:2]}"
                    )
                from PIL import Image

                img = resize_image(
                    Image.fromarray(arr.squeeze(-1) if arr.shape[2] == 1 else arr),
                    self.target_size,
                )
                arr = np.asarray(img)
                if arr.ndim == 2:
                    arr = arr[:, :, None]
        else:
            from PIL import Image

            img = Image.open(self.path)
            img = img.convert("RGB" if self.color else "L")
            img = resize_image(img, self.target_size)
            arr = np.asarray(img)
            if arr.ndim == 2:
                arr = arr[:, :, None]
        out = _center_crop(arr, self.target_size)
        if out.shape[0] != self.target_size or out.shape[1] != self.target_size:
            raise ValueError(
                f"{self.path}: image {arr.shape[:2]} smaller than "
                f"target_size {self.target_size}"
            )
        return out

    def convert_to_paddle_format(self) -> np.ndarray:
        """HWC uint8 -> flattened CHW float32 (the v1 dense_vector layout)."""
        arr = self.convert_to_array().astype(np.float32)
        return arr.transpose(2, 0, 1).reshape(-1)


def list_images(path: str) -> List[str]:
    return sorted(
        os.path.join(path, f)
        for f in os.listdir(path)
        if os.path.splitext(f)[1].lower() in IMAGE_EXTS | {".npy"}
    )


class ImageClassificationDatasetCreater:
    """Scan ``data_path/{train,test}/<label>/`` and emit batch files + lists
    + meta (reference ImageClassificationDatasetCreater.create_batches via
    DataBatcher.create_batches_and_list)."""

    def __init__(
        self,
        data_path: str,
        target_size: int,
        color: bool = True,
        num_per_batch: int = 1024,
        seed: int = 0,
    ):
        self.data_path = data_path
        self.target_size = target_size
        self.color = color
        self.num_per_batch = num_per_batch
        self.seed = seed
        self.output_path = os.path.join(data_path, "batches")

    # -- scanning -------------------------------------------------------
    def _scan_split(
        self, split: str, label_set: Optional[Sequence[str]] = None
    ) -> Tuple[List[np.ndarray], List[int], List[str]]:
        """label_set pins the label->id mapping (the TRAINING label set) so a
        test split with missing/extra label dirs cannot silently remap ids."""
        root = os.path.join(self.data_path, split)
        labels = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)) and not d.startswith(".")
        )
        if label_set is None:
            label_set = labels
        else:
            unknown = sorted(set(labels) - set(label_set))
            if unknown:
                raise ValueError(
                    f"{split} split has labels {unknown} absent from the "
                    f"training label set {list(label_set)}"
                )
        label_id = {lab: i for i, lab in enumerate(label_set)}
        imgs: List[np.ndarray] = []
        ids: List[int] = []
        for lab in labels:
            for f in list_images(os.path.join(root, lab)):
                imgs.append(
                    DiskImage(f, self.target_size, self.color)
                    .convert_to_paddle_format()
                )
                ids.append(label_id[lab])
        return imgs, ids, list(label_set)

    def _write_batches(
        self, split: str, imgs: Sequence[np.ndarray], ids: Sequence[int]
    ) -> List[str]:
        order = list(range(len(imgs)))
        random.Random(self.seed).shuffle(order)
        paths = []
        os.makedirs(self.output_path, exist_ok=True)
        for bi in range(0, len(order), self.num_per_batch):
            sel = order[bi : bi + self.num_per_batch]
            path = os.path.join(
                self.output_path, f"{split}_batch_{bi // self.num_per_batch:03d}"
            )
            with open(path, "wb") as f:
                pickle.dump(
                    {
                        "images": np.stack([imgs[i] for i in sel]),
                        "labels": np.asarray([ids[i] for i in sel], np.int32),
                    },
                    f,
                )
            paths.append(path)
        list_file = os.path.join(self.data_path, f"{split}.list")
        with open(list_file, "w") as f:
            f.write("\n".join(paths) + "\n")
        return paths

    # -- entry ----------------------------------------------------------
    def create_batches(self) -> dict:
        """Process both splits; returns the meta dict (also pickled to
        ``batches/batches.meta`` — label set, mean image, geometry)."""
        tr_imgs, tr_ids, labels = self._scan_split("train")
        self._write_batches("train", tr_imgs, tr_ids)
        te_dir = os.path.join(self.data_path, "test")
        if os.path.isdir(te_dir):
            te_imgs, te_ids, _ = self._scan_split("test", label_set=labels)
            self._write_batches("test", te_imgs, te_ids)
        meta = {
            "label_names": labels,
            "mean_image": np.mean(np.stack(tr_imgs), axis=0),
            "target_size": self.target_size,
            "color": self.color,
            "img_size": tr_imgs[0].shape[0],
        }
        os.makedirs(self.output_path, exist_ok=True)
        with open(os.path.join(self.output_path, "batches.meta"), "wb") as f:
            pickle.dump(meta, f)
        return meta


def load_meta(data_path: str) -> dict:
    with open(os.path.join(data_path, "batches", "batches.meta"), "rb") as f:
        return pickle.load(f)  # a meta file create_batches wrote


def batch_reader(list_file: str, meta: Optional[dict] = None):
    """Reader factory over a train.list/test.list of batch files, yielding
    (image_vector, label) with optional mean subtraction — feeds
    paddle.batch/DataFeeder like the reference's image providers."""

    def reader():
        with open(list_file) as f:
            paths = [ln.strip() for ln in f if ln.strip()]
        mean = meta["mean_image"] if meta is not None else None
        for p in paths:
            with open(p, "rb") as bf:
                batch = pickle.load(bf)  # a batch file create_batches wrote
            for img, lab in zip(batch["images"], batch["labels"]):
                x = img.astype(np.float32)
                if mean is not None:
                    x = x - mean
                yield x, int(lab)

    return reader
