"""WMT14 fr→en (reference: python/paddle/v2/dataset/wmt14.py) — yields
(src_ids, trg_ids_with_<s>, trg_ids_next_with_<e>).  Dict ids 0/1/2 are
<s>/<e>/<unk> as in the reference.  Real wmt14 tarball from cache when
present; otherwise a deterministic synthetic parallel corpus where the target
is a learnable transform (reversal + vocab offset) of the source."""

from __future__ import annotations

import os
import tarfile

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["train", "test", "build_dict", "get_dict"]

START = "<s>"
END = "<e>"
UNK = "<unk>"
UNK_IDX = 2

_ARCHIVE = "wmt14.tgz"
_SYNTH_TRAIN = 800
_SYNTH_TEST = 150
_SYNTH_WORDS = 300  # true synthetic vocab (ids 3..)


def _have_real() -> bool:
    return os.path.exists(common.data_path("wmt14", _ARCHIVE))


def _synth_pairs(n: int, seed: int):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        length = int(rng.randint(3, 15))
        src = rng.randint(_SYNTH_WORDS, size=length)
        trg = (src[::-1] + 7) % _SYNTH_WORDS
        yield (
            [f"f{i}" for i in src],
            [f"e{i}" for i in trg],
        )


def _synth_dicts(dict_size: int):
    src_dict = {START: 0, END: 1, UNK: 2}
    trg_dict = {START: 0, END: 1, UNK: 2}
    for i in range(min(_SYNTH_WORDS, dict_size - 3)):
        src_dict[f"f{i}"] = 3 + i
        trg_dict[f"e{i}"] = 3 + i
    return src_dict, trg_dict


def _real_dicts(dict_size: int):
    path = common.data_path("wmt14", _ARCHIVE)
    src_dict, trg_dict = {}, {}
    with tarfile.open(path) as tf:
        for member in tf.getmembers():
            which = None
            if member.name.endswith("src.dict"):
                which = src_dict
            elif member.name.endswith("trg.dict"):
                which = trg_dict
            if which is not None:
                for i, line in enumerate(tf.extractfile(member)):
                    if i >= dict_size:
                        break
                    which[line.decode().strip()] = i
    return src_dict, trg_dict


def _real_pairs(file_sub: str):
    path = common.data_path("wmt14", _ARCHIVE)
    with tarfile.open(path) as tf:
        for member in tf.getmembers():
            if file_sub in member.name and member.isfile():
                for line in tf.extractfile(member):
                    fields = line.decode().strip().split("\t")
                    if len(fields) == 2:
                        yield fields[0].split(), fields[1].split()


def build_dict(dict_size: int):
    if _have_real():
        return _real_dicts(dict_size)
    return _synth_dicts(dict_size)


def _reader(dict_size: int, train_split: bool):
    src_dict, trg_dict = build_dict(dict_size)

    def pairs():
        if _have_real():
            yield from _real_pairs("train/" if train_split else "test/")
        elif train_split:
            yield from _synth_pairs(_SYNTH_TRAIN, seed=41)
        else:
            yield from _synth_pairs(_SYNTH_TEST, seed=43)

    def reader():
        for src_words, trg_words in pairs():
            src_ids = [src_dict.get(w, UNK_IDX) for w in src_words]
            trg = [trg_dict.get(w, UNK_IDX) for w in trg_words]
            trg_ids = [trg_dict[START]] + trg
            trg_ids_next = trg + [trg_dict[END]]
            yield src_ids, trg_ids, trg_ids_next

    return reader


def train(dict_size: int):
    return _reader(dict_size, train_split=True)


def test(dict_size: int):
    return _reader(dict_size, train_split=False)


def get_dict(dict_size: int, reverse: bool = True):
    src_dict, trg_dict = build_dict(dict_size)
    if reverse:
        src_dict = {v: k for k, v in src_dict.items()}
        trg_dict = {v: k for k, v in trg_dict.items()}
    return src_dict, trg_dict
def convert(path):
    """Export to recordio shards for the master (reference wmt14.py)."""
    dict_size = 30000
    common.convert(path, train(dict_size), 1000, "wmt14_train")
    common.convert(path, test(dict_size), 1000, "wmt14_test")
