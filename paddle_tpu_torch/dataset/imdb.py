"""IMDB sentiment (reference: python/paddle/v2/dataset/imdb.py) — yields
([word ids], label∈{0,1}).  Real aclImdb tarball from cache when present;
otherwise a deterministic synthetic corpus whose positive/negative classes use
disjoint-leaning word distributions (learnable)."""

from __future__ import annotations

import os
import re
import string
import tarfile

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["build_dict", "word_dict", "train", "test"]

_VOCAB = 2000
_SYNTH_TRAIN = 1500
_SYNTH_TEST = 300
_ARCHIVE = "aclImdb_v1.tar.gz"


def tokenize(text: str):
    return text.lower().translate(
        str.maketrans("", "", string.punctuation)
    ).split()


def _iter_archive(pattern: str):
    path = common.data_path("imdb", _ARCHIVE)
    with tarfile.open(path) as tarf:
        tf = tarf.next()
        while tf is not None:
            if bool(pattern.match(tf.name)):
                yield tokenize(tarf.extractfile(tf).read().decode("latin-1"))
            tf = tarf.next()


def _synth_docs(n: int, seed: int):
    return common.synth_two_class_docs(
        n, _VOCAB, seed, min_len=8, max_len=40, signal=0.8
    )


def _have_real() -> bool:
    return os.path.exists(common.data_path("imdb", _ARCHIVE))


def build_dict(pattern=None, cutoff: int = 150):
    """word → id, most frequent first; '<unk>' is the last id."""
    if _have_real():
        pat = re.compile(pattern or r"aclImdb/train/.*\.txt$")
        word_idx = common.build_word_dict(_iter_archive(pat), cutoff=cutoff)
    else:
        word_idx = common.build_word_dict(
            doc for doc, _ in _synth_docs(_SYNTH_TRAIN, seed=21)
        )
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def word_dict():
    return build_dict()


def _reader(word_idx, train_split: bool, n: int, seed: int):
    unk = word_idx["<unk>"]

    def reader():
        if _have_real():
            part = "train" if train_split else "test"
            for label, sub in ((1, "pos"), (0, "neg")):
                pat = re.compile(rf"aclImdb/{part}/{sub}/.*\.txt$")
                for doc in _iter_archive(pat):
                    yield [word_idx.get(w, unk) for w in doc], label
        else:
            for doc, label in _synth_docs(n, seed):
                yield [word_idx.get(w, unk) for w in doc], label

    return reader


def train(word_idx):
    return _reader(word_idx, True, _SYNTH_TRAIN, seed=21)


def test(word_idx):
    return _reader(word_idx, False, _SYNTH_TEST, seed=23)
def convert(path):
    """Export to recordio shards for the master (reference imdb.py)."""
    w = word_dict()
    common.convert(path, train(w), 1000, "imdb_train")
    common.convert(path, test(w), 1000, "imdb_test")
