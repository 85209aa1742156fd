"""PTB language-model corpus (reference: python/paddle/v2/dataset/imikolov.py).
NGRAM mode yields n-tuples of word ids; SEQ mode yields ([<s> ids </s>],).
Real simple-examples tarball from cache when present, else a deterministic
synthetic Markov-chain corpus (bigram structure so an n-gram LM learns)."""

from __future__ import annotations

import os
import tarfile

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["train", "test", "build_dict", "DataType"]

_ARCHIVE = "simple-examples.tgz"
_VOCAB = 500
_SYNTH_SENTS_TRAIN = 1200
_SYNTH_SENTS_TEST = 200


class DataType:
    NGRAM = 1
    SEQ = 2


def _have_real() -> bool:
    return os.path.exists(common.data_path("imikolov", _ARCHIVE))


def _real_sentences(filename: str):
    path = common.data_path("imikolov", _ARCHIVE)
    with tarfile.open(path) as tarf:
        for member in tarf.getmembers():
            if member.name.endswith(filename):
                for line in tarf.extractfile(member):
                    yield line.decode().strip().split()


def _synth_sentences(n: int, seed: int):
    """First-order Markov chain over the synthetic vocab: word w transitions
    to one of 4 fixed successors with high probability."""
    rng_fixed = np.random.RandomState(77)
    successors = rng_fixed.randint(0, _VOCAB, size=(_VOCAB, 4))
    rng = np.random.RandomState(seed)
    for _ in range(n):
        length = int(rng.randint(4, 20))
        w = int(rng.randint(_VOCAB))
        sent = [w]
        for _ in range(length - 1):
            if rng.rand() < 0.85:
                w = int(successors[w, rng.randint(4)])
            else:
                w = int(rng.randint(_VOCAB))
            sent.append(w)
        yield [f"w{i}" for i in sent]


def word_count(sents, word_freq=None):
    word_freq = word_freq if word_freq is not None else {}
    for sent in sents:
        for w in sent:
            word_freq[w] = word_freq.get(w, 0) + 1
        word_freq["<s>"] = word_freq.get("<s>", 0) + 1
        word_freq["<e>"] = word_freq.get("<e>", 0) + 1
    return word_freq


def build_dict(min_word_freq: int = 50):
    if _have_real():
        freq = word_count(_real_sentences("ptb.train.txt"))
        freq.pop("<unk>", None)
        word_idx = common.dict_from_freq(freq, cutoff=min_word_freq)
    else:
        freq = word_count(_synth_sentences(_SYNTH_SENTS_TRAIN, seed=31))
        word_idx = common.dict_from_freq(freq)
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def _reader(word_idx, n: int, data_type: int, train_split: bool):
    unk = word_idx["<unk>"]

    def sents():
        if _have_real():
            fname = "ptb.train.txt" if train_split else "ptb.valid.txt"
            yield from _real_sentences(fname)
        elif train_split:
            yield from _synth_sentences(_SYNTH_SENTS_TRAIN, seed=31)
        else:
            yield from _synth_sentences(_SYNTH_SENTS_TEST, seed=37)

    def reader():
        for sent in sents():
            if data_type == DataType.NGRAM:
                assert n > -1, "Invalid gram length"
                ids = (
                    [word_idx["<s>"]]
                    + [word_idx.get(w, unk) for w in sent]
                    + [word_idx["<e>"]]
                )
                if len(ids) >= n:
                    for i in range(n, len(ids) + 1):
                        yield tuple(ids[i - n : i])
            elif data_type == DataType.SEQ:
                ids = [word_idx.get(w, unk) for w in sent]
                src = [word_idx["<s>"]] + ids
                trg = ids + [word_idx["<e>"]]
                yield src, trg
            else:
                raise AssertionError("Unknown data type")

    return reader


def train(word_idx, n, data_type=DataType.NGRAM):
    return _reader(word_idx, n, data_type, train_split=True)


def test(word_idx, n, data_type=DataType.NGRAM):
    return _reader(word_idx, n, data_type, train_split=False)
def convert(path):
    """Export to recordio shards for the master (reference imikolov.py)."""
    n = 5
    word_idx = build_dict()
    common.convert(path, train(word_idx, n), 1000, "imikolov_train")
    common.convert(path, test(word_idx, n), 1000, "imikolov_test")
