"""Movie-review sentiment (reference: python/paddle/v2/dataset/sentiment.py,
NLTK movie_reviews corpus) — yields ([word ids], label∈{0,1}).  Synthetic
class-structured corpus when the real corpus is absent from cache."""

from __future__ import annotations

import os
import tarfile

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["train", "test", "get_word_dict"]

NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000
_VOCAB = 1500


def _have_real() -> bool:
    return os.path.exists(common.data_path("sentiment", "movie_reviews.tar.gz"))


def _real_docs():
    path = common.data_path("sentiment", "movie_reviews.tar.gz")
    with tarfile.open(path) as tf:
        for member in tf.getmembers():
            if not member.isfile():
                continue
            label = 1 if "/pos/" in member.name else 0
            words = tf.extractfile(member).read().decode("latin-1").lower().split()
            yield words, label


def _synth_docs():
    return common.synth_two_class_docs(
        NUM_TOTAL_INSTANCES, _VOCAB, seed=81, min_len=10, max_len=50, signal=0.75
    )


_word_dict = None
_data = None


def _load():
    global _word_dict, _data
    if _data is not None:
        return
    docs = list(_real_docs()) if _have_real() else _synth_docs()
    _word_dict = common.build_word_dict(words for words, _ in docs)
    # interleave pos/neg as the reference's sort_files does before the split
    rng = np.random.RandomState(83)
    order = rng.permutation(len(docs))
    _data = [
        ([_word_dict[w] for w in docs[i][0]], docs[i][1]) for i in order
    ]


def get_word_dict():
    _load()
    return _word_dict


def train():
    _load()

    def reader():
        for sample in _data[:NUM_TRAINING_INSTANCES]:
            yield sample

    return reader


def test():
    _load()

    def reader():
        for sample in _data[NUM_TRAINING_INSTANCES:]:
            yield sample

    return reader
def convert(path):
    """Export to recordio shards for the master (reference sentiment.py)."""
    common.convert(path, train(), 1000, "sentiment_train")
    common.convert(path, test(), 1000, "sentiment_test")
