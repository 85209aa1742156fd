"""Datasets — the ``paddle.v2.dataset`` surface (reference:
python/paddle/v2/dataset/: mnist, cifar, imdb, imikolov, movielens, conll05,
uci_housing, wmt14, flowers, voc2012, sentiment, mq2007).

This environment has zero egress, so each dataset module prefers a local
cache dir (PADDLE_TPU_DATA, same role as the reference's ~/.cache/paddle
common.py) and otherwise falls back to a deterministic synthetic generator
with the real schema — keeping every demo runnable end-to-end.
"""

from paddle_tpu_torch.dataset import (  # noqa: F401
    cifar,
    conll05,
    flowers,
    imdb,
    imikolov,
    mnist,
    movielens,
    mq2007,
    sentiment,
    uci_housing,
    voc2012,
    wmt14,
)

__all__ = [
    "mnist",
    "cifar",
    "imdb",
    "imikolov",
    "movielens",
    "conll05",
    "uci_housing",
    "wmt14",
    "flowers",
    "voc2012",
    "sentiment",
    "mq2007",
]
