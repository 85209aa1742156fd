"""MQ2007 learning-to-rank (reference: python/paddle/v2/dataset/mq2007.py).
Formats: pointwise → (score, feature[46]); pairwise → (d_high[46], d_low[46]);
listwise → (labels list, features list).  Real LETOR text files from cache
when present, else deterministic synthetic queries whose relevance is a linear
function of the features (learnable by a ranker)."""

from __future__ import annotations

import os

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["train", "test"]

FEATURE_DIM = 46
_SYNTH_QUERIES_TRAIN = 120
_SYNTH_QUERIES_TEST = 30
_DOCS_PER_QUERY = 8


class Query:
    def __init__(self, query_id, relevance_score, feature_vector):
        self.query_id = query_id
        self.relevance_score = relevance_score
        self.feature_vector = feature_vector


class QueryList:
    def __init__(self, querylist=None):
        self.querylist = querylist or []

    def __iter__(self):
        return iter(self.querylist)

    def __len__(self):
        return len(self.querylist)

    def __getitem__(self, i):
        return self.querylist[i]

    def _correct_ranking_(self):
        self.querylist.sort(key=lambda x: x.relevance_score, reverse=True)

    def append(self, query):
        self.querylist.append(query)


def _parse_line(line: str) -> Query:
    fields = line.strip().split()
    score = int(fields[0])
    qid = int(fields[1].split(":")[1])
    feat = np.full(FEATURE_DIM, -1.0, dtype=np.float32)
    for tok in fields[2:]:
        if ":" not in tok or tok.startswith("#"):
            break
        k, v = tok.split(":")
        if k.isdigit():
            feat[int(k) - 1] = float(v)
    return Query(qid, score, feat)


def load_from_text(filepath: str):
    querylists = {}
    with open(filepath) as f:
        for line in f:
            if not line.strip():
                continue
            q = _parse_line(line)
            querylists.setdefault(q.query_id, QueryList()).append(q)
    return list(querylists.values())


def _synth_querylists(n_queries: int, seed: int):
    w = np.random.RandomState(91).randn(FEATURE_DIM).astype(np.float32)
    rng = np.random.RandomState(seed)
    out = []
    for qid in range(n_queries):
        ql = QueryList()
        for _ in range(_DOCS_PER_QUERY):
            feat = rng.rand(FEATURE_DIM).astype(np.float32)
            raw = float(feat @ w)
            score = int(np.clip(np.floor((raw + 2) / 1.5), 0, 2))
            ql.append(Query(qid, score, feat))
        out.append(ql)
    return out


def gen_point(querylist: QueryList):
    for q in querylist:
        yield float(q.relevance_score), q.feature_vector


def gen_pair(querylist: QueryList):
    querylist._correct_ranking_()
    for i, hi in enumerate(querylist):
        for lo in querylist[i + 1 :]:
            if hi.relevance_score > lo.relevance_score:
                yield 1.0, hi.feature_vector, lo.feature_vector


def gen_list(querylist: QueryList):
    querylist._correct_ranking_()
    labels = [float(q.relevance_score) for q in querylist]
    features = [q.feature_vector for q in querylist]
    yield labels, features


def _reader(split: str, fmt: str):
    path = common.data_path("MQ2007", f"{split}.txt")
    if not os.path.exists(path):
        # LETOR distributes per-fold files; accept Fold1 layout too.
        fold = common.data_path("MQ2007", "Fold1", f"{split}.txt")
        if os.path.exists(fold):
            path = fold

    def reader():
        if os.path.exists(path):
            qls = load_from_text(path)
        elif split == "train":
            qls = _synth_querylists(_SYNTH_QUERIES_TRAIN, seed=93)
        else:
            qls = _synth_querylists(_SYNTH_QUERIES_TEST, seed=97)
        gen = {"pointwise": gen_point, "pairwise": gen_pair, "listwise": gen_list}[fmt]
        for ql in qls:
            yield from gen(ql)

    return reader


def train(format: str = "pairwise"):
    return _reader("train", format)


def test(format: str = "pairwise"):
    return _reader("test", format)
