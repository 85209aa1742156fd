"""CoNLL-05 semantic role labeling (reference:
python/paddle/v2/dataset/conll05.py) — yields the 9-slot SRL sample
(word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, pred_ids, mark, label_ids)
where ctx_* are the words around the predicate broadcast over the sentence,
mark is the 0/1 predicate-position indicator, labels are IOB ids.

Real data path: test.wsj.words.gz + test.wsj.props.gz (CoNLL bracket format)
plus wordDict.txt / verbDict.txt / targetDict.txt / emb in the cache dir —
the same five files the reference downloads.  Deterministic synthetic corpus
otherwise."""

from __future__ import annotations

import gzip
import os

import numpy as np

from paddle_tpu_torch.dataset import common

__all__ = ["get_dict", "get_embedding", "test"]

_SYNTH_SENTS = 300
_WORDS = 200
_VERBS = 20
_LABELS = [
    "O",
    "B-A0",
    "I-A0",
    "B-A1",
    "I-A1",
    "B-V",
    "B-A2",
    "I-A2",
    "B-AM-TMP",
]
UNK_IDX = 0


def _have_real() -> bool:
    return all(
        common.exists("conll05st", f)
        for f in (
            "test.wsj.words.gz",
            "test.wsj.props.gz",
            "wordDict.txt",
            "verbDict.txt",
            "targetDict.txt",
        )
    )


def load_dict(path: str):
    d = {}
    with open(path) as f:
        for i, line in enumerate(f):
            d[line.strip()] = i
    return d


def get_dict():
    """(word_dict, verb_dict, label_dict)."""
    if _have_real():
        return (
            load_dict(common.data_path("conll05st", "wordDict.txt")),
            load_dict(common.data_path("conll05st", "verbDict.txt")),
            load_dict(common.data_path("conll05st", "targetDict.txt")),
        )
    word_dict = {"<unk>": UNK_IDX}
    for i in range(_WORDS):
        word_dict[f"w{i}"] = len(word_dict)
    verb_dict = {f"v{i}": i for i in range(_VERBS)}
    label_dict = {lab: i for i, lab in enumerate(_LABELS)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    """Embedding table aligned with word_dict (reference: the downloaded
    'emb' text matrix); deterministic random table in synthetic mode."""
    word_dict, _, _ = get_dict()
    emb_path = common.data_path("conll05st", "emb")
    if os.path.exists(emb_path):
        return np.loadtxt(emb_path, dtype=np.float32)
    rng = np.random.RandomState(55)
    return rng.randn(len(word_dict), 32).astype(np.float32)


def _bracket_to_iob(tags):
    """CoNLL props bracket column → IOB labels: '(A0*' opens A0, '*)' closes
    the open span, '*' continues (reference conll05.py corpus_reader)."""
    labels = []
    cur = None
    for tag in tags:
        tag = tag.strip()
        if tag.startswith("("):
            cur = tag[1:].split("*")[0]
            labels.append("B-" + cur)
            if tag.endswith(")"):
                cur = None
        elif cur is not None:
            labels.append("I-" + cur)
            if tag.endswith(")"):
                cur = None
        else:
            labels.append("O")
    return labels


def corpus_reader(words_path: str, props_path: str):
    """Yields (words, pred_pos, verb_lemma, iob_labels) — one sample per
    predicate column of each sentence."""

    def flush(words, lemmas, columns):
        for col_idx in range(len(columns[0]) if columns else 0):
            tags = [row[col_idx] for row in columns]
            labels = _bracket_to_iob(tags)
            pred_positions = [i for i, lab in enumerate(labels) if lab == "B-V"]
            pred_pos = pred_positions[0] if pred_positions else 0
            yield words, pred_pos, lemmas[pred_pos], labels

    def reader():
        with gzip.open(words_path, "rt") as wf, gzip.open(props_path, "rt") as pf:
            words, lemmas, columns = [], [], []
            for wline, pline in zip(wf, pf):
                wline, pline = wline.strip(), pline.strip()
                if not wline:
                    yield from flush(words, lemmas, columns)
                    words, lemmas, columns = [], [], []
                    continue
                words.append(wline.split()[0])
                pfields = pline.split()
                lemmas.append(pfields[0])
                columns.append(pfields[1:])
            # files without a trailing blank line still flush the last block
            yield from flush(words, lemmas, columns)

    return reader


def _synth_corpus():
    """Sentences with one predicate; tokens near the predicate get argument
    labels (structured enough for a tagger to learn)."""
    rng = np.random.RandomState(61)
    for _ in range(_SYNTH_SENTS):
        length = int(rng.randint(5, 18))
        words = [f"w{int(i)}" for i in rng.randint(_WORDS, size=length)]
        pred_pos = int(rng.randint(length))
        verb = f"v{int(rng.randint(_VERBS))}"
        labels = ["O"] * length
        labels[pred_pos] = "B-V"
        if pred_pos > 0:
            labels[pred_pos - 1] = "B-A0"
        if pred_pos > 1:
            labels[pred_pos - 2] = "I-A0"
        if pred_pos < length - 1:
            labels[pred_pos + 1] = "B-A1"
        if pred_pos < length - 2:
            labels[pred_pos + 2] = "I-A1"
        yield words, pred_pos, verb, labels


def reader_creator(corpus=None):
    word_dict, verb_dict, label_dict = get_dict()

    def reader():
        for words, pred_pos, verb, labels in (corpus or _synth_corpus)():
            length = len(words)

            def ctx(off):
                i = min(max(pred_pos + off, 0), length - 1)
                return word_dict.get(words[i], UNK_IDX)

            word_ids = [word_dict.get(w, UNK_IDX) for w in words]
            pred_id = verb_dict.get(verb, 0)
            mark = [1 if i == pred_pos else 0 for i in range(length)]
            label_ids = [label_dict.get(lab, label_dict.get("O", 0)) for lab in labels]
            yield (
                word_ids,
                [ctx(-2)] * length,
                [ctx(-1)] * length,
                [ctx(0)] * length,
                [ctx(1)] * length,
                [ctx(2)] * length,
                [pred_id] * length,
                mark,
                label_ids,
            )

    return reader


def test():
    if _have_real():
        return reader_creator(
            corpus_reader(
                common.data_path("conll05st", "test.wsj.words.gz"),
                common.data_path("conll05st", "test.wsj.props.gz"),
            )
        )
    return reader_creator()
def convert(path):
    """Export to recordio shards for the master (reference conll05.py; only
    the test split is publicly redistributable, so it stands in for both)."""
    common.convert(path, test(), 1000, "conl105_train")
    common.convert(path, test(), 1000, "conl105_test")
