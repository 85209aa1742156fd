"""Dataset cache helpers (reference: python/paddle/v2/dataset/common.py)."""

from __future__ import annotations

import hashlib
import logging
import os
import random
import time
from typing import Callable, Optional

_log = logging.getLogger("paddle_tpu_torch.dataset")

DATA_HOME = os.environ.get(
    "PADDLE_TPU_DATA", os.path.expanduser("~/.cache/paddle_tpu/dataset")
)


def data_path(*parts: str) -> str:
    return os.path.join(DATA_HOME, *parts)


def exists(*parts: str) -> bool:
    return os.path.exists(data_path(*parts))


def md5file(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _urllib_fetch(url: str, dest: str) -> None:
    """Stream ``url`` into ``dest`` (the default fetcher; tests inject a
    fake via ``download(fetch_fn=...)``)."""
    from urllib.request import urlopen

    with urlopen(url, timeout=60) as r, open(dest, "wb") as f:
        for chunk in iter(lambda: r.read(1 << 20), b""):
            f.write(chunk)


def download(
    url: str,
    module: str,
    md5sum: Optional[str] = None,
    save_name: Optional[str] = None,
    max_retries: int = 5,
    backoff: float = 0.5,
    fetch_fn: Optional[Callable[[str, str], None]] = None,
    rng: Optional[random.Random] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> str:
    """Fetch ``url`` into the dataset cache with bounded retry (reference
    python/paddle/v2/dataset/common.py:37 ``download`` — which dies on the
    first flaky HTTP read; this one doesn't).

    Robustness contract:

    * **bounded retry with exponential backoff + jitter** — up to
      ``max_retries`` attempts, sleeping ``backoff * 2**attempt`` seconds
      plus up to 25% jitter between them (the jitter keeps a fleet of
      trainers from re-hammering a recovering mirror in lockstep);
    * **partial-file cleanup** — every attempt writes to a ``.part`` file
      that is removed on failure and atomically renamed into place only
      after the (optional) md5 check passes, so a torn download can never
      be mistaken for the dataset by the next run;
    * an md5 mismatch counts as a failed attempt (truncated-but-complete
      HTTP bodies exist), and a cached file that matches short-circuits.

    Returns the cached file path."""
    if max_retries < 1:
        raise ValueError(f"max_retries must be >= 1, got {max_retries}")
    fetch = fetch_fn or _urllib_fetch
    jitter = rng or random.Random()
    dirname = data_path(module)
    os.makedirs(dirname, exist_ok=True)
    dest = os.path.join(dirname, save_name or url.split("/")[-1])
    if os.path.exists(dest) and (md5sum is None or md5file(dest) == md5sum):
        return dest
    part = dest + ".part"
    last_err: Optional[Exception] = None
    for attempt in range(max_retries):
        if attempt:
            delay = backoff * (2 ** (attempt - 1))
            delay *= 1.0 + 0.25 * jitter.random()
            _log.warning(
                "download %s failed (%s); retry %d/%d in %.2fs",
                url, last_err, attempt, max_retries - 1, delay,
            )
            sleep(delay)
        try:
            fetch(url, part)
            if md5sum is not None and md5file(part) != md5sum:
                raise IOError(
                    f"md5 mismatch for {url} (torn or tampered download)"
                )
            os.replace(part, dest)
            return dest
        except Exception as exc:  # noqa: BLE001 — retry any fetch failure
            last_err = exc
            try:
                os.remove(part)  # never leave a torn .part behind
            except OSError:
                pass
    raise IOError(
        f"download {url} failed after {max_retries} attempt(s): {last_err}"
    )


def synth_two_class_docs(
    n: int,
    vocab: int,
    seed: int,
    min_len: int,
    max_len: int,
    signal: float = 0.8,
    word_fmt: str = "w{}",
):
    """Deterministic two-class word corpus: positive docs draw from the low
    half of the vocab, negative from the high half, with (1-signal) crossover
    noise — separable enough for a text classifier to learn.  Shared by the
    imdb/sentiment synthetic fallbacks."""
    import numpy as np

    rng = np.random.RandomState(seed)
    docs = []
    for _ in range(n):
        label = int(rng.randint(2))
        lo, hi = (0, vocab // 2) if label else (vocab // 2, vocab)
        length = int(rng.randint(min_len, max_len))
        ids = np.where(
            rng.rand(length) < signal,
            rng.randint(lo, hi, size=length),
            rng.randint(0, vocab, size=length),
        )
        docs.append(([word_fmt.format(int(i)) for i in ids], label))
    return docs


def dict_from_freq(freq, cutoff: int = 0):
    """word → id from a frequency table, most frequent first (deterministic
    tie-break on the word)."""
    if cutoff:
        freq = {w: c for w, c in freq.items() if c > cutoff}
    ordered = sorted(freq.items(), key=lambda x: (-x[1], x[0]))
    return {w: i for i, (w, _) in enumerate(ordered)}


def build_word_dict(docs, cutoff: int = 0):
    """word → id from an iterable of token lists (see dict_from_freq)."""
    freq = {}
    for words in docs:
        for w in words:
            freq[w] = freq.get(w, 0) + 1
    return dict_from_freq(freq, cutoff)


def convert(output_path, reader, line_count, name_prefix, seed: int = 0):
    """Export any reader to recordio shards the elastic master serves
    (reference python/paddle/v2/dataset/common.py:187 ``convert``; every
    dataset module exposes a ``convert(path)`` built on it).

    Samples are pickled one-per-record into ``<output_path>/<name_prefix>-
    %05d`` shard files, ``line_count`` samples per shard, each shard
    shuffled before writing (the reference's max_lines_to_shuffle).  Feed
    the shards to ``master.Service.set_dataset([pattern])`` and read them
    back through ``reader.creator.cloud_reader`` (or ``recordio_local``
    without a master).

    Returns the list of shard paths written."""
    import pickle
    import random

    from paddle_tpu_torch.io import recordio

    if line_count < 1:
        raise ValueError(f"line_count must be >= 1, got {line_count}")
    os.makedirs(output_path, exist_ok=True)
    rng = random.Random(seed)
    paths = []

    def write_shard(samples):
        path = os.path.join(output_path, f"{name_prefix}-{len(paths):05d}")
        rng.shuffle(samples)
        recordio.write_records(
            path, (pickle.dumps(s, protocol=pickle.HIGHEST_PROTOCOL)
                   for s in samples),
        )
        paths.append(path)

    buf = []
    for sample in reader():
        buf.append(sample)
        if len(buf) >= line_count:
            write_shard(buf)
            buf = []
    if buf or not paths:  # an empty reader still writes one (empty) shard
        write_shard(buf)
    return paths
