"""PyDataProvider2-compatible ``@provider`` surface (reference:
python/paddle/trainer/PyDataProvider2.py:329-497 and the C++ host
paddle/gserver/dataproviders/PyDataProvider2.cpp:665).

The reference embeds CPython inside the C++ trainer and pulls samples from a
user generator decorated with ``@provider``; slot declarations
(dense/sparse/index × seq/sub-seq) tell the C++ side how to pack Arguments.
Here the roles flip — the framework *is* Python — so ``@provider`` wraps the
generator into a standard reader-creator that plugs straight into the v2
trainer's DataFeeder, with the same decorator knobs:

* ``input_types`` — list or dict of slot declarations (core.data_types)
* ``should_shuffle`` / ``pool_size`` — buffered shuffle (PyDataProvider2.cpp
  pool semantics)
* ``cache`` — CacheType.CACHE_PASS_IN_MEM keeps pass 1's samples in host RAM
* ``init_hook`` — called with a settings object (settings.input_types, slots,
  plus any kwargs) before reading
* ``check`` — validate each sample against the declared input_types
* ``calc_batch_size`` — custom per-sample weight (honored by the feeder's
  batching when provided)
"""

from __future__ import annotations

import collections.abc
import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np


def _is_oneshot_iter(v) -> bool:
    """py2-era providers yield ``map(int, row)``-style fields — and just as
    legally, generator expressions; under py3 all of these are one-shot
    iterators the feeder can't len()/index.  Any Iterator counts (str/bytes/
    ndarray are Iterables, not Iterators — excluded for clarity)."""
    return isinstance(v, collections.abc.Iterator) and not isinstance(
        v, (str, bytes, np.ndarray)
    )

from paddle_tpu_torch.core import data_types as dt
from paddle_tpu_torch.reader import decorator as reader_dec

__all__ = [
    "provider",
    "CacheType",
    "DataProviderConverter",
    # re-exported slot declarations (reference PyDataProvider2.py:73-215)
    "dense_slot",
    "dense_vector",
    "dense_vector_sequence",
    "sparse_non_value_slot",
    "sparse_binary_vector",
    "sparse_binary_vector_sequence",
    "sparse_value_slot",
    "sparse_vector",
    "sparse_vector_sequence",
    "index_slot",
    "integer_value",
    "integer_value_sequence",
    "integer_value_sub_sequence",
    "dense_vector_sub_sequence",
    "sparse_binary_vector_sub_sequence",
    "sparse_vector_sub_sequence",
]

dense_slot = dt.dense_vector
dense_vector = dt.dense_vector
dense_vector_sequence = dt.dense_vector_sequence
sparse_non_value_slot = dt.sparse_binary_vector
sparse_binary_vector = dt.sparse_binary_vector
sparse_binary_vector_sequence = dt.sparse_binary_vector_sequence
sparse_value_slot = dt.sparse_float_vector
sparse_vector = dt.sparse_float_vector
sparse_vector_sequence = dt.sparse_float_vector_sequence
index_slot = dt.integer_value
integer_value = dt.integer_value
integer_value_sequence = dt.integer_value_sequence
integer_value_sub_sequence = dt.integer_value_sub_sequence
dense_vector_sub_sequence = dt.dense_vector_sub_sequence
sparse_binary_vector_sub_sequence = dt.sparse_binary_vector_sub_sequence
sparse_vector_sub_sequence = dt.sparse_float_vector_sub_sequence


class CacheType:
    NO_CACHE = 0
    CACHE_PASS_IN_MEM = 1


class _Settings:
    """The object handed to init_hook (reference PyDataProvider2.py:356-377:
    'settings' carries input_types plus user args).  Reference hooks declare
    types by assigning EITHER ``settings.input_types`` (PyDataProvider2.py
    initializer pattern) OR ``settings.slots`` (the benchmark image provider,
    benchmark/paddle/image/provider.py initHook) — ``declared_types`` reads
    whichever was set."""

    def __init__(self, **kwargs):
        import logging

        self.input_types: Optional[Sequence[dt.InputType]] = None
        self.slots: Optional[Sequence[dt.InputType]] = None
        self.should_shuffle: Optional[bool] = None
        # reference hooks log through settings.logger (sequenceGen.py hook)
        self.logger = logging.getLogger("paddle_tpu_torch.provider")
        for k, v in kwargs.items():
            setattr(self, k, v)

    def set_input_types(self, input_types):
        self.input_types = input_types
        self.slots = input_types

    def declared_types(self):
        return self.input_types if self.input_types is not None else self.slots


def _normalize_types(
    input_types: Union[Sequence[dt.InputType], Dict[str, dt.InputType], None]
):
    if input_types is None:
        return None, None
    if isinstance(input_types, dict):
        names = list(input_types.keys())
        return [input_types[n] for n in names], names
    return list(input_types), None


def _check_sample(sample, types: Sequence[dt.InputType]):
    items = sample if isinstance(sample, (list, tuple)) else (sample,)
    if len(items) != len(types):
        raise ValueError(
            f"sample has {len(items)} slots, provider declares {len(types)}"
        )
    for value, t in zip(items, types):
        if t.kind == dt.SlotKind.INDEX and t.seq == dt.SeqLevel.NONE:
            if not np.issubdtype(np.asarray(value).dtype, np.integer):
                raise ValueError(f"index slot got non-integer {value!r}")
        if t.kind == dt.SlotKind.DENSE and t.seq == dt.SeqLevel.NONE:
            arr = np.asarray(value, dtype=np.float32)
            if arr.size != t.dim:
                raise ValueError(
                    f"dense slot dim mismatch: got {arr.size}, want {t.dim}"
                )


def provider(
    input_types=None,
    should_shuffle=None,
    pool_size=1024,
    min_pool_size=-1,
    can_over_batch_size=True,
    calc_batch_size=None,
    cache=CacheType.NO_CACHE,
    check=False,
    check_fail_continue=False,
    init_hook: Optional[Callable[..., None]] = None,
    **outter_kwargs,
):
    """Decorate ``def process(settings, filename): yield sample``.

    The decorated symbol becomes a factory: calling it with the file list (or
    any objects the process function understands) plus init_hook kwargs
    returns a reader-creator compatible with ``trainer.SGD.train``.
    """

    types, names = _normalize_types(input_types)

    def __wrapper__(generator):
        @functools.wraps(generator)
        def factory(*files, **hook_kwargs):
            # is_train resolves should_shuffle=None the way the reference
            # trainer context does (shuffle for train, stable order for
            # test/predict); it stays in hook_kwargs so init_hook sees it
            # too, matching the reference PyDataProvider2 hook contract.
            is_train = bool(hook_kwargs.get("is_train", True))
            settings = _Settings(**outter_kwargs)
            if types is not None:
                settings.set_input_types(types)
            settings.should_shuffle = should_shuffle
            if init_hook is not None:
                init_hook(settings, file_list=list(files), **hook_kwargs)
            # init_hook may (re)declare input_types — or settings.slots —
            # (the reference initializer pattern); re-normalize so dict
            # samples and checks use the hook's declaration.
            eff_types, eff_names = types, names
            declared = settings.declared_types()
            if declared is not None and declared is not types:
                eff_types, eff_names = _normalize_types(declared)

            def base_reader():
                file_list = files if files else (None,)
                for f in file_list:
                    for sample in generator(settings, f):
                        if isinstance(sample, dict):
                            if eff_names is None:
                                raise ValueError(
                                    "generator yields dict samples but "
                                    "input_types was not a dict"
                                )
                            sample = tuple(sample[n] for n in eff_names)
                        elif _is_oneshot_iter(sample):
                            # a whole-sample iterator (map/filter/zip or a
                            # generator expression, reference benchmark/
                            # paddle/rnn/provider.py:72); materialize so the
                            # feeder can len()/index it
                            sample = tuple(sample)
                        if isinstance(sample, tuple):
                            sample = tuple(
                                list(fld) if _is_oneshot_iter(fld) else fld
                                for fld in sample
                            )
                        if check and eff_types:
                            try:
                                _check_sample(sample, eff_types)
                            except ValueError:
                                if check_fail_continue:
                                    continue
                                raise
                        yield sample

            rd = base_reader
            if cache == CacheType.CACHE_PASS_IN_MEM:
                rd = reader_dec.cache(rd)
            # init_hook may override the decorator's should_shuffle (the
            # reference's test/predict readers do exactly this); None falls
            # back to the trainer context: shuffle only when training.
            shuffle_flag = settings.should_shuffle
            if shuffle_flag is None:
                shuffle_flag = is_train
            if shuffle_flag:
                rd = reader_dec.shuffle(rd, pool_size)
            if cache == CacheType.CACHE_PASS_IN_MEM:
                # the device half of CACHE_PASS_IN_MEM: tag the reader so
                # SGD.train keeps the decoded pass on the device and replays
                # it for passes >= 2 (reader/pass_cache.py); the host-RAM
                # cache above still spares the generator re-run.  Replay shuffling
                # follows the provider's own shuffle intent: a
                # should_shuffle=False provider (ordered/curriculum data)
                # must replay in capture order, like the reference's
                # host-RAM cache did.
                rd.cache_pass_in_mem = True
                rd.cache_pass_shuffle = bool(shuffle_flag)
            return rd

        def resolve_input_types(file_list=(), **hook_kwargs):
            """Run init_hook (if any) on a fresh settings object and return
            (types, slot_names) — parse_config uses this to learn slot types
            that the provider only declares inside its hook (reference
            PyDataProvider2 initializer pattern, run with the config's real
            args + file list like PyDataProvider2.cpp:665 does)."""
            settings = _Settings(**outter_kwargs)
            if types is not None:
                settings.set_input_types(types)
            if init_hook is not None:
                init_hook(settings, file_list=list(file_list), **hook_kwargs)
            return _normalize_types(settings.declared_types())

        factory.input_types = types
        factory.slot_names = names
        factory.resolve_input_types = resolve_input_types
        factory.calc_batch_size = calc_batch_size
        return factory

    return __wrapper__


class DataProviderConverter:
    """numpy/py-list samples → padded Batch (reference:
    paddle/py_paddle/dataprovider_converter.py:247 built swig Arguments; here
    the target is the padded Batch the train step consumes, on `device`:
    the card unless the caller passes ``device="cpu"``)."""

    def __init__(self, input_types: Sequence[dt.InputType], device=None):
        from paddle_tpu_torch.reader.feeder import DataFeeder

        if isinstance(input_types, dict):
            named = list(input_types.items())
        else:
            named = [(f"slot_{i}", t) for i, t in enumerate(input_types)]
        self._feeder = DataFeeder(named, device=device)

    def convert(self, dat, argument=None):
        return self._feeder(dat)

    __call__ = convert
