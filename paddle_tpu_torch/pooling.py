"""Pooling type objects — the ``paddle.v2.pooling`` surface (reference:
python/paddle/trainer_config_helpers/poolings.py)."""

from __future__ import annotations


class BasePoolingType:
    name = "max"


class Max(BasePoolingType):
    name = "max"

    def __init__(self, output_max_index: bool = False):
        # reference MaxPooling(output_max_index=True): the sequence pool
        # emits per-feature argmax timestep indices instead of values
        self.output_max_index = output_max_index


class Avg(BasePoolingType):
    name = "average"


class Sum(BasePoolingType):
    name = "sum"


class SquareRootN(BasePoolingType):
    name = "sqrt_n"  # AverageLevel.kSqrtN sequence pooling


class CudnnMax(Max):
    pass


class CudnnAvg(Avg):
    pass


def pool_name(p) -> str:
    if p is None:
        return "max"
    if isinstance(p, str):
        return p
    if isinstance(p, BasePoolingType) or hasattr(p, "name"):
        return p.name
    if isinstance(p, type) and issubclass(p, BasePoolingType):
        return p.name
    raise TypeError(f"bad pooling type: {p!r}")
