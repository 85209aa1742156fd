"""Data feeding of the PyTorch/CUDA port: the reader decorators and creators,
token-budget bucketing, the DataFeeder, the prefetch thread and the device
pass cache (the JAX package's ``reader/__init__`` exports, less the serving
load generator, ROADMAP Queue 1 item 4)."""

from paddle_tpu_torch.reader import bucketing  # noqa: F401
from paddle_tpu_torch.reader.bucketing import (  # noqa: F401
    sort_within_window,
    token_budget_batch,
)
from paddle_tpu_torch.reader.decorator import (  # noqa: F401
    buffered,
    cache,
    chain,
    compose,
    firstn,
    map_readers,
    shuffle,
    xmap_readers,
)
from paddle_tpu_torch.reader.feeder import DataFeeder  # noqa: F401
from paddle_tpu_torch.reader.pass_cache import PassCache  # noqa: F401
