"""Data feeding of the PyTorch/CUDA port: the reader decorators and creators,
token-budget bucketing, the DataFeeder, the prefetch thread, the device
pass cache and the serving plane's open-loop load generator (the JAX
package's ``reader/__init__`` exports)."""

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
from paddle_tpu_torch.reader.loadgen import OpenLoopLoadGen, PrefixMixer  # noqa: F401
from paddle_tpu_torch.reader.pass_cache import PassCache  # noqa: F401
