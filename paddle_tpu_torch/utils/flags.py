"""Global flags plane of the port — the counterpart of
``paddle_tpu/utils/flags.py``, with the same three override layers, strongest
last: defaults < environment (``PADDLE_TPU_TORCH_<NAME>``) < explicit
``set_flag`` / ``paddle_tpu_torch.init(**kwargs)``.  Unknown names raise."""

from __future__ import annotations

import os
from typing import Any, Dict

_DEFS: Dict[str, tuple] = {}  # name -> (type, default, help)
_VALUES: Dict[str, Any] = {}

_ENV_PREFIX = "PADDLE_TPU_TORCH_"


def define_flag(name: str, default, help_: str = "") -> None:
    """Register a flag; re-registering with the identical type and default
    is a no-op, a conflicting re-registration raises."""
    if name in _DEFS:
        old_type, old_default, _ = _DEFS[name]
        if old_type is not type(default) or old_default != default:
            raise ValueError(
                f"flag {name!r} is already defined with default "
                f"{old_default!r} ({old_type.__name__}); re-registering it "
                f"with default {default!r} ({type(default).__name__}) would "
                "silently change behavior"
            )
    _DEFS[name] = (type(default), default, help_)


def _coerce(name: str, value):
    t = _DEFS[name][0]
    if t is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes")
    return t(value)


def get_flag(name: str):
    if name not in _DEFS:
        raise KeyError(f"unknown flag {name!r}; defined: {sorted(_DEFS)}")
    if name in _VALUES:
        return _VALUES[name]
    env = os.environ.get(_ENV_PREFIX + name.upper())
    if env is not None:
        return _coerce(name, env)
    return _DEFS[name][1]


def set_flag(name: str, value) -> None:
    if name not in _DEFS:
        raise KeyError(f"unknown flag {name!r}; defined: {sorted(_DEFS)}")
    _VALUES[name] = _coerce(name, value)


def set_flags(**kwargs) -> None:
    for k, v in kwargs.items():
        set_flag(k, v)


def reset_flags() -> None:
    _VALUES.clear()


define_flag("seed", 0, "global RNG seed")
define_flag("log_period", 100, "log training stats every N batches")
define_flag("compute_dtype", "", "bfloat16 enables mixed precision")
define_flag("use_flash_attention", False,
            "hand-written flash-attention kernels (ops/flash_attention.py: "
            "the forward, and the dq and dk/dv backward kernels when a "
            "gradient is taken) for multi_head_attention with equal query "
            "and key lengths that pass supported(): the CUDA kernels on a "
            "CUDA tensor, their plain versions on a CPU tensor; off keeps "
            "the dense [T, T] path (counterpart of use_pallas_attention)")
define_flag("divergence_sentinel", True,
            "a finiteness check of the cost and the gradients' global norm "
            "in every train step (trainer/step.py): an unhealthy step is "
            "skipped, leaving parameters, layer state and optimizer state "
            "bit-identical, and its health and grad_norm ride the metrics; "
            "the decision rides the cost's host copy, so it adds no sync")
define_flag("saving_period", 1,
            "SGD.train with save_dir writes pass-%05d every N passes (the "
            "default of the JAX package's train(saving_period=...) and of "
            "its CLI's --saving_period)")
define_flag("checkpoint_period_batches", 50,
            "full-state checkpoint cadence in batches of SGD.train with "
            "checkpoint_dir (the recovery plane, not ported yet)")
define_flag("use_bucketing", False,
            "length-bucketed feed for variable-length sequence workloads: "
            "the SGD trainer's DataFeeder pads sequence slots to the "
            "canonical 16*2^k shape ladder (core.batch.DEFAULT_LADDER), the "
            "shapes reader.bucketing.token_budget_batch packs batches for")
define_flag("scan_early_exit", True,
            "recurrent scans skip dead steps: the steps where every row is "
            "padding (the batch's longest sequence sits below the padded "
            "ladder rung) are not run, the carry passes through; the live "
            "range comes from the host copy of the lengths the feeder made, "
            "so no step reads the device")
define_flag("fused_attention_gru", True,
            "recurrent_group decoder steps that match the v1 attention-GRU "
            "idiom (simple_attention + gru_step, the NMT decoder) run the "
            "fused core (ops/rnn.py AttGruCore: the state projection and the "
            "GRU gates share one GEMM, the target-side input projection runs "
            "once outside the loop, the weight gradients are post-loop "
            "einsums) instead of the generic per-layer step; steps that do "
            "not match always take the generic path")
