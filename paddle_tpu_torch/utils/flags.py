"""Global flags plane of the port — the counterpart of
``paddle_tpu/utils/flags.py``, with the same three override layers, strongest
last: defaults < environment (``PADDLE_TPU_TORCH_<NAME>``) < explicit
``set_flag`` / ``paddle_tpu_torch.init(**kwargs)``.  Unknown names raise
here (``init`` ignores them, as the JAX package's does).  An alias
(``use_pallas_attention``, the JAX package's name) reads and writes its
target flag."""

from __future__ import annotations

import os
from typing import Any, Dict

_DEFS: Dict[str, tuple] = {}  # name -> (type, default, help)
_VALUES: Dict[str, Any] = {}

_ENV_PREFIX = "PADDLE_TPU_TORCH_"

# alias -> flag: the JAX package's names for flags the port renamed
_ALIASES: Dict[str, str] = {"use_pallas_attention": "use_flash_attention"}


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
    name = _ALIASES.get(name, name)
    if name not in _DEFS:
        raise KeyError(f"unknown flag {name!r}; defined: {sorted(_DEFS)}")
    if name in _VALUES:
        return _VALUES[name]
    env = os.environ.get(_ENV_PREFIX + name.upper())
    if env is not None:
        return _coerce(name, env)
    return _DEFS[name][1]


def set_flag(name: str, value) -> None:
    name = _ALIASES.get(name, name)
    if name not in _DEFS:
        raise KeyError(f"unknown flag {name!r}; defined: {sorted(_DEFS)}")
    _VALUES[name] = _coerce(name, value)


def set_flags(**kwargs) -> None:
    for k, v in kwargs.items():
        set_flag(k, v)


def all_flags() -> Dict[str, Any]:
    return {name: get_flag(name) for name in _DEFS}


def reset_flags() -> None:
    _VALUES.clear()


define_flag("use_tpu", True,
            "accepted for the JAX package's surface (init(use_tpu=...)); the "
            "device comes from the entry points' device= argument")
define_flag("use_gpu", True,
            "accepted for the reference's surface (init(use_gpu=...)); the "
            "device comes from the entry points' device= argument, so "
            "use_gpu=False does not move the port to the CPU")
define_flag("trainer_count", 1,
            "accepted for the reference's surface; the port trains on one "
            "device")
define_flag("seed", 0, "global RNG seed")
define_flag("log_period", 100, "log training stats every N batches")
define_flag("show_parameter_stats_period", 0,
            "log per-parameter stats (size, mean, mean |x|, min, max) every "
            "N batches of SGD.train (0 = off)")
define_flag("check_nans", False,
            "NaN checks (the JAX package's jax nan-debugging); not ported yet: "
            "init(check_nans=True) raises")
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
define_flag("bucketing_token_budget", 0,
            "padded tokens per step for use_bucketing in v1_compat's "
            "make_batched_reader (0 = derive from the config batch size x "
            "the tallest ladder rung of the first window, the padded token "
            "count the unbucketed feed would spend per step)")
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
define_flag("beam_size", 5, "default generation beam width")
define_flag("serving_max_slots", 8,
            "in-flight sequence capacity of the serving plane "
            "(serving/engine.py): the continuous-batching decode step runs "
            "at a slot-count ladder rung up to this many live sequences; "
            "requests beyond it queue")
define_flag("serving_block_tokens", 16,
            "tokens per block of the block-paged decode-state cache "
            "(serving/pages.py).  Must divide the base shape-ladder rung "
            "(16) so every padded source extent splits into whole blocks "
            "and the gathered attention extent stays a ladder rung")
define_flag("serving_hbm_budget_mb", 64,
            "per-device memory budget of the block-paged serving cache: "
            "capacity = budget // bytes_per_block, and exhaustion is a "
            "refused admission (the request waits in queue), never an "
            "out-of-memory error.  Sizing rule: bytes_per_block = "
            "block_tokens x (enc 2H + proj H) x dtype_bytes; a request of S "
            "source tokens holds ceil(S/block_tokens) blocks while in flight")
define_flag("serving_decode_block_steps", 4,
            "tokens decoded per dispatch in the serving plane: an inner "
            "loop emits K tokens per host copy of the tokens; admission and "
            "retirement quantize to K-token boundaries (finished rows "
            "re-emit EOS, so outputs stay bit-identical to the one-shot "
            "path).  1 = one host copy per token (lowest time to first token)")
define_flag("serving_max_new_tokens", 32,
            "default per-request decode cap of the serving plane (a "
            "request's own max_new_tokens overrides; the generator's "
            "max_length stays the ceiling)")
