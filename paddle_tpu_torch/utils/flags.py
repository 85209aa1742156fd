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
            "arm the NaN trap (utils/profiler.enable_nan_checks, the FP trap "
            "equivalent) in init()")
define_flag("compute_dtype", "", "bfloat16 enables mixed precision")
define_flag("profile_dir", "", "utils.profiler.profile() writes its torch profiler "
            "traces here when called without a directory")
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
define_flag("num_sanitizer", False,
            "arm the divergence-localizing numerics sanitizer "
            "(analysis/num_sanitizer.py; env PADDLE_TPU_TORCH_NUM_SANITIZER "
            "reaches subprocesses): SGD.train host-copies each step's inputs "
            "before the in-place update, and a step the sentinel flags is "
            "traced and re-executed node by node to name the first "
            "non-finite-producing op (layer and source provenance, input "
            "max-abs stats under StatSet num/<node>) in a flight-recorder "
            "postmortem.  Capture costs one host copy of the parameters, "
            "optimizer state and batch per step — debug drills only; unarmed "
            "the train path is untouched")
define_flag("saving_period", 1,
            "SGD.train with save_dir writes pass-%05d every N passes (the "
            "default of the JAX package's train(saving_period=...) and of "
            "its CLI's --saving_period)")
define_flag("checkpoint_period_batches", 50,
            "full-state checkpoint cadence (in batches) when SGD.train runs "
            "with checkpoint_dir; each checkpoint is the rollback anchor and "
            "the preemption and kill -9 resume point, and bounds the replay "
            "window the recovery plane retains on the device")
define_flag("cache_pass_in_mem", False,
            "device-resident pass cache (reader/pass_cache.py, the "
            "reference's CacheType.CACHE_PASS_IN_MEM): the first pass "
            "captures every staged batch in its wire form (uint8 stays "
            "uint8; the data layer's feed transform runs in the step) and "
            "every later pass replays it from device memory in a "
            "seed-reproducible order, with no host-to-device copy; a "
            "@provider(cache=CacheType.CACHE_PASS_IN_MEM) reader opts in "
            "through its tag")
define_flag("data_echo_factor", 1,
            "train each first-pass batch N times back to back (data echo), "
            "so the copy-bound first pass spends each transfer N times; 1 = "
            "off.  Applies whenever the pass cache is enabled")
define_flag("pass_cache_hbm_budget_mb", 4096,
            "device-memory budget of the pass cache, in MiB of staged "
            "(wire-form) batches; a pass that does not fit falls back to "
            "streaming with a warning.  Sizing: n_samples x bytes per sample "
            "in wire form (uint8 224x224x3 is 0.15 MB an image)")
define_flag("aot_cache_dir", "",
            "persistent build cache directory (core/aot_cache.py): every "
            "native library the port builds (the flash-attention kernels "
            "with nvcc, the recordio and protodata readers with g++) is "
            "stored after its first build, and a later process boot LOADS "
            "it instead of running the compiler (warm boot).  Entries are "
            "keyed by the sources' hash and the compiler flags, and checked "
            "against torch and CUDA runtime versions, machine, libc, package "
            "version and (nvcc) device name and capability: stale or "
            "foreign entries are detected and rebuilt, never loaded wrong.  "
            "Prewarm a config's rungs with `python -m paddle_tpu_torch cache "
            "warm`; empty = off (build into the package's _build/)")
define_flag("whole_pass_program", False,
            "whole-pass epoch program (trainer/step.py make_epoch_program): "
            "when the pass cache holds a sealed single-shape pass, passes "
            ">= 2 run every step with no host read inside and one fetch of "
            "the stacked per-step metrics at the end, bit-exact against the "
            "stepwise path (sentinel skips included).  Needs "
            "cache_pass_in_mem; falls back to stepwise replay, with a "
            "warning, for a multi-shape pass, sample_shuffle, a stacked "
            "copy over the budget, a mid-pass resume or a run with "
            "checkpoint_dir")
define_flag("sentinel_check_interval", 1,
            "health fetch cadence of fetch-free multi-step loops "
            "(make_multi_train_step folds the minimum health and the skip "
            "count per call); SGD.train reads every step's health with its "
            "cost, so it ignores this")
define_flag("sentinel_skip_limit", 3,
            "consecutive skipped (non-finite) steps that declare divergence "
            "and trigger a rollback (robustness/recovery.py)")
define_flag("sentinel_ema_decay", 0.98,
            "decay of the healthy-cost EMA the spike detector compares "
            "against")
define_flag("sentinel_spike_factor", 4.0,
            "a cost above spike_factor x EMA counts as a loss spike; "
            "sentinel_spike_patience consecutive spikes declare divergence "
            "even when every value is finite")
define_flag("sentinel_spike_patience", 3,
            "consecutive EMA spikes before the sentinel declares divergence")
define_flag("failure_max", 3,
            "rollback retries of the same data window before it is "
            "quarantined and training continues past it (the reference "
            "master's processFailedTask discipline, go/master/service.go:308)")
define_flag("chaos", "",
            "chaos fault-point spec, e.g. 'nan_batch@5,kill@12' "
            "(robustness/chaos.py; the environment variable "
            "PADDLE_TPU_TORCH_CHAOS reaches subprocesses); never set in "
            "production")
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
define_flag("serving_prefix_cache", False,
            "copy-on-write prefix sharing in the serving plane "
            "(serving/engine.py): finished prompts park their encoder "
            "pages in a refcount-0 LRU pool keyed on token-block hashes + "
            "the engine's topology fingerprint; a request whose FULL "
            "prompt matches maps the same blocks into its page table with "
            "ZERO prefill dispatches (bit-identical — the bi-GRU encoder "
            "reads the whole prompt, so only exact-prompt reuse is sound; "
            "chunked prefills additionally resume mid-prompt from cached "
            "forward-GRU carries).  Blocks free only at refcount 0; "
            "eviction is LRU under the same serving_hbm_budget_mb")
define_flag("serving_spec_decode", False,
            "speculative decoding in the serving plane: an n-gram draft "
            "proposes serving_decode_block_steps tokens and the target "
            "model verifies ALL of them in ONE dispatch (the existing "
            "K-steps compiled shape, drafts as inputs); the emitted "
            "tokens are exactly the greedy argmax chain's — acceptance "
            "only changes how many land per dispatch, never their values "
            "(rejection falls back bit-identically).  Accepted-token "
            "rate rides serving metrics as spec_accept_rate")
define_flag("serving_spec_ngram", 2,
            "context n-gram order of the serving draft proposer: the last "
            "n generated tokens are matched against the request's own "
            "generated history and the continuation after the most recent "
            "match is proposed (prompt-lookup decoding); larger n = "
            "fewer, more precise matches")
define_flag("serving_default_deadline_s", 0.0,
            "default end-to-end deadline (seconds from submit) stamped on "
            "serving requests that carry none of their own; the scheduler "
            "SHEDS a request whose predicted queue wait already blows its "
            "deadline (distinct 'shed' status — at overload the plane "
            "degrades to its SLO-feasible subset instead of collapsing "
            "into universal timeouts) and cancels a live request once its "
            "deadline passes (pages free immediately).  0 = no deadline "
            "(pre-SLO behavior)")
define_flag("serving_queue_limit", 0,
            "bound on requests queued ahead of admission (submitted + "
            "validated-waiting) in the serving scheduler: a submit beyond "
            "it is REJECTED immediately ('rejected: queue full' — open-"
            "loop backpressure, the client retries elsewhere) instead of "
            "growing an unbounded queue whose every occupant times out.  "
            "0 = unbounded (pre-SLO behavior)")
define_flag("serving_prefill_chunk_tokens", 0,
            "chunked prefill: a prompt whose padded source extent exceeds "
            "this many tokens prefills in ladder-rung chunks (carried "
            "bi-GRU state, one bounded dispatch per chunk) interleaved "
            "with decode steps, so a long prompt no longer stalls every "
            "decoding sequence for its whole encoder forward (head-of-"
            "line isolation; outputs stay bit-identical to the one-shot "
            "path).  Must be a multiple of serving_block_tokens and "
            "divide every larger shape-ladder rung.  0 = off (whole-"
            "prompt prefill)")
define_flag("scenario_slo_ms", 0.0,
            "end-to-end latency SLO for the scenario harness "
            "(robustness/scenarios.py): goodput counts requests completed "
            "within this many ms of submit, and per-request deadlines "
            "default to it.  0 = derive from the measured saturation "
            "wave (2.5x its p95 service time, floored at 50 ms)")
define_flag("serving_priority_aging_s", 2.0,
            "aging rate of the strict-priority-with-aging dequeue "
            "(serving/scheduler.py): every this-many seconds of queue "
            "wait promote a waiting request one priority level, so "
            "batch-class traffic ages into urgency instead of starving "
            "behind a steady interactive stream; 0 = pure strict "
            "priority (starvation becomes the operator's choice)")
define_flag("serving_class_deadline_s", "",
            "per-class default end-to-end deadlines, 'prio:seconds' "
            "pairs e.g. '0:0.25,2:1.5' (priority 0 is most urgent): a "
            "request of that class submitted without its own deadline "
            "gets the class default; unlisted classes fall back to "
            "serving_default_deadline_s")
define_flag("serving_class_shed_slack", "",
            "per-class multiplier on the shed predictor's service-"
            "safety headroom, 'prio:factor' pairs e.g. '2:2.0': >1 "
            "sheds that class EARLIER under pressure (more headroom "
            "demanded), <1 lets it gamble closer to its deadline; "
            "unlisted classes use 1.0")
define_flag("serving_int8_weights", False,
            "weight-only int8 serving decode: the fused decode-weight "
            "bundle's dense matrices live as int8 blocks + f32 scales "
            "and dequantize per dispatch per dispatch (~4x smaller resident "
            "weight bytes under serving_hbm_budget_mb -> more concurrent "
            "slots per GB); biases/vectors stay f32, training is "
            "untouched (the certify_precision_plan weight-only ACCEPT "
            "case)")
define_flag("serving_int8_drift_budget", 0.08,
            "max tolerated per-step drift of int8-weight decode vs the "
            "f32 reference, measured as max|logits_int8 - logits_f32| / "
            "max|logits_f32| on a probe batch — the explicit bit-drift "
            "budget the tests and chip_smoke.py gate on")
define_flag("router_lease_timeout_s", 2.0,
            "heartbeat-lease timeout of the serving-fleet router's "
            "engine registry (serving/router.py — the master cluster "
            "plane's worker-lease discipline lifted to the serving "
            "tier): an engine silent this long is pruned and its "
            "in-flight requests re-route to the survivors")
define_flag("router_queue_limit", 0,
            "bound on requests concurrently inside the router's "
            "admission/dispatch section (the serving_queue_limit "
            "semantics one tier up): past it a request is REJECTED at "
            "the frontend before paying a network hop; 0 = unbounded")
define_flag("router_stats_poll_s", 0.2,
            "period of the router's per-engine stats poll — one typed "
            "RPC per engine per period (scheduler.export_stats over the "
            "wire codec, not a Prometheus scrape); routing scores read "
            "the latest snapshot")
define_flag("router_affinity", True,
            "prefix/session affinity routing in the fleet router: hash "
            "the request's session id (or its prefix block-chain key) "
            "to a preferred engine by rendezvous hashing, so "
            "shared-prefix traffic concentrates where the COW prefix "
            "cache already holds the blocks.  The preferred engine is "
            "OVERRIDDEN when its predicted wait exceeds the best "
            "engine's by more than router_affinity_slack_s — affinity "
            "must never defeat load balance")
define_flag("router_affinity_slack_s", 0.25,
            "how much worse (seconds of predicted wait) the affinity-"
            "preferred engine may be before the router falls back to "
            "the least-predicted-wait choice")
define_flag("router_call_timeout_s", 120.0,
            "per-request deadline of the router->engine serve RPC "
            "(dial + full decode + reply); requests carrying their own "
            "SLO use min(remaining deadline + grace, this)")
define_flag("metrics_out", "",
            "obs metrics export: periodically snapshot the StatSet plane "
            "+ the registered SLO gauges (serving queue depth, pages in "
            "use, EWMA predicted wait, served/shed/rejected/timeout "
            "ledger) to this file in Prometheus text exposition format "
            "(atomic replace).  Empty = off")
define_flag("rpc_max_message_mb", 64,
            "hard bound (MB) on one master-RPC wire frame, enforced on send "
            "and on receive (master_wire.py): an over-budget outbound payload "
            "(a too-large gradient tree) fails at once with a "
            "WireOversizeError naming this flag, and an over-budget inbound "
            "length prefix is refused before allocation.  Set it alike on "
            "the master and every worker")
define_flag("trace_dir", "",
            "obs plane (obs/): every process dumps its span timeline to "
            "trace-<role>-<pid>.json under this directory at exit, and "
            "flight-recorder postmortems land here too; obs.merge.merge_dir "
            "zips the per-process files into one timeline.  The environment "
            "variable PADDLE_TPU_TORCH_TRACE_DIR reaches subprocess fleets; "
            "empty = no export (the flight recorder still records)")
define_flag("flight_recorder", True,
            "keep the obs span recorder armed at bounded memory (per-thread "
            "rings of trace_ring_events events): SIGUSR1, a firing chaos "
            "point and the divergence sentinel dump the last events to "
            "flight-<pid>.json (under trace_dir, else the system temporary "
            "directory); off = every emit is one attribute read")
define_flag("trace_ring_events", 4096,
            "bounded ring capacity (events) of each thread's obs span "
            "buffer; the flight recorder's memory ceiling is threads x this "
            "x ~100 bytes")
define_flag("metrics_port", 0,
            "serve the StatSet plane and the registered gauges in Prometheus "
            "text format on http://127.0.0.1:<port>/metrics "
            "(obs/metrics.py; 0 = no endpoint)")
define_flag("metrics_period_s", 5.0,
            "seconds between obs metrics snapshots")
define_flag("quantize_block_size", 256,
            "elements per block of the block-scaled int8 format (one f32 "
            "max-abs scale per block) that elastic gradient contributions "
            "ride the master wire in (ops/quantize.py quantize_tree)")
define_flag("elastic_quantized_grads", False,
            "elastic workers submit per-task gradient contributions as "
            "block-scaled int8 blocks with f32 scales on the master wire "
            "(~4x fewer result bytes per pass); reduce_results dequantizes "
            "before the sorted-order reduction, so every worker still "
            "reduces the same bytes.  The environment variable "
            "PADDLE_TPU_TORCH_ELASTIC_QUANTIZED_GRADS reaches worker "
            "subprocesses")
