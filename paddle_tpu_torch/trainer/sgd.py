"""The training loop — the ``paddle.v2.trainer.SGD`` surface, the
counterpart of ``paddle_tpu/trainer/sgd.py`` over the eager train step::

    trainer = paddle.trainer.SGD(cost, parameters, paddle.optimizer.Adam(1e-3))
    trainer.train(paddle.batch(reader, 8), num_passes=2, event_handler=...,
                  feeding={...}, save_dir="out")

It runs on the card unless the caller passes ``device="cpu"`` (and raises
without one).  The parameters are updated in place; the layer state (batch
norm's moving statistics) is carried from step to step and written back to
``parameters.state`` (with the optimizer state) before every ``EndPass``, so
``test``, a tar saved or an ``Inference`` built in an ``EndPass`` handler
see the trained values.  Each step draws its seed (dropout) from the
trainer's generator, seeded with ``seed + 1``.  ``evaluators=`` adds
evaluator results to ``EndIteration``, ``EndPass`` and ``test``.

Saving: ``save_dir`` writes ``pass-%05d/`` (``params.tar`` and one v1 file
per parameter) every ``saving_period`` passes and, with
``saving_period_by_batches``, every that many batches; ``save_pass`` /
``load_pass`` do it by hand.  ``save_checkpoint`` / ``restore_checkpoint``
write and read the full training state (parameters, layer state,
optimizer state, the generator and the step count) through a
``checkpoint.CheckpointManager``.

A ``HookAttr("pruning", r)`` on a layer's ParamAttr builds static pruning
masks from the initial parameters, applied to them at construction and
after every update, as the JAX package's ``SGD`` does.
``show_parameter_stats_period`` logs per-parameter statistics.

Feeding runs on a prefetch thread by default (``async_load_data``,
reader/prefetch.py; pinned memory and the feeder's own CUDA stream on the
card); the device-resident pass cache with data echo and the whole-pass
epoch program (reader/pass_cache.py, trainer/step.py) replay later passes
from the device; ``checkpoint_dir`` turns on the robustness plane
(robustness/: the sentinel's judge, rollback with quarantine, preemption,
``resume``, chaos points).  ``compile_cache`` counts the batch shapes.

``elastic_model`` adapts the trainer to an elastic worker
(trainer/elastic.py).  The ``num_sanitizer`` flag arms the numerics
sanitizer on the stepwise loop (analysis/num_sanitizer.py; the epoch
program's steps are not captured).

The ``aot_cache_dir`` flag puts the trainer on the persistent build store
(core/aot_cache.py): every train-step, eval-step and epoch-program rung
(step kind, batch shape) resolves once per trainer, and resolving a rung
loads through the store every native library a step at that rung launches
(the flash library, when an attention layer routes to flash at the batch's
T and dh on the card), so a warm boot runs no compiler.  ``warm_compile``
resolves a rung without running a step (``python -m paddle_tpu_torch cache
warm``).  Not ported yet: device meshes (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import itertools
import logging
import os
from collections import deque
from contextlib import nullcontext
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import event as v2_event
from paddle_tpu_torch import obs as _obs
from paddle_tpu_torch.core import aot_cache as _aot
from paddle_tpu_torch.core.batch import DEFAULT_LADDER, batch_shape_key
from paddle_tpu_torch.core.compiler import CompiledNetwork, CompileShapeCache
from paddle_tpu_torch.core.device import resolve_device, tree_to
from paddle_tpu_torch.core.topology import LayerOutput, Topology
from paddle_tpu_torch.ops import flash_attention as _fa
from paddle_tpu_torch.optimizer import Optimizer
from paddle_tpu_torch.parameters import create_from_network
from paddle_tpu_torch.reader.feeder import DataFeeder, feed_dtypes_of
from paddle_tpu_torch.reader.pass_cache import PassCache
from paddle_tpu_torch.reader.prefetch import prefetch
from paddle_tpu_torch.robustness import chaos as _chaos
from paddle_tpu_torch.robustness.preemption import PreemptionGuard, clear_marker, write_marker
from paddle_tpu_torch.robustness.recovery import RecoveryCoordinator
from paddle_tpu_torch.robustness.sentinel import DivergenceSentinel
from paddle_tpu_torch.trainer.evaluators import default_metrics_fn
from paddle_tpu_torch.trainer.step import (
    apply_prune_masks,
    build_prune_masks,
    draw_seed,
    fetch_metrics,
    make_epoch_program,
    make_eval_step,
    make_train_carry,
    make_train_step,
    split_train_carry,
)
from paddle_tpu_torch.utils import flags as _flags
from paddle_tpu_torch.utils.timers import global_stats, stat_timer

_log = logging.getLogger("paddle_tpu_torch.trainer")


def _batch_rows(batch) -> int:
    """Sample count of a fed batch (any slot's leading dim): costs and
    metrics average over batches weighted by it."""
    for t in batch.values():
        return int(t.data.shape[0])
    return 1


def clone_tree(tree):
    """A copy of a tree whose tensors are cloned (other leaves shared)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone() if torch.is_tensor(tree) else tree


class SGD:
    """paddle.v2.trainer.SGD(cost, parameters, update_equation, ...).

    ``parameters`` may come from ``parameters.create``, be a network-less
    tree from ``parameters.from_numpy``, which the trainer adopts, or a
    topology-free ``DetachedParameters`` from ``Parameters.from_tar(f)``,
    merged by name into parameters built for this topology; None creates
    them from `seed`.  ``is_local`` is accepted for the reference's surface
    and ignored, as the JAX package ignores it: training is always local."""

    def __init__(
        self,
        cost,
        parameters=None,
        update_equation: Optional[Optimizer] = None,
        extra_layers: Optional[Sequence[LayerOutput]] = None,
        is_local: bool = True,
        seed: int = 0,
        evaluators: Optional[Sequence] = None,
        device=None,
    ):
        if update_equation is None:
            raise ValueError("update_equation (an Optimizer) is required")
        self.device = resolve_device(device)
        self.evaluators = list(evaluators or [])
        self._seed = seed
        if isinstance(cost, Topology):
            outputs: List[LayerOutput] = list(cost.outputs)
        elif isinstance(cost, LayerOutput):
            outputs = [cost]
        else:
            outputs = list(cost)
        outputs += list(extra_layers or ())
        for ev in self.evaluators:
            outputs += list(ev.layers)
        self.topology = Topology(outputs)
        self.network = CompiledNetwork(self.topology)
        if parameters is not None and not hasattr(parameters, "network"):
            detached = parameters
            parameters = create_from_network(self.network, seed, self.device)
            detached.merge_into(parameters)
        if parameters is None:
            parameters = create_from_network(self.network, seed, self.device)
        stale = [n for n in parameters.params if n not in self.topology.layers]
        if stale:
            raise ValueError(
                f"parameters were created for a different topology: param "
                f"layers {stale} do not exist in this trainer's network"
            )
        if parameters.network is None:
            parameters.network = self.network
        parameters.params = tree_to(parameters.params, self.device)
        parameters.state = tree_to(parameters.state, self.device)
        self.parameters = parameters
        self.optimizer = update_equation
        self._metrics_fn = self._build_metrics_fn()
        # static pruning hooks: masks from the initial magnitudes, applied to
        # the initial values and after every update (StaticPruningHook)
        self._prune_masks = build_prune_masks(self.network, self.parameters.params)
        apply_prune_masks(self.parameters.params, self._prune_masks)
        self._train_step = make_train_step(
            self.network, self.optimizer, extra_metrics=self._metrics_fn,
            prune_masks=self._prune_masks,
        )
        self._eval_step = make_eval_step(self.network, extra_metrics=self._metrics_fn)
        self._opt_state = self.optimizer.init(self.parameters.params)
        self._rng = torch.Generator().manual_seed(seed + 1)
        self._step_count = 0
        self.preempted = False
        self._pass_cache = None  # set per train() call when caching is on
        self._pass_cache_reader = None  # the reader the cache was captured from
        # the build store (core/aot_cache.py) under the aot_cache_dir flag:
        # each rung resolves once, loading the native libraries its step
        # launches from the store; None = libraries load at first launch
        self._aot_cache = _aot.process_store()
        # (kind, shape key) -> rung record; epoch programs by pass shape
        self._exec_table: Dict[tuple, Any] = {}
        # every train and eval batch's shape is counted (hits and misses in
        # utils.timers.global_stats): a laddered feed stays bounded
        self.compile_cache = CompileShapeCache("train_step")
        self._eval_cache = CompileShapeCache("eval_step")
        # dynamic-width (batch-wide trans) weights resolve once, at the
        # first batch this trainer sees; a later batch-size change fails in
        # the step, never silently re-draws trained weights
        self._width_resolved = not self.network.has_dynamic_widths

    def _resolve_widths(self, params, batch):
        """Pin the dynamic widths to `batch`'s size (once per trainer).
        When a weight was re-drawn: the new tree is published, the optimizer
        state is rebuilt, and so are the pruning masks and the train step
        that closes over them (the masks are shaped by the weights).
        Returns (params, changed)."""
        self._width_resolved = True
        params, changed = self.network.resolve_dynamic_widths(params, batch)
        if changed:
            self.parameters.params = params
            self._opt_state = self.optimizer.init(params)
            self._prune_masks = build_prune_masks(self.network, params)
            apply_prune_masks(params, self._prune_masks)
            self._train_step = make_train_step(
                self.network, self.optimizer, extra_metrics=self._metrics_fn,
                prune_masks=self._prune_masks,
            )
        return params, changed

    # ------------------------------------------------------------------
    def _build_metrics_fn(self):
        default = default_metrics_fn(self.topology)
        if not self.evaluators:
            return default
        from paddle_tpu_torch.evaluator import combined_update

        ev_update = combined_update(self.evaluators)

        def metrics(outs):
            m = default(outs) if default else {}
            m.update(ev_update(outs))
            return m

        return metrics

    @staticmethod
    def _split_metrics(metrics):
        """(scalar metrics, evaluator accumulators as host arrays) of a step's
        metrics."""
        scalars, accums = {}, {}
        for k, v in metrics.items():
            if k.startswith("ev:"):
                accums[k] = v.detach().cpu().numpy()
            elif k != "cost":
                scalars[k] = float(v)
        return scalars, accums

    def _finalize(self, accums):
        from paddle_tpu_torch.evaluator import finalize_all

        return finalize_all(self.evaluators, accums) if self.evaluators else {}

    def _make_feeder(self, feeding) -> DataFeeder:
        """Under the ``use_bucketing`` flag, sequence slots pad to the shape
        ladder: the rung ``reader.bucketing.token_budget_batch`` packed each
        batch for.  Bucketing refuses a network with dynamic widths: its
        batch sizes vary per rung, those weights train at one batch size."""
        bucketing = _flags.get_flag("use_bucketing")
        if bucketing and self.network.has_dynamic_widths:
            raise ValueError(
                "use_bucketing is incompatible with dynamic (batch-wide "
                "trans) width layers: bucketed batch sizes vary per "
                "length rung, but these weights train at exactly one "
                "batch size.  Feed this network with paddle.batch "
                "(fixed size, drop_last=True) instead."
            )
        return DataFeeder(
            self.topology.data_types(), feeding,
            feed_dtypes=feed_dtypes_of(self.topology), device=self.device,
            ladder=DEFAULT_LADDER if bucketing else None,
        )

    def _stage_fn(self, feeder: DataFeeder, staged: bool):
        """The feed of one batch: convert on the host, the ``nan_batch``
        chaos point, then the upload (pinned on a side stream when `staged`,
        the prefetch worker's form)."""

        def stage(data):
            # obs: the stage leg (on the prefetch thread when feeding is
            # asynchronous, so a timeline shows feed overlapping compute)
            with stat_timer("feed"), _obs.span("feed", cat="trainer"):
                host = feeder.convert(data)
                if _chaos.fire("nan_batch"):
                    host = _chaos.poison_batch(host)
                return feeder.upload(host, staged=staged)

        return stage

    # -- build-store dispatch (core/aot_cache.py) -------------------------
    def _aot_identity(self, kind: str, batch, n_steps=None) -> Dict[str, Any]:
        """Identity of one step variant, as the JAX package keys its
        executables: the step kind (and scan length), the graph (topology
        fingerprint with the compute dtype), the rung (batch shape key) and
        the mesh.  The port's steps update their inputs in place where the
        JAX package donates them."""
        return {
            "kind": kind,
            "n_steps": n_steps,
            "topology": _aot.topology_fingerprint(self.network),
            "batch": repr(batch_shape_key(batch)),
            "mesh": _aot.mesh_fingerprint(None),
            "donation": "in_place",
            "model_sharded": False,
        }

    def _aot_meta(self) -> Dict[str, Any]:
        """The constants that change a step without changing which step it
        is: the optimizer's fingerprint, the sentinel, the pruning masks."""
        return {
            "optimizer": _aot.optimizer_fingerprint(self.optimizer),
            "sentinel": bool(_flags.get_flag("divergence_sentinel")),
            "pruned": bool(self._prune_masks),
        }

    def _seq_len(self, name: str, batch) -> Optional[int]:
        """T of the data slot a layer's first-input chain starts from, or
        None (not a sequence slot of `batch`)."""
        conf = self.topology.layers.get(name)
        while conf is not None and conf.type != "data":
            conf = self.topology.layers.get(conf.inputs[0]) if conf.inputs else None
        if conf is None:
            return None
        t = batch.get(conf.name)
        return int(t.data.shape[1]) if t is not None and t.is_seq else None

    def _rung_libraries(self, batch) -> tuple:
        """The native libraries a step at `batch`'s shapes launches: the
        flash library when an attention layer routes to flash (the
        ``use_flash_attention`` flag, the card, equal query and key lengths
        and ``supported(T, dh)``, T read from the slot its input chain
        starts at), else none.  A library this misses still loads through
        the store at its first launch."""
        if self.device.type != "cuda" or not _flags.get_flag("use_flash_attention"):
            return ()
        for conf in self.topology.layers.values():
            if conf.type != "multi_head_attention":
                continue
            tq = self._seq_len(conf.inputs[0], batch)
            tk = self._seq_len(conf.inputs[-1], batch)
            if tq is not None and tq == tk and _fa.supported(tq, conf.size // conf.attrs["n_heads"]):
                return ("flash_attention",)
        return ()

    def _rung_record(self, kind: str, batch, n_steps=None) -> Dict[str, Any]:
        """Resolve one rung: load through the store every native library
        its step launches, and return what was resolved."""
        libs = self._rung_libraries(batch)
        if libs:
            _fa.load_library(self._aot_cache)
        return {"identity": self._aot_identity(kind, batch, n_steps), "meta": self._aot_meta(),
                "libraries": {"flash_attention": _fa.loaded_library()} if libs else {}}

    def _resolve_rung(self, kind: str, batch) -> bool:
        """Resolve `batch`'s rung of `kind` once per trainer; True when it
        was new."""
        key = (kind, batch_shape_key(batch))
        if key in self._exec_table:
            return False
        self._exec_table[key] = self._rung_record(kind, batch)
        return True

    def _run_train_step(self, params, state, opt_state, batch, seed):
        """One train step; with the build store its rung resolves first
        (once per shape)."""
        if self._aot_cache is not None:
            self._resolve_rung("train_step", batch)
        return self._train_step(params, state, opt_state, batch, seed)

    def warm_compile(self, batch) -> bool:
        """Resolve `batch`'s train-step rung through the build store
        without running a step (parameters, optimizer slots and the step
        count stay as they are): the ``cache warm`` prewarm path.  True when
        the rung was new."""
        if self._aot_cache is None:
            raise ValueError("warm_compile needs the aot_cache_dir flag")
        return self._resolve_rung("train_step", batch)

    def _dispatch_epoch_program(self, pass_cache, pass_id, params, state, opt_state):
        """One cached pass through the epoch program (trainer/step.py
        make_epoch_program), then one fetch of its folds and per-step
        metrics.  Returns (host metrics stacked [n_batches, ...], (params,
        state, opt_state)).  When a step of the pass was unhealthy the
        metrics are None and the state and the generator are those of the
        pass's start: the caller replays the pass stepwise, so that skips
        (and the optimizer's host step counter) match the stepwise path
        exactly."""
        n = pass_cache.n_batches
        key = ("epoch_program", n, batch_shape_key(pass_cache.sample_batch()))
        prog = self._exec_table.get(key)
        if prog is None:
            if self._aot_cache is not None:
                self._rung_record("epoch_program", pass_cache.sample_batch(), n_steps=n)
            prog = make_epoch_program(self.network, self.optimizer, None, self._metrics_fn,
                                      prune_masks=self._prune_masks)
            self._exec_table[key] = prog
            _log.info("whole-pass epoch program ready: %d steps, one fetch per pass (%s)", n,
                      "build store" if self._aot_cache is not None else "no build store")
        guarded = _flags.get_flag("divergence_sentinel")
        if guarded:
            kept = (clone_tree(params), clone_tree(state), clone_tree(opt_state),
                    self._rng.get_state())
        carry = make_train_carry(params, state, opt_state, self._rng)
        with stat_timer("epoch_program"), _obs.span("epoch_program", cat="trainer", p=pass_id,
                                                     n_steps=n):
            carry, ms = prog(carry, pass_cache.stacked(), pass_cache.epoch_perm(pass_id))
        global_stats.incr("epoch_program/dispatches")
        global_stats.incr("epoch_program/steps", n)
        host = fetch_metrics(ms)  # the pass's one fetch
        if guarded and bool((host["health"] < 0.5).any()):
            params, state, opt_state, rng_state = kept
            self._rng.set_state(rng_state)
            _log.info("epoch program: %d unhealthy step(s) in pass %d; replaying the pass "
                      "stepwise from its start", int((host["health"] < 0.5).sum()), pass_id)
            global_stats.incr("epoch_program/replayed")
            return None, (params, state, opt_state)
        params, state, opt_state, self._rng = split_train_carry(carry)
        return host, (params, state, opt_state)

    def train(
        self,
        reader: Callable,
        num_passes: int = 1,
        event_handler: Optional[Callable] = None,
        feeding=None,
        save_dir: Optional[str] = None,
        saving_period: Optional[int] = None,
        saving_period_by_batches: Optional[int] = None,
        start_pass: int = 0,
        show_parameter_stats_period: Optional[int] = None,
        async_load_data: bool = True,
        checkpoint_dir: Optional[str] = None,
        checkpoint_period_batches: Optional[int] = None,
        resume: bool = False,
    ) -> None:
        """One train step per minibatch of `reader`, for `num_passes`
        passes numbered from `start_pass`, with the BeginPass /
        BeginIteration / EndIteration(cost, metrics) / EndPass(mean_cost,
        evaluators) events.  A step the divergence sentinel skipped still
        reports its (non-finite) cost in EndIteration, and counts in no pass
        mean.  With `save_dir`, pass-%05d is written every `saving_period`
        passes (None: the flag) and every `saving_period_by_batches`
        batches.  Every `show_parameter_stats_period` steps (None: the
        flag; 0: off) the per-parameter statistics are logged.

        ``async_load_data`` (on by default, as in the JAX package): the feed
        (converters, the pinned copy, the copies on the feeder's stream)
        runs on a prefetch thread, two batches ahead; off, it runs inline
        with a synchronous copy.  A failure on the thread is raised here.

        The pass cache (the ``cache_pass_in_mem`` flag, or a reader tagged
        by ``@provider(cache=CacheType.CACHE_PASS_IN_MEM)``): pass 1's staged
        batches stay on the device (reader/pass_cache.py, with
        ``data_echo_factor`` echo on pass 1) and later passes replay them;
        the same reader in a later call replays at once.  With
        ``whole_pass_program``, a replayed pass runs as the epoch program
        (one fetch per pass), or stepwise with a warning that says why.

        Fault tolerance (robustness/): with ``checkpoint_dir``, full-state
        checkpoints (parameters, layer and optimizer state, the generator,
        the pass and batch position) are written before the first batch,
        every ``checkpoint_period_batches`` batches (None: the flag) and at
        every pass end.  When the sentinel declares divergence (a skip
        streak or loss spikes), the run rolls back to the last good
        checkpoint and retries the window of batches since, quarantining it
        after ``failure_max`` failures.  SIGTERM/SIGINT write a synchronous
        checkpoint and a ``PREEMPTED`` marker and return (``self.preempted``
        is True); ``resume=True`` restores the latest good checkpoint and
        drains the interrupted pass's consumed batches, so a deterministic
        reader continues the uninterrupted trajectory bit for bit.  A
        resumed run does not cache: it streams its remaining passes."""
        if event_handler is None:
            event_handler = lambda e: None  # noqa: E731
        if saving_period is None:
            saving_period = _flags.get_flag("saving_period")
        log_period = _flags.get_flag("log_period")
        if show_parameter_stats_period is None:  # an explicit 0 disables too
            show_parameter_stats_period = _flags.get_flag("show_parameter_stats_period")
        whole_pass = _flags.get_flag("whole_pass_program")
        whole_pass_warned = False
        feeder = self._make_feeder(feeding)
        stage = self._stage_fn(feeder, async_load_data)

        # -- the robustness plane: sentinel, rollback, preemption ----------
        self.preempted = False
        sentinel = None
        if _flags.get_flag("divergence_sentinel"):
            sentinel = DivergenceSentinel.from_flags()
        # numerics sanitizer (analysis/num_sanitizer.py): armed by the
        # num_sanitizer flag it host-copies each step's inputs before the
        # in-place update and, when the sentinel flags a step, re-executes
        # it node by node to name the first non-finite-producing op in a
        # flight-recorder postmortem.  Unarmed: num_san stays None and the
        # loop is untouched (no captures, no copies).
        num_san = None
        if _flags.get_flag("num_sanitizer"):
            from paddle_tpu_torch.analysis.num_sanitizer import NumericsSanitizer

            num_san = NumericsSanitizer.for_trainer(self)
        recovery = manager = None
        if checkpoint_dir:
            from paddle_tpu_torch import checkpoint as _ckpt

            manager = _ckpt.CheckpointManager(checkpoint_dir)
            recovery = RecoveryCoordinator.from_flags(
                save_fn=lambda step, extra: self.save_checkpoint(manager, step=step, extra=extra),
                restore_fn=lambda: self._restore_latest_full(manager),
            )
            if checkpoint_period_batches is None:
                checkpoint_period_batches = _flags.get_flag("checkpoint_period_batches")
            if not resume and manager.latest_step() is not None:
                _log.warning(
                    "checkpoint_dir %s already holds checkpoints from a previous run but "
                    "resume=False: a rollback could restore stale state; use a fresh "
                    "directory or resume", checkpoint_dir)
        elif resume:
            raise ValueError("resume=True requires checkpoint_dir")

        resume_extra = None
        skip_batches = 0
        first_pass = start_pass
        if resume:
            resume_extra = recovery.resume()
            if resume_extra is None:
                _log.warning("resume: no usable checkpoint under %s; starting fresh",
                             checkpoint_dir)
            else:
                clear_marker(checkpoint_dir)
                first_pass = int(resume_extra.get("pass_id", start_pass))
                skip_batches = int(resume_extra.get("batch_id", -1)) + 1
                _log.info("resumed at step %d: pass %d, skipping %d consumed batch(es)",
                          self._step_count, first_pass, skip_batches)

        # -- the pass cache ------------------------------------------------
        # a single-pass run never replays, so it holds nothing (echo still
        # applies: it needs the batch in hand only)
        pass_cache = None
        cache_requested = _flags.get_flag("cache_pass_in_mem") or bool(
            getattr(reader, "cache_pass_in_mem", False))
        if cache_requested and resume_extra is not None and not (
                self._pass_cache is not None and self._pass_cache.ready):
            # a resumed process cannot rebuild the interrupted run's capture
            # (a mid-pass resume would capture the pass's tail only)
            _log.warning("pass cache disabled on resume: the interrupted run's capture cannot "
                         "be rebuilt; streaming the remaining passes")
            cache_requested = False
        echo_factor = max(int(_flags.get_flag("data_echo_factor")), 1) if cache_requested else 1
        if cache_requested:
            # the cache lives with its reader: a later call with the same
            # reader object replays at once, another reader frees it first
            prev = self._pass_cache
            if prev is not None and prev.ready and self._pass_cache_reader is reader:
                pass_cache = prev
            else:
                if prev is not None:
                    prev.drop()
                if num_passes > 1:
                    pass_cache = PassCache.from_flags(reader, seed=self._seed,
                                                      echo_factor=echo_factor)
        elif self._pass_cache is not None:
            self._pass_cache.drop()  # caching switched off: free the memory
        self._pass_cache = pass_cache
        self._pass_cache_reader = reader if pass_cache is not None else None
        if whole_pass and pass_cache is None:
            _log.warning(
                "whole_pass_program requested but no device-resident pass cache is "
                "available (needs cache_pass_in_mem or a CACHE_PASS_IN_MEM provider, "
                "num_passes > 1, and a run that is not resumed); training stepwise")

        def judge_step(pass_id, bid, cost, health, grad_norm, metrics, rows):
            """The sentinel's verdict on one step and its bookkeeping,
            shared by the stepwise loop and the epoch program's replay of
            its fetched metrics, so the two cannot drift apart.  Emits
            EndIteration."""
            verdict = "ok"
            if sentinel is not None and health is not None:
                healthy = float(health) >= 0.5
                if healthy and grad_norm is not None:
                    global_stats.observe("robustness.grad_norm", float(grad_norm))
                verdict = sentinel.observe(cost, healthy)
            if log_period and self._step_count % log_period == 0:
                _log.info("pass %d batch %d cost %.6f", pass_id, bid, cost)
            evaluator: Dict[str, float] = {}
            if verdict == "ok":
                pass_costs.append(cost)
                pass_weights.append(rows)
                evaluator, accums = self._split_metrics(metrics)
                for k, v in accums.items():
                    pass_accums[k] = pass_accums.get(k, 0) + v
                evaluator.update(self._finalize(accums))
            event_handler(v2_event.EndIteration(pass_id, bid, cost, evaluator))
            return verdict

        def publish():
            self.parameters.params, self.parameters.state = params, state
            self._opt_state = opt_state

        params, state, opt_state = self.parameters.params, self.parameters.state, self._opt_state
        guard = None
        if recovery is not None:
            guard = PreemptionGuard()
            if resume_extra is None:
                # a rollback needs an anchor before the first batch lands
                recovery.checkpoint(self._step_count, {
                    "step_count": self._step_count, "pass_id": first_pass, "batch_id": -1})
        with (guard if guard is not None else nullcontext()):
            for pass_id in range(first_pass, start_pass + num_passes):
                skip = skip_batches if pass_id == first_pass else 0
                event_handler(v2_event.BeginPass(pass_id))
                if "pass" in opt_state:
                    opt_state["pass"] = pass_id  # the pass_manual schedule reads it
                pass_costs: List[float] = []
                pass_weights: List[int] = []
                pass_accums: Dict[str, np.ndarray] = {}
                # rollback marks: the pass report must not count a retried
                # window twice
                costs_mark = 0
                accums_mark: Dict[str, np.ndarray] = {}
                cached = pass_cache is not None and pass_cache.ready
                use_epoch_prog = (
                    whole_pass and cached and recovery is None and not skip
                    and pass_cache.n_buckets == 1 and not pass_cache.sample_shuffle
                    and pass_cache.fits_stacked())
                if whole_pass and cached and not use_epoch_prog and not whole_pass_warned:
                    whole_pass_warned = True
                    reasons = []
                    if recovery is not None:
                        reasons.append("checkpoint/rollback plane active")
                    if skip:
                        reasons.append("mid-pass resume")
                    if pass_cache.n_buckets != 1:
                        reasons.append(f"{pass_cache.n_buckets} shape buckets")
                    if pass_cache.sample_shuffle:
                        reasons.append("sample_shuffle")
                    if not pass_cache.fits_stacked():
                        reasons.append("stacked copy would exceed pass_cache_hbm_budget_mb "
                                       "(needs 2x the cached pass)")
                    _log.warning("whole_pass_program requested but replaying stepwise (%s)",
                                 "; ".join(reasons) or "unknown")
                step_ms = None
                if use_epoch_prog:
                    step_ms, (params, state, opt_state) = self._dispatch_epoch_program(
                        pass_cache, pass_id, params, state, opt_state)
                if step_ms is not None:
                    # the fetched per-step metrics drive the same bookkeeping
                    # as the stepwise loop
                    rows = _batch_rows(pass_cache.sample_batch())
                    healths = step_ms.pop("health", None)
                    grad_norms = step_ms.pop("grad_norm", None)
                    for i in range(pass_cache.n_batches):
                        event_handler(v2_event.BeginIteration(pass_id, i))
                        self._step_count += 1
                        verdict = judge_step(
                            pass_id, i, float(step_ms["cost"][i]),
                            None if healths is None else healths[i],
                            None if grad_norms is None else grad_norms[i],
                            {k: v[i] for k, v in step_ms.items()}, rows)
                        if verdict == "diverged":
                            _log.error(
                                "divergence detected at pass %d batch %d inside the whole-"
                                "pass epoch program: no per-step rollback in this mode (run "
                                "with checkpoint_dir for the stepwise path)", pass_id, i)
                            if sentinel is not None:
                                sentinel.reset()
                    batches = iter(())
                elif cached:
                    # replay from the device: no feeder, no host-to-device copy
                    batches = pass_cache.epoch(pass_id)
                    if skip:
                        batches = itertools.islice(batches, skip, None)
                else:
                    raw = iter(reader())
                    # resume mid-pass: drain the consumed batches unstaged (the
                    # reader's own generator advances as the interrupted run's)
                    for _ in range(skip):
                        next(raw, None)
                    batches = prefetch(raw, stage) if async_load_data else map(stage, raw)
                    if pass_cache is not None and pass_cache.active:
                        batches = pass_cache.capture(batches)
                    elif echo_factor > 1 and pass_id == first_pass:
                        # a single-pass (or overflowed) run with echo: train each
                        # transferred batch echo_factor times, keep none
                        batches = (b for bb in batches for b in (bb,) * echo_factor)
                live = iter(batches)
                replay: deque = deque()
                batch_id = skip - 1
                while True:
                    if replay:
                        _, bid, batch = replay.popleft()
                        is_live = False
                    else:
                        try:
                            batch = next(live)
                        except StopIteration:
                            break
                        batch_id += 1
                        bid = batch_id
                        is_live = True
                    event_handler(v2_event.BeginIteration(pass_id, bid))
                    if self.compile_cache.observe(batch) and self._step_count:
                        _log.debug("train batch %d brings a new shape (distinct shapes now "
                                   "%d)", bid, self.compile_cache.n_shapes)
                    if is_live and recovery is not None:
                        recovery.record(pass_id, bid, batch)
                    batch = DataFeeder.consume(batch)
                    if not self._width_resolved:
                        params, changed = self._resolve_widths(params, batch)
                        if changed:
                            opt_state = self._opt_state
                            if "pass" in opt_state:
                                opt_state["pass"] = pass_id
                    # obs: the dispatch of the step, then the block on its
                    # metrics' host copy
                    with stat_timer("train_step"):
                        with _obs.span("train_step", cat="trainer", p=pass_id, b=bid):
                            seed = draw_seed(self._rng)
                            if num_san is not None:
                                # the step updates in place: copy its inputs
                                # out first, or nothing is left to re-execute
                                num_san.capture(params, state, opt_state, batch, seed,
                                                where=f"pass {pass_id} batch {bid}")
                            params, state, opt_state, metrics = self._run_train_step(
                                params, state, opt_state, batch, seed)
                        with _obs.span("block_fetch", cat="trainer", b=bid):
                            metrics = fetch_metrics(metrics)
                    self._step_count += 1
                    health = metrics.pop("health", None)
                    grad_norm = metrics.pop("grad_norm", None)
                    cost = float(metrics["cost"])
                    if _chaos.fire("kill"):  # a hard-preemption drill: no flush
                        _chaos.kill_self()
                    if (show_parameter_stats_period
                            and self._step_count % show_parameter_stats_period == 0):
                        # reference TrainerInternal.cpp:83-110 per-parameter stats
                        from paddle_tpu_torch.utils.debug import (
                            format_parameter_stats,
                            parameter_stats,
                        )

                        _log.info("parameter stats @ step %d:\n%s", self._step_count,
                                  format_parameter_stats(parameter_stats(params)))
                    verdict = judge_step(pass_id, bid, cost, health, grad_norm, metrics,
                                         _batch_rows(batch))
                    if num_san is not None and (verdict in ("skip", "diverged")
                                                or not np.isfinite(cost)):
                        # name the op that went non-finite, not just the step
                        num_san.postmortem(f"{verdict} at pass {pass_id} batch {bid}")
                    if not is_live and not replay and recovery is not None:
                        recovery.replay_done()  # the window applied cleanly again
                    if verdict == "diverged":
                        if recovery is None:
                            _log.error("divergence detected at pass %d batch %d but no "
                                       "checkpoint_dir is set: cannot roll back", pass_id, bid)
                            if sentinel is not None:
                                sentinel.reset()
                        else:
                            action, window = recovery.on_divergence()
                            if action != "none":
                                # the restore set self.*: take the loop's
                                # references again and drop the undone
                                # bookkeeping
                                params, state = self.parameters.params, self.parameters.state
                                opt_state = self._opt_state
                                del pass_costs[costs_mark:]
                                del pass_weights[costs_mark:]
                                pass_accums = {k: np.copy(v) for k, v in accums_mark.items()}
                                if sentinel is not None:
                                    sentinel.reset()
                                if action == "retry":
                                    replay = deque(window)
                        continue
                    if (recovery is not None and verdict == "ok" and checkpoint_period_batches
                            and not recovery.replaying
                            and (sentinel is None or sentinel.steady)
                            and self._step_count % checkpoint_period_batches == 0):
                        publish()
                        recovery.checkpoint(self._step_count, {
                            "step_count": self._step_count, "pass_id": pass_id,
                            "batch_id": bid})
                        costs_mark = len(pass_costs)
                        accums_mark = {k: np.copy(v) for k, v in pass_accums.items()}
                    if (save_dir and saving_period_by_batches
                            and (bid + 1) % saving_period_by_batches == 0):
                        publish()
                        self.save_pass(save_dir, pass_id, batch_id=bid + 1)
                    if guard is not None and guard.triggered:
                        # preemption: finish this step's bookkeeping, then a
                        # synchronous final checkpoint and the marker
                        publish()
                        extra = {"step_count": self._step_count, "pass_id": pass_id,
                                 "batch_id": bid, "preempted": True}
                        self.save_checkpoint(manager, step=self._step_count, extra=extra)
                        write_marker(checkpoint_dir, {**extra, "signal": guard.signum})
                        self.preempted = True
                        _log.warning("preempted at pass %d batch %d (step %d): state "
                                     "checkpointed under %s; restart with resume=True",
                                     pass_id, bid, self._step_count, checkpoint_dir)
                        return
                # the latest values, so that test, tar saving and checkpoints
                # in an EndPass handler see them
                publish()
                # per-sample mean: each batch weighs by its row count
                pass_metrics = {
                    "mean_cost": float(np.average(pass_costs, weights=pass_weights))
                    if pass_costs else 0.0
                }
                cc = self.compile_cache
                if cc.n_shapes > 1:
                    _log.info("pass %d bucket dispatch: %d distinct batch shapes, %d misses / "
                              "%d hits", pass_id, cc.n_shapes, cc.misses, cc.hits)
                pass_metrics.update(self._finalize(pass_accums))
                event_handler(v2_event.EndPass(pass_id, pass_metrics))
                if save_dir and (pass_id + 1 - start_pass) % saving_period == 0:
                    self.save_pass(save_dir, pass_id)
                if recovery is not None:
                    # a pass end is a natural anchor; its position is the next
                    # pass's start, so a resume never reads this one again
                    recovery.checkpoint(self._step_count, {
                        "step_count": self._step_count, "pass_id": pass_id + 1,
                        "batch_id": -1})
        publish()

    def test(self, reader: Callable, feeding=None,
             async_load_data: bool = True) -> v2_event.TestResult:
        """Cost and metrics over `reader`, averaged per sample, with the
        layer state as global statistics; evaluators finalize over the
        whole reader.  ``async_load_data`` feeds on a prefetch thread, as in
        ``train``."""
        feeder = self._make_feeder(feeding)
        stage = self._stage_fn(feeder, async_load_data)
        costs: List[float] = []
        weights: List[int] = []
        sums: Dict[str, float] = {}
        accum_sums: Dict[str, np.ndarray] = {}
        batches = prefetch(reader(), stage) if async_load_data else map(stage, reader())
        for batch in batches:
            self._eval_cache.observe(batch)
            batch = DataFeeder.consume(batch)
            if not self._width_resolved:
                # a trainer that never trained: the eval batch pins the widths
                self._resolve_widths(self.parameters.params, batch)
            if self._aot_cache is not None:
                self._resolve_rung("eval_step", batch)
            metrics = fetch_metrics(
                self._eval_step(self.parameters.params, self.parameters.state, batch))
            rows = _batch_rows(batch)
            costs.append(float(metrics["cost"]))
            weights.append(rows)
            scalars, accums = self._split_metrics(metrics)
            for k, v in scalars.items():
                sums[k] = sums.get(k, 0.0) + v * rows
            for k, v in accums.items():
                accum_sums[k] = accum_sums.get(k, 0) + v
        n = max(sum(weights), 1)
        avg = {k: v / n for k, v in sums.items()}
        avg.update(self._finalize(accum_sums))
        return v2_event.TestResult(
            avg, float(np.average(costs, weights=weights)) if costs else 0.0,
        )


    # -- parameter saving -------------------------------------------------
    def save_parameter_to_tar(self, f) -> None:
        self.parameters.to_tar(f)

    def save_pass(self, save_dir: str, pass_id: int, batch_id: Optional[int] = None) -> str:
        """Write pass-%05d/ (with a -batch-%d suffix for a batch save) holding
        params.tar and one v1 binary file per parameter, as the reference
        trainer's pass dirs."""
        from paddle_tpu_torch import checkpoint as ckpt

        name = f"pass-{pass_id:05d}"
        if batch_id is not None:
            name += f"-batch-{batch_id}"
        d = os.path.join(save_dir, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "params.tar"), "wb") as f:
            self.parameters.to_tar(f)
        ckpt.save_parameter_dir(self.parameters, d)
        return d

    def load_pass(self, save_dir: str, pass_id: int) -> None:
        """Load parameter values from a pass dir (reference --init_model_path
        with --start_pass)."""
        from paddle_tpu_torch import checkpoint as ckpt

        ckpt.load_parameter_dir(self.parameters, os.path.join(save_dir, f"pass-{pass_id:05d}"))

    # -- full-state checkpoints -------------------------------------------
    def _rng_key(self) -> np.ndarray:
        """The leaf the JAX package keeps its PRNG key in ([2] uint32),
        derived from this trainer's seed and step count so that the JAX
        package accepts the file; the port's own generator state rides the
        checkpoint's extra dict."""
        return np.array([self._step_count & 0xFFFFFFFF, (self._seed + 1) & 0xFFFFFFFF],
                        np.uint32)

    def _full_state(self) -> Dict[str, Any]:
        return {
            "params": self.parameters.params,
            "state": self.parameters.state,
            "opt_state": self._opt_state,
            "rng": self._rng_key(),
        }

    def save_checkpoint(self, manager, step: Optional[int] = None, async_: bool = False,
                        extra: Optional[Dict[str, Any]] = None) -> None:
        """Write parameters, layer state, optimizer state and counters
        through a ``checkpoint.CheckpointManager``; `extra` merges into the
        step's extra dict."""
        manager.save(
            step if step is not None else self._step_count,
            self._full_state(),
            extra={"step_count": self._step_count,
                   "torch_rng": self._rng.get_state().numpy().tobytes().hex(),
                   **(extra or {})},
            async_=async_,
        )

    def _apply_restored(self, tree, extra) -> None:
        self.parameters.params = tree["params"]
        self.parameters.state = tree["state"]
        self._opt_state = tree["opt_state"]
        if "torch_rng" in extra:
            self._rng.set_state(torch.frombuffer(
                bytearray(bytes.fromhex(extra["torch_rng"])), dtype=torch.uint8))
        else:
            # a JAX package checkpoint: seed the generator from its key
            key = [int(x) for x in np.asarray(tree["rng"]).reshape(-1)]
            self._rng.manual_seed((key[0] << 32 | key[-1]) & 0x7FFFFFFFFFFFFFFF)
        self._step_count = int(extra.get("step_count", self._step_count))

    def _restore_latest_full(self, manager) -> Optional[Dict[str, Any]]:
        """Restore the latest restorable checkpoint (a torn newest one is
        walked past) and return its extra dict (the position the recovery
        plane stored), or None when there is none."""
        restored = manager.restore_latest(self._full_state())
        if restored is None:
            return None
        _, tree, extra = restored
        self._apply_restored(tree, extra)
        return dict(extra)

    def elastic_model(self, decode):
        """This trainer as an elastic worker's model
        (:class:`~paddle_tpu_torch.trainer.elastic.TrainerTaskModel`):
        ``decode(record) -> sample`` turns one stored record into one feed
        sample."""
        from paddle_tpu_torch.trainer.elastic import TrainerTaskModel

        return TrainerTaskModel(self, decode)

    def restore_checkpoint(self, manager, step: Optional[int] = None) -> bool:
        """Restore the latest restorable (or the given) checkpoint; False
        when the directory holds none."""
        if step is None:
            restored = manager.restore_latest(self._full_state())
            if restored is None:
                return False
            _, tree, extra = restored
        else:
            tree, extra = manager.restore(step, self._full_state())
        self._apply_restored(tree, extra)
        return True
