"""``python -m paddle_tpu_torch <command>`` — the counterpart of
``paddle_tpu/cli.py``, the reference's ``paddle`` command line
(``paddle/trainer/TrainerMain.cpp:32-65``, ``paddle/scripts/submit_local.sh.in``):

* ``train --config=conf.py --job=train|test|time|checkgrad`` runs a v1
  config file unmodified (parse -> compile -> train step pass loop, with
  ``pass-%05d/`` dirs as the reference trainer writes them), on the card
  unless ``--device=cpu``; ``--job=time`` is the reference's
  TrainerBenchmark (TrainerBenchmark.cpp:71);
* ``version``, ``dump_config``, ``make_diagram``, ``merge_model``,
  ``plotcurve``; ``trace merge|validate`` over obs span files; ``lint``
  (the self-lint of the port's source), ``lint --config`` (the graph
  lint), ``lint --journal``, ``lint --concurrency``, ``lint --protocol``,
  and over traced train steps ``lint --donation`` and ``lint --numerics
  [--config ... --compute-dtype ... --certify]``;
* ``master`` and ``worker`` (an HA master candidate of the elastic cluster
  plane, and one elastic trainer process), ``serve`` and ``route`` (one
  serving engine under the SLO scheduler, or a fleet engine with
  ``--register``; the fleet router);
* ``scenario`` (the mixed-traffic SLO and chaos scenario harness,
  robustness/scenarios.py) and ``fuzz`` (the chaos-composition fuzzer,
  robustness/fuzz.py), their serving engines on the card unless
  ``--device=cpu``;
* ``explore`` (the interleaving explorer over the router, master and HA
  lease state machines, analysis/interleave.py; host code, no card);
* ``cache ls|warm|prune|clear`` over the persistent build store
  (core/aot_cache.py): ``warm`` walks a config's feed and resolves the
  train step's rung for each distinct batch shape, building or loading
  the native libraries it launches, on the card unless ``--device=cpu``.

Flags mirror the reference gflags in ``--name=value`` form; argparse also
accepts ``--name value``."""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import sys
import time
from typing import List, Optional

__all__ = ["main", "cmd_train", "cmd_version", "cmd_dump_config", "cmd_make_diagram",
           "cmd_merge_model", "cmd_plotcurve", "cmd_trace", "cmd_lint", "cmd_master",
           "cmd_worker", "cmd_serve", "cmd_route", "cmd_scenario", "cmd_fuzz",
           "cmd_explore", "cmd_cache"]


def _echo(msg: str) -> None:
    print(msg, flush=True)


def _cli_device(arg):
    """The resolved device of a ``--device`` argument, or None after
    printing the device error (the command then exits 1)."""
    from paddle_tpu_torch.core.device import resolve_device

    try:
        return resolve_device(arg)
    except RuntimeError as e:
        print(f"error: {e} (on the command line: --device=cpu)", file=sys.stderr)
        return None


def _build_train_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch train",
        description="Train/test/time/checkgrad a v1 config file "
        "(reference paddle_trainer, TrainerMain.cpp).",
    )
    ap.add_argument("--config", required=True, help="v1 config file (.py/.conf)")
    ap.add_argument(
        "--config_args", default="",
        help="comma-separated key=value pairs passed to the config "
        "(get_config_arg)",
    )
    ap.add_argument(
        "--job", default="train",
        choices=["train", "test", "time", "checkgrad"],
        help="one of (train, test, time, checkgrad) — TrainerMain.cpp:51-62",
    )
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' asks for the CPU)")
    ap.add_argument("--save_dir", default=None, help="write pass-%%05d/ checkpoints here")
    ap.add_argument("--num_passes", type=int, default=1)
    ap.add_argument("--start_pass", type=int, default=0)
    ap.add_argument(
        "--init_model_path", default=None,
        help="load initial parameters from this pass dir, merge_model bundle "
        "or params.tar (ParamUtil.cpp)",
    )
    ap.add_argument("--saving_period", type=int, default=1)
    ap.add_argument("--saving_period_by_batches", type=int, default=0)
    ap.add_argument("--batch_size", type=int, default=0,
                    help="override the config's settings(batch_size=...)")
    ap.add_argument("--log_period", type=int, default=None)
    ap.add_argument("--dot_period", type=int, default=1,
                    help="print a '.' every N batches (reference TrainerInternal)")
    ap.add_argument("--show_parameter_stats_period", type=int, default=None)
    ap.add_argument("--test_period", type=int, default=50,
                    help="--job=time: number of timed batches "
                    "(TrainerBenchmark.cpp:79)")
    ap.add_argument("--feed_data", action="store_true",
                    help="--job=time: refetch a fresh batch every timed step "
                    "instead of reusing one (TrainerBenchmark.cpp:80-83)")
    ap.add_argument("--seed", type=int, default=None)
    # the reference's and the JAX package's device switches: recorded as
    # flags, the device comes from --device alone
    ap.add_argument("--use_tpu", type=_flag_bool, default=True, nargs="?", const=True)
    ap.add_argument("--use_gpu", type=_flag_bool, default=False, nargs="?", const=True)
    ap.add_argument("--trainer_count", type=int, default=1)
    ap.add_argument("--async_load_data", type=_flag_bool, default=True)
    ap.add_argument(
        "--cache_pass_in_mem", type=_flag_bool, default=False, nargs="?",
        const=True,
        help="device-resident pass cache: epoch 1 captures the staged "
        "batches on the device, later epochs replay them with no "
        "host-to-device copy (CacheType.CACHE_PASS_IN_MEM; "
        "@provider(cache=...) configs enable this without the flag)",
    )
    ap.add_argument(
        "--data_echo_factor", type=int, default=None,
        help="train each epoch-1 batch N times (data echo) to amortize "
        "its host-to-device copy; needs the pass cache enabled",
    )
    ap.add_argument(
        "--aot_cache_dir", default=None,
        help="persistent build cache (core/aot_cache.py): warm boots load "
        "the native libraries (the flash kernels, the readers) from here "
        "instead of compiling them; prewarm with `python -m "
        "paddle_tpu_torch cache warm`",
    )
    ap.add_argument(
        "--whole_pass_program", type=_flag_bool, default=False, nargs="?",
        const=True,
        help="run cached epochs >= 2 as ONE epoch program over the stacked "
        "pass cache (one fetch per pass, bit-exact vs stepwise); needs "
        "--cache_pass_in_mem",
    )
    ap.add_argument(
        "--checkpoint_dir", default=None,
        help="fault-tolerance plane (robustness/): write full-state "
        "checkpoints (params + optimizer state + generator + pass/batch "
        "position) here every --checkpoint_period_batches batches and at "
        "pass boundaries; enables divergence auto-rollback and "
        "preemption-safe shutdown (SIGTERM -> final checkpoint + "
        "PREEMPTED marker)",
    )
    ap.add_argument(
        "--checkpoint_period_batches", type=int, default=None,
        help="full-state checkpoint cadence in batches (default: the "
        "checkpoint_period_batches flag)",
    )
    ap.add_argument(
        "--resume", action="store_true",
        help="restore the latest good checkpoint from --checkpoint_dir "
        "(walking past torn ones) and continue mid-pass where the "
        "interrupted run stopped",
    )
    ap.add_argument(
        "--chaos", default=None,
        help="arm chaos fault points, e.g. 'nan_batch@5,kill@12' "
        "(robustness/chaos.py; testing only)",
    )
    return ap


def _flag_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "yes")


def _load_init_model(trainer, path: str) -> None:
    """--init_model_path: a pass dir (v1 per-parameter binaries), a
    merged-model bundle (merge_model output), or a bare params.tar."""
    import tarfile

    from paddle_tpu_torch import checkpoint as ckpt

    if os.path.isdir(path):
        ckpt.load_parameter_dir(trainer.parameters, path)
        return
    # a merge_model bundle is a tar with a manifest + nested params.tar;
    # a bare params.tar has no manifest
    is_bundle = False
    try:
        with tarfile.open(path, "r:*") as tf:
            is_bundle = any(m.name.endswith("manifest.json") for m in tf.getmembers())
    except tarfile.ReadError:
        pass
    if is_bundle:
        from paddle_tpu_torch.utils.model_tools import load_merged_model

        load_merged_model(path, trainer.parameters)
    else:
        with open(path, "rb") as f:
            trainer.parameters.from_tar(f)


def _make_trainer(parsed, seed: int, device):
    from paddle_tpu_torch import parameters as v2_params
    from paddle_tpu_torch import trainer as v2_trainer
    from paddle_tpu_torch.v1_compat import make_optimizer

    params = v2_params.create(parsed.topology, seed=seed, device=device)
    return v2_trainer.SGD(
        cost=parsed.topology,
        parameters=params,
        update_equation=make_optimizer(parsed.settings),
        evaluators=list(parsed.evaluators),
        seed=seed,
        device=device,
    )


# The reference trainer's registered gflags this CLI doesn't implement
# (paddle/utils/Flags.cpp + paddle/trainer/*.cpp DEFINE_*), the JAX
# package's set: a train.sh line that works against paddle_trainer must not
# die here — these names are accepted and ignored with a note.  Anything
# NOT in this set (typos, stray tokens) stays a hard error.
_IGNORED_REFERENCE_FLAGS = {
    "average_test_period", "beam_size", "checkgrad_eps", "comment",
    "distribute_test", "enable_parallel_vector", "gpu_id",
    "load_missing_parameter_strategy", "loadsave_parameters_in_pserver",
    "local", "log_period_server", "nics", "num_gradient_servers",
    "parallel_nn", "port", "ports_num", "ports_num_for_sparse",
    "prev_batch_state", "rdma_tcp", "save_only_one", "show_layer_stat",
    "start_pserver", "test_all_data_in_one_period", "test_pass",
    "test_wait", "trainer_id", "use_old_updater", "with_cost",
}


# the subset of ignored flags that take a VALUE (gflags string/int/double
# definitions per the reference Flags.cpp/trainer flags) — only these may
# consume a separate following token; the boolean remainder never does.
# NB test_wait and enable_parallel_vector LOOK boolean but are DEFINE_int32
# (Trainer.cpp:70, Flags.cpp:62).
_VALUE_REFERENCE_FLAGS = {
    "average_test_period", "beam_size", "checkgrad_eps", "comment",
    "enable_parallel_vector", "gpu_id", "load_missing_parameter_strategy",
    "log_period_server", "nics", "num_gradient_servers", "port",
    "ports_num", "ports_num_for_sparse", "rdma_tcp", "test_pass",
    "test_wait", "trainer_id",
}


def _ignored_flag_name(token: str):
    """The _IGNORED_REFERENCE_FLAGS entry this token spells, or None.
    Accepts --name, --name=value, and the gflags --no<bool> negation."""
    if not token.startswith("-"):
        return None
    name = token.lstrip("-").split("=", 1)[0]
    if name in _IGNORED_REFERENCE_FLAGS:
        return name
    if name.startswith("no") and name[2:] in _IGNORED_REFERENCE_FLAGS:
        return name[2:]
    return None


def _split_unknown(unknown: List[str]):
    """(ignored reference-flag tokens, fatal tokens) of the arguments the
    train parser did not know."""
    ignored, fatal = [], []
    i = 0
    while i < len(unknown):
        u = unknown[i]
        name = _ignored_flag_name(u)
        if name is not None:
            ignored.append(u)
            # gflags separate-value form (`--gpu_id -1`, `--nics eth0`):
            # only VALUE-taking flags consume the next token, and only when
            # the value wasn't already attached with '='.  The token must
            # neither be a key=value (a stray `batch_size=32` after a
            # boolean stays fatal) nor LOOK like a flag itself (`--nics
            # --nolocall` must not eat the typo) — negative numbers like
            # `-1` are values, dash-then-letter is a flag.
            nxt = unknown[i + 1] if i + 1 < len(unknown) else None
            looks_like_flag = bool(nxt and re.match(r"--?[A-Za-z]", nxt))
            if (
                "=" not in u
                and not u.lstrip("-").startswith("no")
                and name in _VALUE_REFERENCE_FLAGS
                and nxt is not None
                and "=" not in nxt
                and not looks_like_flag
            ):
                ignored.append(nxt)
                i += 1
        else:
            fatal.append(u)
        i += 1
    return ignored, fatal


def cmd_train(argv: List[str]) -> int:
    """``train`` — the reference ``paddle train`` (TrainerMain.cpp): parse a
    v1 config, build its network and optimizer, and run ``--job`` (train,
    test, time or checkgrad) on the card unless ``--device=cpu``."""
    args, unknown = _build_train_parser().parse_known_args(argv)
    ignored, fatal = _split_unknown(unknown)
    if ignored:
        print(f"note: ignoring reference trainer flags {ignored}", file=sys.stderr)
    if fatal:
        print(
            f"error: unrecognized arguments {fatal} (not reference trainer "
            "flags; see `python -m paddle_tpu_torch train --help`)",
            file=sys.stderr,
        )
        return 2
    from paddle_tpu_torch import obs as _obs
    from paddle_tpu_torch.utils import flags as _flags
    from paddle_tpu_torch.v1_compat import parse_config

    device = _cli_device(args.device)
    if device is None:
        return 1
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    _obs.tracer.configure(role="trainer")
    if args.log_period is not None:
        _flags.set_flag("log_period", args.log_period)
    if args.show_parameter_stats_period is not None:
        _flags.set_flag("show_parameter_stats_period", args.show_parameter_stats_period)
    if args.seed is not None:
        _flags.set_flag("seed", args.seed)
    if args.cache_pass_in_mem:
        _flags.set_flag("cache_pass_in_mem", True)
    if args.data_echo_factor is not None:
        _flags.set_flag("data_echo_factor", args.data_echo_factor)
    if args.whole_pass_program:
        _flags.set_flag("whole_pass_program", True)
    if args.aot_cache_dir:
        _flags.set_flag("aot_cache_dir", args.aot_cache_dir)
    if args.chaos:
        from paddle_tpu_torch.robustness import chaos as _chaos

        _chaos.arm(args.chaos)
    _flags.set_flags(use_tpu=args.use_tpu, use_gpu=args.use_gpu,
                     trainer_count=args.trainer_count)
    if _flags.get_flag("compute_dtype"):
        # the flag (PADDLE_TPU_TORCH_COMPUTE_DTYPE) picks mixed precision,
        # as init() does
        from paddle_tpu_torch.core.compiler import set_default_compute_dtype

        set_default_compute_dtype(_flags.get_flag("compute_dtype"))
    seed = _flags.get_flag("seed")

    config_path = os.path.abspath(args.config)
    config_dir = os.path.dirname(config_path)
    parsed = parse_config(config_path, args.config_args)
    if args.batch_size:
        # write the override back BEFORE building the optimizer: the
        # 'manual' LR schedule converts its sample boundaries through
        # settings.batch_size (reference numSamplesProcessed counts real
        # samples)
        parsed.settings.batch_size = args.batch_size
    batch_size = parsed.settings.batch_size
    trainer = _make_trainer(parsed, seed, device)

    if args.init_model_path:
        _load_init_model(trainer, args.init_model_path)
    elif args.start_pass > 0 and args.save_dir:
        # resume from the last completed pass (reference ParamUtil
        # loadParametersWithPath from save_dir/pass-%05d)
        trainer.load_pass(args.save_dir, args.start_pass - 1)

    job = {"train": _job_train, "test": _job_test, "time": _job_time,
           "checkgrad": _job_checkgrad}[args.job]
    return job(args, parsed, trainer, batch_size, config_dir)


def _has_test(parsed) -> bool:
    """Whether the config declares a test stream (TestData, or a test list
    in define_py_data_sources2)."""
    return parsed.test_data is not None or bool(
        parsed.data_sources is not None and parsed.data_sources.test_list)


def _job_train(args, parsed, trainer, batch_size, config_dir) -> int:
    """--job=train: dots, "Pass N: mean cost", the test stream after each
    pass, pass-%05d dirs; exit 75 when preempted."""
    from paddle_tpu_torch import event as v2_event
    from paddle_tpu_torch import minibatch
    from paddle_tpu_torch.v1_compat import make_batched_reader, make_config_reader

    test_reader = None
    if _has_test(parsed):
        try:
            test_reader = make_config_reader(parsed, config_dir, train=False)
        except (ValueError, FileNotFoundError) as e:
            _echo(f"test data declared but unavailable ({e}); skipping eval")

    dot = max(args.dot_period, 0)
    t0 = time.time()

    def handler(ev) -> None:
        if isinstance(ev, v2_event.EndIteration):
            if dot and (ev.batch_id + 1) % dot == 0:
                sys.stdout.write(".")
                sys.stdout.flush()
        elif isinstance(ev, v2_event.EndPass):
            sys.stdout.write("\n")
            _echo(
                f"Pass {ev.pass_id}: mean cost "
                f"{ev.evaluator.get('mean_cost', float('nan')):.6f} "
                f"({time.time() - t0:.1f}s elapsed)"
            )
            for k, v in sorted(ev.evaluator.items()):
                if k != "mean_cost":
                    _echo(f"  {k} = {v}")
            if test_reader is not None:
                res = trainer.test(reader=minibatch.batch(test_reader, batch_size),
                                   feeding=parsed.feeding)
                _echo(f"Test with Pass {ev.pass_id}: cost {res.cost:.6f}")
                for k, v in sorted(res.metrics.items()):
                    _echo(f"  {k} = {v}")

    trainer.train(
        reader=make_batched_reader(parsed, config_dir, batch_size, train=True),
        num_passes=args.num_passes,
        event_handler=handler,
        feeding=parsed.feeding,
        save_dir=args.save_dir,
        saving_period=args.saving_period,
        saving_period_by_batches=args.saving_period_by_batches or None,
        start_pass=args.start_pass,
        async_load_data=args.async_load_data,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_period_batches=args.checkpoint_period_batches,
        resume=args.resume,
    )
    if trainer.preempted:
        _echo(
            f"PREEMPTED: state checkpointed under {args.checkpoint_dir}; "
            "restart with --resume to continue"
        )
        return 75  # EX_TEMPFAIL: restart me
    return 0


def _job_test(args, parsed, trainer, batch_size, config_dir) -> int:
    """--job=test (reference Tester.cpp): evaluate the loaded model on the
    config's test stream (train stream when no test stream is declared or
    it cannot be read)."""
    from paddle_tpu_torch import minibatch
    from paddle_tpu_torch.v1_compat import make_config_reader

    reader = None
    if _has_test(parsed):
        try:
            reader = make_config_reader(parsed, config_dir, train=False)
        except (ValueError, FileNotFoundError):
            pass
    if reader is None:
        _echo("no test data declared; evaluating on the train stream")
        reader = make_config_reader(parsed, config_dir, train=True)
    res = trainer.test(reader=minibatch.batch(reader, batch_size), feeding=parsed.feeding)
    _echo(f"Test cost {res.cost:.6f}")
    for k, v in sorted(res.metrics.items()):
        _echo(f"  {k} = {v}")
    return 0


def _job_time(args, parsed, trainer, batch_size, config_dir) -> int:
    """--job=time (TrainerBenchmark.cpp:30-90): 10 burn-in steps on one
    batch, then ``--test_period`` timed steps; prints the StatSet table the
    reference prints via globalStat.printSegTimerStatus().  The clock is
    read after a host fetch of the cost (the device has finished then)."""
    from paddle_tpu_torch.reader.pass_cache import PassCache
    from paddle_tpu_torch.trainer.step import draw_seed
    from paddle_tpu_torch.utils.flags import get_flag
    from paddle_tpu_torch.utils.timers import global_stats, stat_timer
    from paddle_tpu_torch.v1_compat import make_batched_reader

    # honors use_bucketing: --job=time measures the bucketed feed when the
    # flag is on
    batch_reader = make_batched_reader(parsed, config_dir, batch_size, train=True)
    batches = batch_reader()
    feeder = trainer._make_feeder(parsed.feeding)

    def next_batch():
        nonlocal batches
        with stat_timer("GetData"):
            try:
                raw = next(batches)
            except StopIteration:
                batches = batch_reader()
                raw = next(batches)
            return feeder(raw)

    # --cache_pass_in_mem (or a CACHE_PASS_IN_MEM provider): stage the timed
    # batches once, seal the device-resident cache, and feed every timed
    # step from its replay — the timing then measures the cached-epoch
    # regime instead of the host-to-device copy
    cached_iter = None
    if get_flag("cache_pass_in_mem") or getattr(batch_reader, "cache_pass_in_mem", False):
        # timing feed: no echo (every timed step must be a distinct step)
        cache = PassCache.from_flags(batch_reader, echo_factor=1)
        # stage at most ONE pass, capped at the timed-step count
        for raw in batch_reader():
            with stat_timer("GetData"):
                cache.observe(feeder(raw))
            if not cache.active or cache.n_batches >= max(args.test_period, 1):
                break
        cache.seal()
        if cache.ready:
            cached_iter = cache.stream()
            _echo(f"pass cache: {cache.summary()}")

    batch = next(cached_iter) if cached_iter is not None else next_batch()
    params, state = trainer.parameters.params, trainer.parameters.state
    opt_state = trainer._opt_state

    def one_step(params, state, opt_state, batch):
        return trainer._train_step(params, state, opt_state, batch, draw_seed(trainer._rng))

    _echo("Burning time...")
    for _ in range(10):
        params, state, opt_state, metrics = one_step(params, state, opt_state, batch)
    float(metrics["cost"])  # host fetch: the device is done
    _echo("Burning time end.")

    n = 0
    t0 = time.time()
    for _ in range(max(args.test_period, 1)):
        if args.feed_data:
            batch = next(cached_iter) if cached_iter is not None else next_batch()
        with stat_timer("FwdBwd"):
            params, state, opt_state, metrics = one_step(params, state, opt_state, batch)
        n += 1
    float(metrics["cost"])
    dt = time.time() - t0
    global_stats.print_all_status()  # prints the StatSet table itself
    _echo(
        f"{n} batches of {batch_size}: {dt * 1000 / n:.3f} ms/batch, "
        f"{n * batch_size / dt:.1f} samples/sec"
    )
    global_stats.reset()
    return 0


def directional_derivatives(trainer, fed, eps: float = 1e-5):
    """The reference's gradient check (Trainer::checkGradient) of the
    trainer's network on the fed batch `fed`, in float64: per parameter
    tensor, in sorted order, a direction d drawn from
    ``np.random.RandomState(0)`` (unit norm), the analytic <grad, d> of
    the summed output means and the central difference
    (cost(w + eps d) - cost(w - eps d)) / (2 eps).  Returns [(dotted name,
    analytic, finite difference, relative error)].  The default dtype is
    float64 only inside this call."""
    import numpy as np
    import torch

    from paddle_tpu_torch.core.batch import SeqTensor
    from paddle_tpu_torch.core.compiler import CompiledNetwork
    from paddle_tpu_torch.utils.tree import get_path, leaf_paths, map_leaves, set_path

    def f64(x):
        return x.to(torch.float64) if torch.is_tensor(x) and x.is_floating_point() else x

    batch = {k: SeqTensor(f64(t.data), t.lengths, t.sub_lengths, sparse_ids=t.sparse_ids)
             for k, t in fed.items()}
    # the trainer's topology with no compute-dtype casts: float64 all through
    net = CompiledNetwork(trainer.topology, compute_dtype=torch.float32)
    state = map_leaves(f64, trainer.parameters.state)
    out_names = list(net.topology.output_names)

    def total_cost(params):
        outs, _ = net.apply(params, batch, state=state, train=True, rng=0)
        return sum(outs[name].data.to(torch.float64).mean() for name in out_names)

    def loss(params) -> float:
        with torch.no_grad():
            return float(total_cost(params))

    saved_dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        base = map_leaves(lambda v: f64(v).detach(), trainer.parameters.params)
        leaves = map_leaves(lambda v: v.clone().requires_grad_(True), base)
        paths = sorted(leaf_paths(leaves), key=lambda pv: pv[0])
        with torch.enable_grad():
            grads = torch.autograd.grad(total_cost(leaves), [v for _, v in paths],
                                        allow_unused=True)
        rng_np = np.random.RandomState(0)
        rows = []
        for (path, _), g in zip(paths, grads):
            w0 = get_path(base, path)
            gval = np.zeros(tuple(w0.shape)) if g is None else g.cpu().numpy()
            d = rng_np.standard_normal(tuple(w0.shape))
            d /= max(np.linalg.norm(d), 1e-12)
            step = eps * torch.as_tensor(d, device=w0.device)
            pert = map_leaves(lambda x: x, base)  # a new tree sharing the leaves
            set_path(pert, path, w0 + step)
            lp = loss(pert)
            set_path(pert, path, w0 - step)
            lm = loss(pert)
            fd = (lp - lm) / (2 * eps)
            an = float((gval * d).sum())
            rows.append((".".join(path), an, fd, abs(fd - an) / max(abs(fd), abs(an), 1e-8)))
    finally:
        torch.set_default_dtype(saved_dtype)
    return rows


def _job_checkgrad(args, parsed, trainer, batch_size, config_dir) -> int:
    """--job=checkgrad (Trainer::checkGradient, Trainer.cpp): the
    directional check of :func:`directional_derivatives` on the first
    min(batch_size, 8) samples, in float64 (the reference's WITH_DOUBLE
    build; in f32 the forward's noise swamps any usable eps); a parameter
    fails above 1e-3 relative."""
    from paddle_tpu_torch import minibatch
    from paddle_tpu_torch.v1_compat import make_config_reader

    reader = make_config_reader(parsed, config_dir, train=True)
    raw = next(minibatch.batch(reader, min(batch_size, 8))())
    rows = directional_derivatives(trainer, trainer._make_feeder(parsed.feeding)(raw))
    failed = [r for r in rows if r[3] > 1e-3]
    if failed:
        for name, an, fd, rel in failed:
            _echo(f"FAIL {name}: analytic {an:.6g} vs fd {fd:.6g} (rel {rel:.3g})")
        return 1
    n_layers = len({name.split(".")[0] for name, *_ in rows})
    worst = max((r[3] for r in rows), default=0.0)
    _echo(f"checkgrad PASSED ({n_layers} parameters, worst rel err {worst:.3g})")
    return 0


# ---------------------------------------------------------------------------
# the tooling subcommands (submit_local.sh.in:114-135)
# ---------------------------------------------------------------------------

def cmd_version(argv: List[str]) -> int:
    import torch

    import paddle_tpu_torch

    print(f"paddle_tpu_torch {paddle_tpu_torch.__version__}, running on")
    print(f"    torch: {torch.__version__} (CUDA {torch.version.cuda})")
    if torch.cuda.is_available():
        devs = [f"cuda:{i} ({torch.cuda.get_device_name(i)})"
                for i in range(torch.cuda.device_count())]
        print(f"    devices: {devs}")
    else:
        print("    devices: ['cpu'] (no CUDA device)")
    return 0


def cmd_dump_config(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch dump_config")
    ap.add_argument("config")
    ap.add_argument("--config_args", default="")
    args = ap.parse_args(argv)
    from paddle_tpu_torch.utils.model_tools import dump_config

    print(dump_config(args.config, args.config_args))
    return 0


def cmd_make_diagram(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch make_diagram")
    ap.add_argument("config")
    ap.add_argument("dot_file")
    ap.add_argument("--config_args", default="")
    args = ap.parse_args(argv)
    from paddle_tpu_torch.utils.model_tools import make_diagram
    from paddle_tpu_torch.v1_compat import parse_config

    parsed = parse_config(os.path.abspath(args.config), args.config_args)
    make_diagram(parsed.topology, args.dot_file)
    print(f"wrote {args.dot_file}")
    return 0


def cmd_merge_model(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch merge_model")
    ap.add_argument("--model_dir", required=True, help="a pass-%%05d dir")
    ap.add_argument("--config_file", required=True)
    ap.add_argument("--model_file", required=True, help="output bundle path")
    ap.add_argument("--config_args", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' asks for the CPU)")
    args = ap.parse_args(argv)
    from paddle_tpu_torch import checkpoint as ckpt
    from paddle_tpu_torch import parameters as v2_params
    from paddle_tpu_torch.utils.model_tools import merge_model
    from paddle_tpu_torch.v1_compat import parse_config

    parsed = parse_config(os.path.abspath(args.config_file), args.config_args)
    params = v2_params.create(parsed.topology, device=args.device)
    ckpt.load_parameter_dir(params, args.model_dir)
    merge_model(params, args.model_file)
    print(f"wrote {args.model_file}")
    return 0


def cmd_plotcurve(argv: List[str]) -> int:
    from paddle_tpu_torch.utils.plotcurve import main as plot_main

    return plot_main(argv)


def cmd_trace(argv: List[str]) -> int:
    """``trace`` — the span-timeline tooling (obs/):

    * ``merge --dir D [--out F]`` — zip the per-process
      ``trace-<role>-<pid>.json`` files a launcher run left behind into ONE
      Chrome-trace timeline (opens directly in Perfetto), clock-skew
      aligned via the RPC plane's request/response pairs (wall-anchor
      fallback for processes that never talked);
    * ``validate F`` — schema-check a trace file (required event keys,
      begin/end pairing, well-formed args); exit 0 iff valid.

    One JSON summary line per run (event counts, pids, planes, applied
    per-process clock offsets)."""
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch trace",
        description="merge/validate span-timeline files (paddle_tpu_torch/obs)",
    )
    ap.add_argument("action", choices=["merge", "validate"])
    ap.add_argument("paths", nargs="*",
                    help="validate: trace file(s); merge: explicit trace "
                    "files instead of --dir")
    ap.add_argument("--dir", default=None,
                    help="merge: directory of trace-*.json files")
    ap.add_argument("--out", default=None,
                    help="merge: merged timeline path (default <dir>/merged.json)")
    args = ap.parse_args(argv)

    from paddle_tpu_torch.obs import merge as _merge

    if args.action == "validate":
        if not args.paths:
            print("error: validate needs trace file path(s)", file=sys.stderr)
            return 2
        bad = 0
        for p in args.paths:
            problems = _merge.validate_trace(_merge.load_trace(p))
            print(json.dumps({"file": p, "valid": not problems, "problems": problems[:20]}))
            bad += bool(problems)
        return 1 if bad else 0

    if args.paths:
        merged = _merge.merge_traces([_merge.load_trace(p) for p in args.paths])
        out = args.out or "merged.json"
        with open(out, "w") as f:
            json.dump(merged, f)
    elif args.dir:
        merged, out = _merge.merge_dir(args.dir, out_path=args.out)
    else:
        print("error: merge needs --dir or trace file paths", file=sys.stderr)
        return 2
    other = merged["otherData"]
    print(json.dumps({
        "merged": out,
        "events": sum(1 for e in merged["traceEvents"] if e.get("ph") != "M"),
        "pids": other["merged_pids"],
        "roles": other["roles"],
        "offsets_us": other["offsets_us"],
        "rpc_pair_edges": other["rpc_pair_edges"],
    }))
    return 0


def cmd_lint(argv: List[str]) -> int:
    """``lint`` — static analysis (analysis/):

    * no mode: self-lint of the port's own source (rules A###: unseeded
      reader RNG, duplicate flags, wall clock in obs/, raw deserialization
      outside master_wire.py; ``# wire: allow[A206] <why>`` escapes a
      genuinely-local read), plus any ``--extra`` files;
    * --config=conf.py: parse the v1 config and graph-lint its topology
      (rules G###) with layer + config provenance;
    * --journal=master_journal-000001.log: verify a master journal file —
      framing/CRC (J001), unknown record types (J002), sequence
      monotonicity (J003), torn tail (J004);
    * --concurrency: lock-discipline lint (rules C###) over the port's
      threaded planes, plus any ``--extra`` files;
    * --protocol: protocol-conformance lint (rules P###) over the master,
      HA, journal, wire and serving-fleet surfaces;
    * --donation: buffer-donation audit (rule T106) over the shipped step
      builders — trace make_train_step / make_multi_train_step / the
      whole-pass epoch program on a probe network and flag any large
      carried buffer that is not updated in place;
    * --numerics: precision-flow lint (rules N###) over traced train steps.
      Alone it lints the package's step over probe topologies; with
      --config it lints each config's real train step;
      --compute-dtype/--master-dtype pick the precision plan, and --certify
      (needs --config) prints the per-layer precision certificate
      (analysis.certify_precision_plan).

    --donation and --numerics trace on the card unless ``--device=cpu``.
    The modes combine in one run.  Exit 0 only when no diagnostics fire."""
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch lint",
        description="config-time graph lint + package self-lint "
        "(the reference config_parser's config_assert plane)",
    )
    ap.add_argument("--config", action="append", default=[],
                    help="v1 config file to graph-lint (repeatable; skips the self-lint)")
    ap.add_argument("--config_args", default="",
                    help="comma-separated key=value pairs for the config(s)")
    ap.add_argument("--extra", action="append", default=[],
                    help="extra .py files to self-lint (e.g. chip_smoke.py)")
    ap.add_argument("--journal", action="append", default=[],
                    help="master journal file to verify (repeatable; rules J###; "
                    "skips the self-lint)")
    ap.add_argument("--concurrency", action="store_true",
                    help="lock-discipline lint (rules C###) over the package source "
                    "(skips the self-lint)")
    ap.add_argument("--protocol", action="store_true",
                    help="protocol-conformance lint (rules P###) over the distributed "
                    "planes: RPC surface vs handlers vs wire universe, journal "
                    "record/replay/compaction coverage, status-ledger exhaustiveness, "
                    "lease/fence monotonicity, timeout completeness (skips the self-lint)")
    ap.add_argument("--donation", action="store_true",
                    help="audit the shipped step builders' in-place updates (rule T106; "
                    "skips the self-lint)")
    ap.add_argument("--numerics", action="store_true",
                    help="precision-flow lint (rules N###) over traced train steps: "
                    "package probes, or each --config's real step (skips the self-lint)")
    ap.add_argument("--compute-dtype", default=None,
                    help="numerics: compute dtype of the precision plan (e.g. bfloat16; "
                    "default float32)")
    ap.add_argument("--master-dtype", default=None,
                    help="numerics: master/param dtype of the plan (default float32)")
    ap.add_argument("--certify", action="store_true",
                    help="numerics + --config: print the per-layer precision "
                    "certificate for the dtype plan")
    ap.add_argument("--device", default=None,
                    help="device the --donation and --numerics traces run on "
                    "(default: the card)")
    ap.add_argument("--min-severity", default=None, choices=["info", "warning", "error"],
                    help="only report findings at or above this severity")
    args = ap.parse_args(argv)

    if args.certify and not (args.numerics and args.config):
        print("error: --certify needs --numerics and --config (a certificate is "
              "per-topology; the package probes have none)", file=sys.stderr)
        return 2
    dev = None
    if args.donation or args.numerics:
        dev = _cli_device(args.device)
        if dev is None:
            return 1

    from paddle_tpu_torch import analysis

    diags = []
    if args.journal:
        from paddle_tpu_torch import master_journal as _mj

        for jpath in args.journal:
            for f in _mj.verify_journal(jpath):
                diags.append(analysis.Diagnostic(
                    rule=f["rule"],
                    severity=analysis.Severity[f["severity"].upper()],
                    message=f["message"],
                    source=jpath,
                ))
    if args.config and not args.numerics:
        import dataclasses as _dc

        from paddle_tpu_torch.v1_compat import parse_config

        for cfg in args.config:
            if len(args.config) > 1:
                print(f"graph-lint {cfg}")
            try:
                parsed = parse_config(os.path.abspath(cfg), args.config_args)
            except analysis.DiagnosticError as e:
                # build-time findings (duplicate names, feed-slot errors)
                # report like any other lint result, not as a traceback,
                # attributed to this config
                diags.extend(_dc.replace(d, source=cfg) for d in e.diagnostics)
                continue
            diags.extend(analysis.lint_parsed(parsed))
    if args.concurrency:
        diags.extend(analysis.lint_concurrency_package(extra_paths=args.extra))
    if args.protocol:
        diags.extend(analysis.lint_protocol_package())
    if args.donation:
        diags.extend(_donation_audit_builders(dev))
    if args.numerics:
        diags.extend(_lint_numerics(args, dev))
    if not (args.config or args.journal or args.concurrency or args.protocol
            or args.donation or args.numerics):
        diags = analysis.lint_package(extra_paths=args.extra)

    if args.min_severity:
        floor = analysis.Severity[args.min_severity.upper()]
        diags = [d for d in diags if d.severity >= floor]

    print(analysis.format_diagnostics(diags))
    return 1 if diags else 0


def _donation_audit_builders(dev, apply_pragmas: bool = True):
    """T106 over the shipped step builders: trace make_train_step,
    make_multi_train_step and the whole-pass epoch program on a probe MLP
    and audit that every large carried buffer (params/opt-state/carry) is
    updated in place (``apply_pragmas=False``: the justified findings too)."""
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.analysis.trace_lint import donation_audit
    from paddle_tpu_torch.core.batch import SeqTensor
    from paddle_tpu_torch.core.compiler import CompiledNetwork
    from paddle_tpu_torch.core.topology import Topology, reset_auto_names
    from paddle_tpu_torch.trainer.step import (
        make_epoch_program,
        make_multi_train_step,
        make_train_carry,
        make_train_step,
    )

    reset_auto_names()
    x = paddle.layer.data("x", paddle.data_type.dense_vector(64))
    h = paddle.layer.fc(x, size=256, act=paddle.activation.Relu())
    pred = paddle.layer.fc(h, size=10, act=paddle.activation.Softmax())
    y = paddle.layer.data("y", paddle.data_type.integer_value(10))
    cost = paddle.layer.classification_cost(input=pred, label=y)
    net = CompiledNetwork(Topology([cost]))
    opt = paddle.optimizer.Adam(learning_rate=1e-2)
    params, state = net.init(0, device=dev)
    opt_state = opt.init(params)
    batch = {"x": SeqTensor(torch.zeros((8, 64), device=dev)),
             "y": SeqTensor(torch.zeros((8,), dtype=torch.int32, device=dev))}
    k = 4
    stacked = {n: SeqTensor(torch.stack([t.data] * k)) for n, t in batch.items()}
    carry = make_train_carry(params, state, opt_state, torch.Generator().manual_seed(0))
    kw = {"apply_pragmas": apply_pragmas}
    diags = []
    diags += donation_audit(make_train_step(net, opt), params, state, opt_state, batch, 0,
                            source="trainer/step.py:make_train_step", **kw)
    diags += donation_audit(make_multi_train_step(net, opt, k), params, state, opt_state,
                            stacked, 0, source="trainer/step.py:make_multi_train_step", **kw)
    diags += donation_audit(make_epoch_program(net, opt), carry, stacked, torch.arange(k),
                            source="trainer/step.py:make_epoch_program", **kw)
    print(f"donation audit: 3 step builders traced, {len(diags)} T106 finding(s)")
    return diags


def _lint_numerics(args, dev):
    """The ``lint --numerics`` body: the package probes, or each
    ``--config``'s real step (with ``--certify`` its certificate)."""
    from paddle_tpu_torch.analysis.numerics_lint import (
        _config_step_parts,
        certify_precision_plan,
        lint_numerics_config,
        lint_numerics_package,
    )

    if not args.config:
        return lint_numerics_package(compute_dtype=args.compute_dtype,
                                     master_dtype=args.master_dtype, device=dev)
    diags = []
    for cfg in args.config:
        if len(args.config) > 1 or args.certify:
            print(f"numerics-lint {cfg} (compute={args.compute_dtype or 'float32'})")
        if args.certify:
            # ONE trace: the certificate carries every (pragma-filtered)
            # N-rule finding for this plan, and a REJECT fails the exit code
            parsed, parts = _config_step_parts(cfg, args.config_args, args.compute_dtype,
                                               args.master_dtype, dev)
            cert = certify_precision_plan(parsed.topology, {
                "compute_dtype": args.compute_dtype, "master_dtype": args.master_dtype,
            }, _step=parts)
            print(cert.format())
            diags.extend(cert.diagnostics)
        else:
            diags.extend(lint_numerics_config(cfg, args.config_args,
                                              compute_dtype=args.compute_dtype,
                                              master_dtype=args.master_dtype, device=dev))
    return diags


def cmd_worker(argv: List[str]) -> int:
    """``worker`` — one elastic trainer process (trainer/elastic.py):
    leases data-shard tasks from the master, contributes deterministic
    per-task gradients, reduces at pass fences, writes its
    sharded-checkpoint shard."""
    from paddle_tpu_torch.trainer import elastic

    return elastic.main(argv)


def cmd_master(argv: List[str]) -> int:
    """``master`` — one HA master candidate for the elastic cluster plane:
    campaigns for the file lease under --dir, serves the task queues when
    leader (publishing its endpoint for HAClient discovery), stands by warm
    otherwise.  Runs until SIGTERM/SIGINT."""
    import signal

    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch master",
        description="HA master candidate (worker registry + shard leases "
        "+ pass fences; master.py/master_ha.py)",
    )
    ap.add_argument("--dir", required=True,
                    help="shared discovery/lease/snapshot directory")
    ap.add_argument("--patterns", required=True,
                    help="comma-separated recordio globs to partition")
    ap.add_argument("--chunks-per-task", type=int, default=8)
    ap.add_argument("--timeout-s", type=float, default=60.0,
                    help="per-task shard-lease timeout")
    ap.add_argument("--worker-timeout-s", type=float, default=10.0,
                    help="worker registry heartbeat-lease timeout")
    ap.add_argument("--failure-max", type=int, default=3)
    ap.add_argument("--lease-timeout", type=float, default=5.0,
                    help="leader-election lease timeout (master_ha)")
    ap.add_argument("--no-journal", action="store_true",
                    help="debounced-snapshot persistence instead of the "
                    "fsync'd journal (standbys then take over cold)")
    ap.add_argument("--journal-compact-every", type=int, default=512,
                    help="journal records between snapshot compactions")
    ap.add_argument("--no-journal-fsync", action="store_true",
                    help="skip the per-record fsync (drills only: a kill -9 "
                    "may then lose acked records)")
    ap.add_argument("--stats-out", default=None,
                    help="append one JSON line here each time THIS candidate "
                    "assumes leadership (warm/cold, replayed records, "
                    "takeover span)")
    ap.add_argument("--chaos", default=None,
                    help="arm chaos points in THIS candidate, e.g. "
                    "'kill_master@8' or 'net_partition@40' (the environment "
                    "variable PADDLE_TPU_TORCH_CHAOS also works)")
    ap.add_argument("--rpc-max-message-mb", type=int, default=None,
                    help="override the rpc_max_message_mb flag: hard bound "
                    "on one wire frame, enforced on send and on receive")
    args = ap.parse_args(argv)

    from paddle_tpu_torch import obs as _obs
    from paddle_tpu_torch.master_ha import HAMaster

    if args.rpc_max_message_mb is not None:
        from paddle_tpu_torch.utils import flags as _flags

        _flags.set_flag("rpc_max_message_mb", args.rpc_max_message_mb)

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(message)s"
    )
    _obs.tracer.configure(role="master")
    if args.chaos:
        from paddle_tpu_torch.robustness import chaos as _chaos

        _chaos.arm(args.chaos)
    ha = HAMaster(
        args.dir,
        [p for p in args.patterns.split(",") if p],
        lease_timeout=args.lease_timeout,
        chunks_per_task=args.chunks_per_task,
        timeout_s=args.timeout_s,
        worker_timeout_s=args.worker_timeout_s,
        failure_max=args.failure_max,
        auto_rotate=False,  # elastic workers fence their pass boundaries
        journal=not args.no_journal,
        journal_fsync=not args.no_journal_fsync,
        journal_compact_every=args.journal_compact_every,
    )
    stop = {"flag": False}

    def _sig(signum, frame):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    ha.start()
    _echo(f"master candidate {ha.owner_id} campaigning in {args.dir}")
    announced = False
    while not stop["flag"]:
        if ha.fatal is not None:
            _echo(f"FATAL {ha.fatal}")
            ha.stop()
            return 1
        # snapshot the server ref: the HA thread nulls it on step-down
        # between the leader check and the address read
        srv = ha.server
        if ha.is_leader.is_set() and srv is not None and not announced:
            host, port = srv.address
            _echo(f"LEADER {host}:{port}")
            if args.stats_out and ha.last_takeover is not None:
                # advisory: an unwritable path must not crash the leader
                _obs.write_stats_json(
                    args.stats_out,
                    {"owner": ha.owner_id, **ha.last_takeover},
                    append=True,
                )
            announced = True
        elif not ha.is_leader.is_set():
            announced = False
        time.sleep(0.2)  # lock: allow[C306] CLI supervision loop: wall-clock by design, driven end-to-end by the failover drills
    ha.stop()
    return 0


def cmd_serve(argv: List[str]) -> int:
    """``serve`` — the serving plane over the NMT flagship (serving/), on
    the card unless ``--device cpu``: request queue + continuous batching +
    block-paged decode cache, with the SLO surface (deadlines, bounded
    queue, shedding, chunked prefill).  Requests come from ``--requests``
    (one line of space-separated source token ids each) or ``--synthetic
    N``; arrivals follow the open-loop generator at ``--rate`` req/s.
    Prints one JSON line per completed request and a final summary line
    with the DISJOINT status ledger (served / shed / rejected / timeout /
    unfinished).  SIGTERM drains gracefully: stop admitting, finish every
    in-flight request, exit 0 (the PreemptionGuard contract the trainer
    already honors); a second signal still kills."""
    import json as _json
    import time as _time

    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch serve",
        description="continuous-batching serving plane (serving/engine.py)",
    )
    ap.add_argument("--model", default="",
                    help="parameter tar (Parameters.to_tar) of the same "
                    "topology; random seeded weights when empty")
    ap.add_argument("--src-vocab", type=int, default=1000)
    ap.add_argument("--trg-vocab", type=int, default=1000)
    ap.add_argument("--word-dim", type=int, default=128)
    ap.add_argument("--hidden-dim", type=int, default=128)
    ap.add_argument("--max-length", type=int, default=32,
                    help="compiled decode ceiling (Seq2SeqGenerator)")
    ap.add_argument("--max-new-tokens", type=int, default=None)
    ap.add_argument("--max-slots", type=int, default=None)
    ap.add_argument("--hbm-budget-mb", type=int, default=None)
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request end-to-end deadline; infeasible "
                    "requests are SHED at admission (default: the "
                    "serving_default_deadline_s flag; 0 = none)")
    ap.add_argument("--queue-limit", type=int, default=None,
                    help="bound on queued-ahead-of-admission requests; "
                    "beyond it submits are REJECTED immediately (default: "
                    "the serving_queue_limit flag; 0 = unbounded)")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=None,
                    help="chunked prefill bound (default: the "
                    "serving_prefill_chunk_tokens flag; 0 = whole-prompt "
                    "prefill)")
    ap.add_argument("--prefix-cache", action="store_true", default=None,
                    help="arm copy-on-write prompt-prefix sharing (default: "
                    "the serving_prefix_cache flag)")
    ap.add_argument("--spec-decode", action="store_true", default=None,
                    help="arm n-gram speculative decoding (default: the "
                    "serving_spec_decode flag)")
    ap.add_argument("--drain-timeout-s", type=float, default=60.0,
                    help="graceful-drain budget after SIGTERM/SIGINT")
    ap.add_argument("--requests", default="",
                    help="file of requests (space-separated src ids/line)")
    ap.add_argument("--synthetic", type=int, default=16,
                    help="generate N random requests when --requests is empty")
    ap.add_argument("--prefix-pool", type=int, default=0,
                    help="share prompt prefixes across synthetic requests: "
                    "draw from a seeded pool of N prefixes "
                    "(reader/loadgen.PrefixMixer) — the realistic workload "
                    "for the serving_prefix_cache COW sharing path; 0 = "
                    "fully independent prompts")
    ap.add_argument("--prefix-frac", type=float, default=0.5,
                    help="fraction of synthetic requests that start with a "
                    "pool prefix (only with --prefix-pool)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop arrival rate (req/s); 0 = submit all "
                    "immediately")
    ap.add_argument("--arrival", default="poisson",
                    choices=["poisson", "uniform", "burst"],
                    help="open-loop arrival process (reader/loadgen.py)")
    ap.add_argument("--sessions", type=int, default=0,
                    help="stamp synthetic requests with session ids drawn "
                    "from a pool of N sessions (PrefixMixer.session_of — "
                    "the fleet router's affinity key); 0 = session-less")
    ap.add_argument("--priority-every", type=int, default=0,
                    help="stamp every Nth request interactive class p0 and "
                    "the rest batch class p2 (per-class SLO admission, "
                    "serving/scheduler.py); 0 = everything default class p1")
    ap.add_argument("--record-trace", default="", metavar="TRACE",
                    help="record the offered workload to a replayable "
                    ".ptt request-lifecycle trace (robustness/traces.py): "
                    "arrival offsets, ids, full source ids, deadlines, "
                    "sessions, priority classes")
    ap.add_argument("--replay", default="", metavar="TRACE",
                    help="REPLAY a recorded .ptt trace instead of offering "
                    "synthetic load: the recorded arrival clock, prompts, "
                    "ids, deadlines, sessions and priorities are "
                    "reproduced bit-for-bit (--synthetic/--rate/--arrival "
                    "are ignored)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device of the engine (default: the card; "
                    "'cpu' asks for the CPU)")
    ap.add_argument("--register", default="",
                    help="run as a FLEET ENGINE: register with the router "
                    "at host:port (serving/router.py) and serve requests "
                    "over the typed wire RPC instead of a local workload; "
                    "SIGTERM drains and deregisters")
    ap.add_argument("--engine-id", default="",
                    help="engine identity on the router's lease plane "
                    "(default: engine-<pid>; only with --register)")
    ap.add_argument("--engine-port", type=int, default=0,
                    help="data-plane listen port (0 = ephemeral; only "
                    "with --register)")
    ap.add_argument("--timeout-s", type=float, default=120.0)
    ap.add_argument("--stats-out", default="",
                    help="write the summary JSON here too")
    ap.add_argument("--trace-dir", default=None,
                    help="arm Chrome-trace span export to this directory "
                    "(default: the trace_dir flag / PADDLE_TPU_TORCH_TRACE_DIR)")
    ap.add_argument("--metrics-out", default=None,
                    help="periodic Prometheus-text metrics snapshot file "
                    "(obs/metrics.py; default: the metrics_out flag)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics on http://127.0.0.1:<port> "
                    "(default: the metrics_port flag; 0 = off)")
    args = ap.parse_args(argv)

    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import obs as _obs

    _obs.tracer.configure(role="serve", trace_dir=args.trace_dir)
    from paddle_tpu_torch.core.topology import reset_auto_names
    from paddle_tpu_torch.models.seq2seq import Seq2SeqGenerator, seq2seq_cost
    from paddle_tpu_torch.reader.loadgen import OpenLoopLoadGen
    from paddle_tpu_torch.robustness.preemption import PreemptionGuard
    from paddle_tpu_torch.serving import Request, ServingEngine, ServingScheduler

    reset_auto_names()
    cost, _ = seq2seq_cost(
        args.src_vocab, args.trg_vocab,
        word_dim=args.word_dim, hidden_dim=args.hidden_dim,
    )
    params = paddle.parameters.create(cost, seed=args.seed, device=args.device)
    if args.model:
        with open(args.model, "rb") as f:
            params.init_from_tar(f)
    gen = Seq2SeqGenerator(
        params, args.src_vocab, args.trg_vocab,
        word_dim=args.word_dim, hidden_dim=args.hidden_dim,
        max_length=args.max_length, device=args.device,
    )
    engine = ServingEngine(
        gen, device=args.device,
        max_slots=args.max_slots,
        hbm_budget_mb=args.hbm_budget_mb,
        max_new_tokens=args.max_new_tokens,
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        prefix_cache=args.prefix_cache,
        spec_decode=args.spec_decode,
    )

    if args.register:
        return _serve_as_fleet_engine(args, engine)

    session_of = None
    replay_trace = None
    sources = []
    if args.replay:
        # the recorded day IS the workload: prompts/ids/deadlines/
        # sessions/priorities all come from the trace records
        from paddle_tpu_torch.robustness.traces import read_trace

        replay_trace = read_trace(args.replay)
    elif args.requests:
        with open(args.requests) as f:
            sources = [
                [int(t) for t in line.split()] for line in f if line.strip()
            ]
    elif args.prefix_pool > 0:
        from paddle_tpu_torch.reader.loadgen import PrefixMixer

        mixer = PrefixMixer(
            args.src_vocab, pool_size=args.prefix_pool,
            prefix_frac=args.prefix_frac, seed=args.seed,
            sessions=args.sessions,
        )
        sources = [mixer.source(i) for i in range(args.synthetic)]
        if args.sessions > 0:
            session_of = mixer.session_of
    else:
        rng = np.random.RandomState(args.seed)
        sources = [
            rng.randint(2, args.src_vocab, size=rng.randint(3, 24)).tolist()
            for _ in range(args.synthetic)
        ]
    if args.sessions > 0 and session_of is None and replay_trace is None:
        # no prefix pool to correlate with: sessions spread round-robin
        session_of = lambda i: f"sess{i % args.sessions}"  # noqa: E731
    priority_of = None
    if args.priority_every > 0 and replay_trace is None:
        priority_of = (
            lambda i: 0 if i % args.priority_every == 0 else 2
        )

    done = []

    def on_done(r):
        done.append(r)
        print(_json.dumps({
            "req": r.req_id,
            "status": r.status,
            "tokens": r.tokens,
            "error": r.error,
            "latency_ms": round((r.t_done - r.t_submit) * 1e3, 3),
        }), flush=True)

    deadline_s = args.deadline_s
    if replay_trace is not None:
        # replay: every request carries the RECORDED identity — ids,
        # deadlines, sessions, priority classes.  The live flags must
        # not re-derive any of it (the loadgen's stamp-if-absent
        # contract keeps recorded values authoritative).
        reqs = [
            Request(
                list(rec["src"]), rec.get("mnt"),
                req_id=str(rec["id"]), callback=on_done,
                deadline_s=rec.get("dl"), session_id=rec.get("sess"),
                priority=rec.get("prio"),
            )
            for rec in replay_trace.requests()
        ]
    else:
        reqs = [
            Request(src, callback=on_done, deadline_s=deadline_s)
            for src in sources
        ]
    drained_clean = None
    t0 = _time.perf_counter()
    # live metrics export (obs/metrics.py): the SLO gauges the scheduler
    # registers (queue depth, pages in use, predicted wait) + the StatSet
    # ledger, as Prometheus text — file snapshot and/or localhost endpoint
    from paddle_tpu_torch.obs.metrics import MetricsExporter
    from paddle_tpu_torch.utils import flags as _serve_flags

    # --metrics-port 0 forces the endpoint OFF even when the metrics_port
    # flag/env is set (the help's "0 = off"); unset falls through to the
    # flag; a positive port wins outright
    metrics = MetricsExporter(
        path=args.metrics_out,
        port=(None if args.metrics_port is None
              else (args.metrics_port if args.metrics_port > 0 else -1)),
    ) if (
        args.metrics_out or args.metrics_port
        or _serve_flags.get_flag("metrics_out")
        or _serve_flags.get_flag("metrics_port")
    ) else None
    if metrics is not None and metrics.port:
        _echo(f"metrics: http://127.0.0.1:{metrics.port}/metrics")
    writer = None
    if args.record_trace:
        from paddle_tpu_torch.robustness.traces import TraceWriter

        writer = TraceWriter(args.record_trace, meta={
            "cmd": "serve", "seed": args.seed, "rate": args.rate,
            "arrival": args.arrival,
        })
    with PreemptionGuard() as guard:
        sched = ServingScheduler(
            engine, queue_limit=args.queue_limit,
            default_deadline_s=(
                args.deadline_s if args.deadline_s is not None else None
            ),
        )

        def _submit(r):
            # record AFTER the loadgen stamped deadline/session/priority
            # (run() stamps before calling submit), so the trace carries
            # the values the scheduler actually saw
            if writer is not None:
                writer.record_request(r)
            return sched.submit(r)

        try:
            submitted = []
            if replay_trace is not None:
                from paddle_tpu_torch.robustness.traces import TraceReplayLoadGen

                it = iter(reqs)
                submitted = TraceReplayLoadGen(
                    replay_trace,
                    request_factory=lambda rec: next(it),
                ).run(
                    _submit, stop=lambda: guard.triggered,
                    cancel=lambda rid, reason: sched.cancel(
                        rid, reason or "timeout: canceled"),
                )
            elif args.rate > 0:
                submitted = OpenLoopLoadGen(
                    args.rate, len(reqs), lambda i: reqs[i],
                    seed=args.seed, process=args.arrival,
                    session_of=session_of, priority_of=priority_of,
                ).run(_submit, stop=lambda: guard.triggered)
            else:
                for i, r in enumerate(reqs):
                    if guard.triggered:
                        break
                    if session_of is not None:
                        r.session_id = session_of(i)
                    if priority_of is not None:
                        pri = priority_of(i)
                        if pri is not None:
                            r.priority = int(pri)
                    _submit(r)
                    submitted.append(r)
            if guard.triggered:
                # graceful drain: stop admitting, finish what's in flight,
                # leave the untransmitted tail of the schedule unsubmitted
                _echo("draining: SIGTERM/SIGINT — finishing in-flight "
                      f"requests ({len(submitted)} submitted)")
                drained_clean = sched.drain(args.drain_timeout_s)
                reqs = list(submitted)
            else:
                wait_deadline = _time.perf_counter() + args.timeout_s
                for r in reqs:
                    # bounded poll; past the deadline, done() costs zero per
                    # remaining request instead of a full wait() quantum
                    while not r.done():
                        if guard.triggered or (
                            _time.perf_counter() > wait_deadline
                        ):
                            break
                        r.wait(0.2)
                    if guard.triggered:
                        break
                if guard.triggered:
                    drained_clean = sched.drain(args.drain_timeout_s)
        finally:
            sched.close()
            if writer is not None:
                writer.close()
            if metrics is not None:
                metrics.close()
    from paddle_tpu_torch.serving import percentile, status_counts

    # the status ledger is judged AFTER close() (which finalizes every
    # outstanding request), so categories are DISJOINT and sum to total
    wall = _time.perf_counter() - t0
    by_status = status_counts(reqs)
    ok = [r for r in reqs if r.status == "served"]
    tpots = [
        (r.t_done - r.t_admit) / len(r.tokens)
        for r in ok if r.tokens and r.t_admit is not None
    ]

    def pct(xs, p):
        v = percentile(xs, p)
        return None if v is None else round(v * 1e3, 3)

    summary = {
        "served": by_status["served"],
        "shed": by_status["shed"],
        "rejected": by_status["rejected"],
        "timeout": by_status["timeout"],
        "unfinished": by_status["closed"],
        "drained_clean": drained_clean,
        "wall_s": round(wall, 3),
        "sustained_req_per_sec": round(len(ok) / wall, 3) if wall > 0 else None,
        "p50_token_ms": pct(tpots, 0.50),
        "p99_token_ms": pct(tpots, 0.99),
        "engine": engine.summary(),
    }
    class_labels = sorted({r.class_label for r in reqs})
    if len(class_labels) > 1:
        # per-class status ledger — the p0-stays-served-while-p2-sheds
        # evidence the per-class admission plane exists to produce
        summary["classes"] = {
            c: status_counts([r for r in reqs if r.class_label == c])
            for c in class_labels
        }
    if replay_trace is not None:
        summary["replayed_trace"] = args.replay
    if writer is not None:
        summary["recorded_trace"] = args.record_trace
    print(_json.dumps(summary), flush=True)
    if args.stats_out:
        _obs.write_stats_json(args.stats_out, summary)
    _obs.tracer.dump()  # per-process trace file (no-op without trace_dir)
    if drained_clean is not None:
        # SIGTERM path: exit 0 iff the drain finished every in-flight
        # request (no 'closed' stragglers) — the graceful-exit contract
        return 0 if (drained_clean and not by_status["closed"]) else 1
    return 0 if (ok and not by_status["closed"]) else 1


def _serve_as_fleet_engine(args, engine) -> int:
    """The ``serve --register host:port`` mode: this process is
    one FLEET ENGINE — a ServingScheduler wrapped in an EngineAgent that
    registers on the router's heartbeat-lease plane and serves requests
    arriving over the typed wire RPC (serving/router.py).  No local
    workload; SIGTERM drains the scheduler, deregisters, exits 0 on a
    clean drain — the rolling-restart contract.  A crashed step loop (a
    failed CUDA dispatch) ends the process with exit code 1."""
    import json as _json
    import os as _os
    import time as _time

    from paddle_tpu_torch import obs as _obs
    from paddle_tpu_torch.obs.metrics import MetricsExporter
    from paddle_tpu_torch.robustness.preemption import PreemptionGuard
    from paddle_tpu_torch.serving import EngineAgent, ServingScheduler
    from paddle_tpu_torch.utils import flags as _serve_flags

    host, _, port = args.register.rpartition(":")
    if not host or not port.isdigit():
        print(f"--register wants host:port, got {args.register!r}",
              file=sys.stderr)
        return 2
    engine_id = args.engine_id or f"engine-{_os.getpid()}"
    metrics = MetricsExporter(
        path=args.metrics_out,
        port=(None if args.metrics_port is None
              else (args.metrics_port if args.metrics_port > 0 else -1)),
    ) if (
        args.metrics_out or args.metrics_port
        or _serve_flags.get_flag("metrics_out")
        or _serve_flags.get_flag("metrics_port")
    ) else None
    drained_clean = False
    with PreemptionGuard() as guard:
        sched = ServingScheduler(
            engine, queue_limit=args.queue_limit,
            default_deadline_s=args.deadline_s,
        )
        agent = EngineAgent(
            sched, engine_id, (host, int(port)),
            address=("127.0.0.1", args.engine_port),
        )
        # the harness parses this line for identity + data-plane port
        print(_json.dumps({
            "engine_id": engine_id,
            "data_plane": list(agent.address),
            "router": [host, int(port)],
        }), flush=True)
        try:
            while not guard.triggered and sched.crashed is None:
                _time.sleep(0.1)
            if sched.crashed is not None:
                _echo(f"FATAL engine {engine_id}: {sched.crashed}")
            else:
                _echo(f"draining: engine {engine_id} finishing in-flight work")
                drained_clean = sched.drain(args.drain_timeout_s)
        finally:
            agent.close()
            sched.close()
            if metrics is not None:
                metrics.close()
    summary = {
        "engine_id": engine_id,
        "drained_clean": drained_clean,
        "engine": engine.summary(),
    }
    print(_json.dumps(summary), flush=True)
    if args.stats_out:
        _obs.write_stats_json(args.stats_out, summary)
    _obs.tracer.dump()
    return 0 if drained_clean else 1


def cmd_route(argv: List[str]) -> int:
    """``route`` — the serving-fleet router frontend (serving/router.py):
    admission (deadlines, bounded queue, shed) + least-predicted-wait
    dispatch with prefix/session affinity over the engines registered on
    its heartbeat-lease plane (``serve --register``).  With ``--synthetic
    N`` it also DRIVES an open-loop workload through the fleet and prints
    the per-request lines + final summary (the ``serve`` report shape, one
    tier up); with
    ``--synthetic 0`` it routes for external clients until SIGTERM."""
    import json as _json
    import time as _time

    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch route",
        description="SLO-aware affinity-routing fleet frontend "
                    "(serving/router.py)",
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="router RPC port (0 = ephemeral, printed on the "
                    "ready line)")
    ap.add_argument("--journal", default="",
                    help="append-only JSON-lines routing journal; restart "
                    "with the predecessor's journal to refuse re-serving "
                    "its finalized request ids (HA failover)")
    ap.add_argument("--lease-timeout-s", type=float, default=None,
                    help="engine heartbeat lease (default: the "
                    "router_lease_timeout_s flag)")
    ap.add_argument("--queue-limit", type=int, default=None,
                    help="bound on requests inside admission+dispatch "
                    "(default: the router_queue_limit flag; 0 = unbounded)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="default per-request deadline stamped at the "
                    "frontend (default: the serving_default_deadline_s "
                    "flag; 0 = none)")
    ap.add_argument("--no-affinity", action="store_true",
                    help="disable prefix/session affinity (pure "
                    "least-predicted-wait) — the A/B lever for the "
                    "prefix-hit-rate comparison")
    ap.add_argument("--affinity-slack-s", type=float, default=None)
    ap.add_argument("--stats-poll-s", type=float, default=None)
    ap.add_argument("--expect-engines", type=int, default=0,
                    help="wait until N engines hold live leases before "
                    "offering traffic")
    ap.add_argument("--expect-timeout-s", type=float, default=30.0)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="drive N open-loop synthetic requests through the "
                    "fleet; 0 = daemon mode (route for external clients "
                    "until SIGTERM)")
    ap.add_argument("--src-vocab", type=int, default=1000)
    ap.add_argument("--max-new-tokens", type=int, default=None)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop arrival rate (req/s); 0 = submit all "
                    "immediately")
    ap.add_argument("--arrival", default="poisson",
                    choices=["poisson", "uniform", "burst"])
    ap.add_argument("--prefix-pool", type=int, default=0,
                    help="share prompt prefixes across synthetic requests "
                    "(reader/loadgen.PrefixMixer) — what affinity routing "
                    "concentrates per engine")
    ap.add_argument("--prefix-frac", type=float, default=0.5)
    ap.add_argument("--sessions", type=int, default=0,
                    help="stamp session ids from a pool of N "
                    "(PrefixMixer.session_of) — the affinity key")
    ap.add_argument("--priority-every", type=int, default=0,
                    help="stamp every Nth synthetic request interactive "
                    "class p0 and the rest batch class p2; 0 = all p1")
    ap.add_argument("--record-trace", default="", metavar="TRACE",
                    help="record the fleet workload to a replayable .ptt "
                    "request-lifecycle trace (robustness/traces.py)")
    ap.add_argument("--replay", default="", metavar="TRACE",
                    help="replay a recorded .ptt trace through the fleet "
                    "instead of synthetic load (recorded arrivals/ids/"
                    "deadlines/sessions/priorities; --synthetic/--rate "
                    "are ignored; recorded cancels are dropped — the "
                    "fleet client has no cancel RPC)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout-s", type=float, default=120.0,
                    help="wait budget for the synthetic workload")
    ap.add_argument("--stats-out", default="",
                    help="write the summary JSON here too")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--metrics-out", default=None,
                    help="periodic Prometheus snapshot: fleet gauges "
                    "(paddle_tpu_fleet_engines, per-engine queue depth/"
                    "pages/predicted wait) + the fleet request ledger")
    ap.add_argument("--metrics-port", type=int, default=None)
    args = ap.parse_args(argv)

    import numpy as np

    from paddle_tpu_torch import obs as _obs

    _obs.tracer.configure(role="route", trace_dir=args.trace_dir)
    from paddle_tpu_torch.obs.metrics import MetricsExporter
    from paddle_tpu_torch.reader.loadgen import OpenLoopLoadGen, PrefixMixer
    from paddle_tpu_torch.robustness.preemption import PreemptionGuard
    from paddle_tpu_torch.serving import FleetClient, Request, Router
    from paddle_tpu_torch.serving import percentile, status_counts
    from paddle_tpu_torch.utils import flags as _route_flags

    metrics = MetricsExporter(
        path=args.metrics_out,
        port=(None if args.metrics_port is None
              else (args.metrics_port if args.metrics_port > 0 else -1)),
    ) if (
        args.metrics_out or args.metrics_port
        or _route_flags.get_flag("metrics_out")
        or _route_flags.get_flag("metrics_port")
    ) else None
    if metrics is not None and metrics.port:
        _echo(f"metrics: http://127.0.0.1:{metrics.port}/metrics")

    router = Router(
        address=(args.host, args.port),
        journal_path=args.journal or None,
        lease_timeout_s=args.lease_timeout_s,
        queue_limit=args.queue_limit,
        default_deadline_s=args.deadline_s,
        affinity=False if args.no_affinity else None,
        affinity_slack_s=args.affinity_slack_s,
        stats_poll_s=args.stats_poll_s,
    )
    # the harness parses this line for the routing address
    print(_json.dumps({"router": list(router.address)}), flush=True)
    rc = 0
    t0 = _time.perf_counter()
    try:
        with PreemptionGuard() as guard:
            if args.expect_engines > 0:
                deadline = _time.perf_counter() + args.expect_timeout_s
                while (len(router.live_engines()) < args.expect_engines
                       and _time.perf_counter() < deadline
                       and not guard.triggered):
                    _time.sleep(0.05)
                live = len(router.live_engines())
                if live < args.expect_engines:
                    _echo(f"only {live}/{args.expect_engines} engines "
                          "registered before the deadline")
                    return 1
                _echo(f"fleet ready: {live} engine(s)")
            if args.synthetic <= 0 and not args.replay:
                # daemon mode: route until SIGTERM
                while not guard.triggered:
                    _time.sleep(0.1)
                return 0
            mixer = PrefixMixer(
                args.src_vocab,
                pool_size=max(1, args.prefix_pool),
                prefix_frac=args.prefix_frac if args.prefix_pool > 0 else 0.0,
                seed=args.seed, sessions=args.sessions,
            )
            t0 = _time.perf_counter()

            done = []

            def on_done(r):
                done.append(r)
                print(_json.dumps({
                    "req": r.req_id,
                    "status": r.status,
                    "tokens": r.tokens,
                    "error": r.error,
                    "latency_ms": round((r.t_done - r.t_submit) * 1e3, 3),
                }), flush=True)

            replay_trace = None
            if args.replay:
                from paddle_tpu_torch.robustness.traces import read_trace

                replay_trace = read_trace(args.replay)
                reqs = [
                    Request(
                        list(rec["src"]), rec.get("mnt"),
                        req_id=str(rec["id"]), callback=on_done,
                        deadline_s=rec.get("dl"),
                        session_id=rec.get("sess"),
                        priority=rec.get("prio"),
                    )
                    for rec in replay_trace.requests()
                ]
            else:
                reqs = [
                    Request(
                        mixer.source(i), args.max_new_tokens,
                        req_id=f"route-{args.seed}-{i}", callback=on_done,
                        deadline_s=args.deadline_s,
                    )
                    for i in range(args.synthetic)
                ]
            priority_of = None
            if args.priority_every > 0 and replay_trace is None:
                priority_of = (
                    lambda i: 0 if i % args.priority_every == 0 else 2
                )
            writer = None
            if args.record_trace:
                from paddle_tpu_torch.robustness.traces import TraceWriter

                writer = TraceWriter(args.record_trace, meta={
                    "cmd": "route", "seed": args.seed, "rate": args.rate,
                    "arrival": args.arrival,
                })
            fc = FleetClient(router.address)

            def _submit(r):
                if writer is not None:
                    writer.record_request(r)
                return fc.submit(r)

            try:
                if replay_trace is not None:
                    from paddle_tpu_torch.robustness.traces import (
                        TraceReplayLoadGen,
                    )

                    it = iter(reqs)
                    TraceReplayLoadGen(
                        replay_trace,
                        request_factory=lambda rec: next(it),
                    ).run(_submit, stop=lambda: guard.triggered)
                elif args.rate > 0:
                    OpenLoopLoadGen(
                        args.rate, len(reqs), lambda i: reqs[i],
                        seed=args.seed, process=args.arrival,
                        session_of=mixer.session_of,
                        priority_of=priority_of,
                    ).run(_submit, stop=lambda: guard.triggered)
                else:
                    for i, r in enumerate(reqs):
                        if guard.triggered:
                            break
                        sid = mixer.session_of(i)
                        if sid is not None:
                            r.session_id = sid
                        if priority_of is not None:
                            pri = priority_of(i)
                            if pri is not None:
                                r.priority = int(pri)
                        _submit(r)
                wait_deadline = _time.perf_counter() + args.timeout_s
                for r in reqs:
                    while not r.done():
                        if guard.triggered or (
                            _time.perf_counter() > wait_deadline
                        ):
                            break
                        r.wait(0.2)
                    if guard.triggered:
                        break
            finally:
                fc.close()
                if writer is not None:
                    writer.close()
    finally:
        fleet = router.fleet_stats()
        router.close()
        if metrics is not None:
            metrics.close()
    wall = _time.perf_counter() - t0
    by_status = status_counts(r for r in reqs if r.done())
    ok = [r for r in reqs if r.status == "served"]
    lats = sorted(
        (r.t_done - r.t_submit) * 1e3
        for r in ok if r.t_done is not None and r.t_submit is not None
    )

    def pct(p):
        v = percentile(lats, p)
        return None if v is None else round(v, 3)

    summary = {
        "served": by_status["served"],
        "shed": by_status["shed"],
        "rejected": by_status["rejected"],
        "timeout": by_status["timeout"],
        "unfinished": len(reqs) - sum(by_status.values()),
        "wall_s": round(wall, 3),
        "sustained_req_per_sec": (
            round(len(ok) / wall, 3) if wall > 0 else None
        ),
        "p50_latency_ms": pct(0.50),
        "p95_latency_ms": pct(0.95),
        "p99_latency_ms": pct(0.99),
        "fleet": fleet,
    }
    class_labels = sorted({r.class_label for r in reqs})
    if len(class_labels) > 1:
        summary["classes"] = {
            c: status_counts(r for r in reqs if r.class_label == c)
            for c in class_labels
        }
    print(_json.dumps(summary), flush=True)
    if args.stats_out:
        _obs.write_stats_json(args.stats_out, summary)
    _obs.tracer.dump()
    return rc if (ok or (args.synthetic <= 0 and not args.replay)) else 1


def cmd_scenario(argv: List[str]) -> int:
    """``scenario`` — the production-gate scenario harness
    (robustness/scenarios.py): run named mixed-traffic/chaos scenarios and
    print one JSON metrics line each (p50/p95/p99, goodput under the SLO,
    shed/reject/timeout counts, recovery time after a fault).  Exit 0 only
    when every requested scenario passed its gates."""
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch scenario",
        description="mixed-traffic SLO + chaos scenario harness (robustness/scenarios.py)")
    ap.add_argument("--name", action="append", default=[],
                    help="scenario to run (repeatable); see --list")
    ap.add_argument("--all-fast", action="store_true",
                    help="run every fast (in-process) scenario")
    ap.add_argument("--list", action="store_true", dest="list_",
                    help="list known scenarios and exit")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="end-to-end SLO override (default: the scenario_slo_ms flag, else "
                    "derived from measurement)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None,
                    help="scratch dir for fleet scenarios (default: a temp dir)")
    ap.add_argument("--out", default="",
                    help="append one JSON line per scenario here too")
    ap.add_argument("--trace", action="store_true",
                    help="run with span tracing armed and merge every process's trace file "
                    "into one Perfetto-loadable timeline per scenario (subprocess fleets "
                    "inherit the trace dir through the environment)")
    ap.add_argument("--trace-dir", default=None,
                    help="where the per-process and merged trace files land (default: a "
                    "temp dir; implies --trace)")
    ap.add_argument("--device", default=None,
                    help="torch device of the serving engines (default: the card; 'cpu' "
                    "asks for the CPU); fleet drills pass it to every engine process")
    args = ap.parse_args(argv)

    from paddle_tpu_torch.robustness import scenarios as _sc

    if args.list_:
        for n in sorted(_sc.FAST_SCENARIOS):
            print(f"{n}  (fast)")
        for n in sorted(_sc.SLOW_SCENARIOS):
            print(f"{n}  (slow: spawns a worker fleet)")
        return 0
    names = list(args.name)
    if args.all_fast:
        names.extend(n for n in _sc.FAST_SCENARIOS if n not in names)
    if not names:
        print("error: give --name (repeatable), --all-fast, or --list", file=sys.stderr)
        return 2
    device = _cli_device(args.device)
    if device is None:
        return 1
    import tempfile

    from paddle_tpu_torch import obs as _obs

    trace_dir = None
    if args.trace or args.trace_dir:
        trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="paddle-tpu-torch-trace-")
        os.makedirs(trace_dir, exist_ok=True)
        os.environ.setdefault("PADDLE_TPU_TORCH_TRACE_ID", _obs.tracer.trace_id)
    failed = []
    for name in names:
        kw = {"seed": args.seed, "device": device}
        if args.slo_ms is not None:
            kw["slo_ms"] = args.slo_ms
        if name in _sc.SLOW_SCENARIOS:
            kw["workdir"] = args.workdir or tempfile.mkdtemp(
                prefix=f"paddle-tpu-torch-scenario-{name}-")
        if trace_dir is not None:
            from paddle_tpu_torch.utils import flags as _flags

            # one subdirectory per scenario and the parent's rings reset, so
            # that scenario N's merged timeline holds its own events only
            sdir = os.path.join(trace_dir, name)
            os.makedirs(sdir, exist_ok=True)
            _flags.set_flag("trace_dir", sdir)
            os.environ["PADDLE_TPU_TORCH_TRACE_DIR"] = sdir
            _obs.tracer.reset()
            _obs.tracer.configure(role="serve", trace_dir=sdir)
        res = _sc.run_scenario(name, **kw)
        res.pop("_requests", None)
        if trace_dir is not None:
            from paddle_tpu_torch.obs.merge import merge_dir

            _obs.tracer.dump()
            merged, mpath = merge_dir(os.path.join(trace_dir, name),
                                      out_path=os.path.join(trace_dir, f"merged-{name}.json"))
            res["trace"] = {
                "merged": mpath,
                "events": sum(1 for e in merged["traceEvents"] if e.get("ph") != "M"),
                "pids": merged["otherData"]["merged_pids"],
                "planes": sorted({e.get("cat") for e in merged["traceEvents"]
                                  if e.get("ph") != "M" and e.get("cat")}),
            }
        line = json.dumps(res)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        if not res.get("passed"):
            failed.append(name)
    if failed:
        print(f"SCENARIO FAILURES: {failed}", file=sys.stderr)
    return 1 if failed else 0


def cmd_fuzz(argv: List[str]) -> int:
    """Coverage-guided chaos-composition fuzzer (robustness/fuzz.py).

    Samples seeded compositions of the fault vocabulary — arrival process x
    rate factor, serving chaos (nan_request, serve_slow_client), network
    emulation (delay/drop/dup/corrupt/partition), training chaos
    (worker_hang), torn checkpoints — runs each against the serving,
    training and checkpoint planes in-process, and checks the invariant set
    (disjoint status ledger, bit-identical training parameters, journal
    lint, page and thread leaks, armed-chaos consultation, restore past a
    torn checkpoint).

    * default: ``--count`` seeded compositions; composition i draws from
      ``Random(f"{seed}:{i}")``, so any run replays exactly;
    * --plant NAME: plant a known bug (the canary ``ledger_skew``) to prove
      the harness detects, shrinks and replays;
    * --replay SPEC.json: re-run a shrunk violation spec; exit 0 iff the
      violation reproduces.

    Exit code: 0 = clean (or the replay reproduced), 1 = a violation was
    found (or the replay did not reproduce).  A violation is ddmin-shrunk to
    a minimal replayable spec, printed, and written to ``--out``.
    """
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch fuzz",
                                 description=cmd_fuzz.__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--count", type=int, default=25,
                    help="number of seeded compositions (default 25)")
    ap.add_argument("--seed", type=int, default=0,
                    help="batch seed; composition i uses Random(f'{seed}:{i}')")
    ap.add_argument("--requests", type=int, default=16,
                    help="serving requests offered per composition")
    ap.add_argument("--plant", default=None,
                    help="plant a known bug as a harness canary (e.g. ledger_skew)")
    ap.add_argument("--no-shrink", action="store_true",
                    help="skip ddmin shrinking of a found violation")
    ap.add_argument("--replay", default=None, metavar="SPEC",
                    help="re-run a shrunk violation spec JSON file")
    ap.add_argument("--out", default=None, metavar="SPEC",
                    help="write the shrunk violation spec here")
    ap.add_argument("--device", default=None,
                    help="torch device of the serving engine (default: the card; 'cpu' "
                    "asks for the CPU)")
    args = ap.parse_args(argv)

    import tempfile

    from paddle_tpu_torch.robustness import fuzz as _fz

    device = _cli_device(args.device)
    if device is None:
        return 1
    # fault cocktails make every plane log its injected failures: noise at
    # batch scale, so keep only real errors
    logging.getLogger("paddle_tpu_torch").setLevel(logging.ERROR)
    workdir = tempfile.mkdtemp(prefix="paddle-tpu-torch-fuzz-")
    if args.replay:
        spec = _fz.load_spec(args.replay)
        out = _fz.replay_fuzz_spec(spec, workdir=workdir, device=device)
        if out["reproduced"]:
            print("reproduced:")
            for v in out["violations"]:
                print(f"  {v}")
            return 0
        print("spec did NOT reproduce (clean run, no violation)", file=sys.stderr)
        return 1

    res = _fz.fuzz_batch(
        count=args.count, seed=args.seed, workdir=workdir, planted=args.plant,
        shrink=not args.no_shrink, n_requests=args.requests,
        log=lambda m: _echo(f"fuzz: {m}"), device=device,
    )
    if not res["violation_found"]:
        print(f"clean: {res['compositions_run']} compositions (seed {args.seed}), no violation")
        return 0
    spec = res["spec"]
    print(f"VIOLATION after {res['compositions_run']} compositions, "
          f"shrunk to {len(spec['items'])} item(s):")
    for v in spec["violations"]:
        print(f"  {v}")
    print(json.dumps(spec, indent=2, sort_keys=True))
    if args.out:
        _fz.save_spec(spec, args.out)
        print(f"spec written to {args.out} "
              f"(replay: python -m paddle_tpu_torch fuzz --replay {args.out})")
    return 1


def cmd_explore(argv: List[str]) -> int:
    """``explore`` — the deterministic interleaving explorer over the
    distributed planes (analysis/interleave.py).

    Drives the REAL state machines (the serving router, the journaled
    master, the HA lease file) in-process on a virtual clock with a
    simulated transport, searching event interleavings for
    protocol-invariant violations (double-serve, epoch-fence breach,
    recovery infidelity).  Host code only: it needs no card.

    * default: seeded-random exploration (``--schedules`` independent
      schedules; schedule i draws from ``Random(f"{seed}:{i}")``, so any
      run replays exactly);
    * --dfs-depth N: additionally sweep every interleaving up to depth N
      (bounded DFS, first ``--dfs-branch`` enabled events per state);
    * --plant NAME: plant a known bug (canary) to prove the harness
      detects, shrinks, and replays — e.g. ``double_serve``;
    * --replay SPEC.json: re-run a shrunk violation spec; exit 0 iff the
      violation reproduces (the regression-test contract).

    Exit code: 0 = clean (or replay reproduced), 1 = violation found (or
    replay failed to reproduce).  A found violation is ddmin-shrunk to a
    minimal replayable spec, printed, and written to ``--out``.  Specs are
    the JAX package's: either package replays the other's."""
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch explore",
                                 description=cmd_explore.__doc__)
    ap.add_argument("--model", default="router", choices=["router", "master", "ha"],
                    help="which state machine to drive (default router)")
    ap.add_argument("--schedules", type=int, default=200,
                    help="number of seeded-random schedules (default 200)")
    ap.add_argument("--seed", type=int, default=0,
                    help="batch seed; schedule i uses Random(f'{seed}:{i}')")
    ap.add_argument("--max-events", type=int, default=14,
                    help="events per random schedule (default 14)")
    ap.add_argument("--dfs-depth", type=int, default=0,
                    help="also run bounded DFS to this depth (0 = skip)")
    ap.add_argument("--dfs-branch", type=int, default=5,
                    help="DFS branch limit per state (default 5)")
    ap.add_argument("--plant", default=None,
                    help="plant a known bug as a harness canary (e.g. double_serve)")
    ap.add_argument("--replay", default=None, metavar="SPEC",
                    help="re-run a shrunk violation spec JSON file")
    ap.add_argument("--out", default=None, metavar="SPEC",
                    help="write the shrunk violation spec here")
    args = ap.parse_args(argv)

    import shutil
    import tempfile

    from paddle_tpu_torch.analysis.interleave import (
        dfs_explore, explore_schedules, make_model, replay_spec,
    )

    # fault injection makes the router log every simulated transport
    # failure — noise at batch scale, so keep only real errors
    logging.getLogger("paddle_tpu_torch").setLevel(logging.ERROR)

    if args.replay:
        with open(args.replay, "r", encoding="utf-8") as fh:
            spec = json.load(fh)
        out = replay_spec(spec)
        if out["reproduced"]:
            print(f"reproduced ({out['applied']} events applied):")
            for v in out["violations"]:
                print(f"  {v}")
            return 0
        print(f"spec did NOT reproduce ({out['applied']} events applied, no violation)",
              file=sys.stderr)
        return 1

    workdir = tempfile.mkdtemp(prefix="paddle-tpu-torch-explore-")
    model = make_model(args.model, workdir, planted=args.plant)
    try:
        res = explore_schedules(model, schedules=args.schedules, seed=args.seed,
                                max_events=args.max_events)
        if not res["violation_found"] and args.dfs_depth > 0:
            dres = dfs_explore(model, depth=args.dfs_depth, branch_limit=args.dfs_branch)
            print(f"dfs: {dres['paths_run']} paths to depth {args.dfs_depth}")
            if dres["violation_found"]:
                res = {"violation_found": True, "schedules_run": res["schedules_run"],
                       "spec": dres["spec"]}
        if not res["violation_found"]:
            print(f"clean: {res['schedules_run']} schedules on model {args.model!r} "
                  f"(seed {args.seed}), no violation")
            return 0
        spec = res["spec"]
        print(f"VIOLATION on model {args.model!r} after {res['schedules_run']} schedules, "
              f"shrunk to {len(spec['events'])} events:")
        for v in spec["violations"]:
            print(f"  {v}")
        print(json.dumps(spec, indent=2, sort_keys=True))
        if args.out:
            with open(args.out, "w", encoding="utf-8") as fh:
                json.dump(spec, fh, indent=2, sort_keys=True)
            print(f"spec written to {args.out} "
                  f"(replay: python -m paddle_tpu_torch explore --replay {args.out})")
        return 1
    finally:
        model.close()
        shutil.rmtree(workdir, ignore_errors=True)


def cmd_cache(argv: List[str]) -> int:
    """``cache`` — the persistent build store (core/aot_cache.py), the JAX
    package's ``cache`` over the port's native libraries:

    * ``ls``               — entries with size, key and build provenance;
    * ``warm``             — prewarm: parse a config, walk its feed, and
                             resolve the train step's rung for every
                             distinct batch shape (building or loading each
                             native library the step launches there), so
                             that later boots run no compiler;
    * ``prune --max-mb N`` — drop the oldest entries until the store fits;
    * ``clear``            — drop everything.

    Each run ends with one JSON summary line (the store's counters and the
    StatSet's ``aot_cache/{hit,miss,stale,corrupt}``)."""
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch cache",
        description="persistent build cache maintenance (core/aot_cache.py)",
    )
    ap.add_argument("action", choices=["ls", "warm", "prune", "clear"])
    ap.add_argument("--dir", required=True, help="cache directory")
    ap.add_argument("--config", default=None,
                    help="warm: v1 config file whose train step to prewarm")
    ap.add_argument("--config_args", default="")
    ap.add_argument("--batch_size", type=int, default=0,
                    help="warm: override the config's batch size")
    ap.add_argument("--max-shapes", type=int, default=16,
                    help="warm: stop after this many distinct batch shapes")
    ap.add_argument("--max-mb", type=float, default=None,
                    help="prune: keep the store under this many MB")
    ap.add_argument("--device", default=None,
                    help="warm: the trainer's device (default: the card)")
    args = ap.parse_args(argv)

    from paddle_tpu_torch.core.aot_cache import AOTCache

    if args.action == "ls":
        cache = AOTCache(args.dir)
        for e in cache.entries():
            key = e.get("key", {})
            prov = ", ".join(
                f"{k}={key[k]}" for k in
                ("kind", "name", "torch", "cuda", "device_name", "capability")
                if key.get(k) is not None
            )
            if e.get("compiler"):
                prov += f", compiler={e['compiler']}, build_s={e['build_s']:.2f}"
            print(f"{e['file']}  {e['bytes'] / 1e6:8.2f} MB  "
                  + (f"CORRUPT: {e['corrupt']}" if "corrupt" in e else prov))
        print(json.dumps(cache.summary()))
        return 0
    if args.action == "clear":
        cache = AOTCache(args.dir)
        n = cache.clear()
        print(json.dumps({**cache.summary(), "removed": n}))
        return 0
    if args.action == "prune":
        if args.max_mb is None:
            print("error: prune needs --max-mb", file=sys.stderr)
            return 2
        cache = AOTCache(args.dir)
        removed = cache.prune(int(args.max_mb * 1e6))
        print(json.dumps({**cache.summary(), "removed": removed}))
        return 0

    # warm: resolve every distinct shape the config's feed realizes
    if not args.config:
        print("error: warm needs --config", file=sys.stderr)
        return 2
    from paddle_tpu_torch.core.batch import batch_shape_key
    from paddle_tpu_torch.utils import flags as _flags
    from paddle_tpu_torch.v1_compat import make_batched_reader, parse_config

    device = _cli_device(args.device)
    if device is None:
        return 1
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    _flags.set_flag("aot_cache_dir", args.dir)
    if _flags.get_flag("compute_dtype"):
        from paddle_tpu_torch.core.compiler import set_default_compute_dtype

        set_default_compute_dtype(_flags.get_flag("compute_dtype"))
    config_path = os.path.abspath(args.config)
    parsed = parse_config(config_path, args.config_args)
    if args.batch_size:
        parsed.settings.batch_size = args.batch_size
    trainer = _make_trainer(parsed, _flags.get_flag("seed"), device)
    reader = make_batched_reader(parsed, os.path.dirname(config_path),
                                 parsed.settings.batch_size, train=True)
    feeder = trainer._make_feeder(parsed.feeding)
    seen = set()
    t0 = time.time()
    for raw in reader():
        # shapes from the host conversion: a rung's resolution reads shapes
        # only, so no batch is copied to the device
        host = feeder.convert(raw)
        key = batch_shape_key(host)
        if key in seen:
            continue
        seen.add(key)
        trainer.warm_compile(host)
        if len(seen) >= args.max_shapes:
            break
    print(json.dumps({
        **trainer._aot_cache.summary(),
        "config": args.config,
        "shapes": len(seen),
        "warm_s": round(time.time() - t0, 3),
    }))
    return 0


# the JAX package's subcommands still waiting for their port: none
_NOT_PORTED: tuple = ()


def _not_ported(name: str):
    def cmd(argv: List[str]) -> int:
        raise NotImplementedError(
            f"the {name!r} subcommand is not ported yet (ROADMAP Queue 1); see "
            "`python -m paddle_tpu_torch --help` for the ported ones")

    return cmd


_COMMANDS = {"train": cmd_train, "version": cmd_version, "dump_config": cmd_dump_config,
             "make_diagram": cmd_make_diagram, "merge_model": cmd_merge_model,
             "plotcurve": cmd_plotcurve, "lint": cmd_lint, "trace": cmd_trace,
             "master": cmd_master, "worker": cmd_worker, "serve": cmd_serve,
             "route": cmd_route, "scenario": cmd_scenario, "fuzz": cmd_fuzz,
             "explore": cmd_explore, "cache": cmd_cache,
             **{name: _not_ported(name) for name in _NOT_PORTED}}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m paddle_tpu_torch <command> [<flags>]")
        print("commands:")
        print("    train             train/test/time/checkgrad a v1 config (--job=...;")
        print("                      on the card unless --device=cpu)")
        print("    version           print version + device info")
        print("    dump_config       print the resolved topology of a config")
        print("    make_diagram      write a Graphviz diagram of a config")
        print("    merge_model       bundle config + parameters into one file")
        print("    plotcurve         plot training curves from a log")
        print("    lint              static analysis: self-lint the package")
        print("                      (rules A###), graph-lint a config (--config),")
        print("                      verify a master journal (--journal), lock")
        print("                      discipline (--concurrency), protocol")
        print("                      conformance (--protocol), traced steps'")
        print("                      in-place updates (--donation) and")
        print("                      precision (--numerics [--certify])")
        print("    trace             merge/validate span-timeline files")
        print("    master            run an HA master candidate (elastic")
        print("                      scale-out: registry + shard leases)")
        print("    worker            run one elastic trainer process against")
        print("                      a master discovery directory")
        print("    serve             serve the NMT model under the SLO scheduler")
        print("                      (--register host:port: a fleet engine)")
        print("    route             run the serving-fleet router")
        print("    scenario          mixed-traffic SLO + chaos scenarios (--list;")
        print("                      on the card unless --device=cpu)")
        print("    fuzz              chaos-composition fuzzer (--count/--seed/")
        print("                      --plant/--replay; on the card unless --device=cpu)")
        print("    explore           interleaving explorer over the router, master")
        print("                      and HA lease state machines (--model/--schedules/")
        print("                      --dfs-depth/--plant/--replay)")
        print("    cache             persistent build cache: ls, warm (--config;")
        print("                      on the card unless --device=cpu), prune, clear")
        if _NOT_PORTED:
            print("not ported yet: " + ", ".join(_NOT_PORTED))
        return 0 if argv else 1
    cmd, rest = argv[0], argv[1:]
    if cmd not in _COMMANDS:
        print(f"unknown command {cmd!r}; try --help", file=sys.stderr)
        return 1
    return _COMMANDS[cmd](rest)


if __name__ == "__main__":
    sys.exit(main())
