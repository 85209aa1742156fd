"""``python -m paddle_tpu_torch <command>`` — the counterpart of
``paddle_tpu/cli.py``, with its ``master`` and ``worker`` subcommands (an HA
master candidate of the elastic cluster plane, and one elastic trainer
process) and its ``serve`` and ``route`` subcommands (one serving engine
under the SLO scheduler, or a fleet engine with ``--register``; the fleet
router).  Every other subcommand of the JAX package's CLI raises
``NotImplementedError`` (ROADMAP Queue 1 item 7)."""

from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import List, Optional

__all__ = ["main", "cmd_master", "cmd_worker", "cmd_serve", "cmd_route"]


def _echo(msg: str) -> None:
    print(msg, flush=True)


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
        time.sleep(0.2)
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


# the JAX package's other subcommands, each waiting for its port
_NOT_PORTED = ("train", "version", "dump_config", "make_diagram", "merge_model",
               "plotcurve", "lint", "explore", "fuzz", "cache", "scenario", "trace")


def _not_ported(name: str):
    def cmd(argv: List[str]) -> int:
        raise NotImplementedError(
            f"the {name!r} subcommand is not ported yet (ROADMAP Queue 1 item 7); "
            "the port's CLI has 'master', 'worker', 'serve' and 'route'")

    return cmd


_COMMANDS = {"master": cmd_master, "worker": cmd_worker, "serve": cmd_serve,
             "route": cmd_route,
             **{name: _not_ported(name) for name in _NOT_PORTED}}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m paddle_tpu_torch <command> [<flags>]")
        print("commands:")
        print("    master            run an HA master candidate (elastic")
        print("                      scale-out: registry + shard leases)")
        print("    worker            run one elastic trainer process against")
        print("                      a master discovery directory")
        print("    serve             serve the NMT model under the SLO scheduler")
        print("                      (--register host:port: a fleet engine)")
        print("    route             run the serving-fleet router")
        print("not ported yet: " + ", ".join(_NOT_PORTED))
        return 0 if argv else 1
    cmd, rest = argv[0], argv[1:]
    if cmd not in _COMMANDS:
        print(f"unknown command {cmd!r}; try --help", file=sys.stderr)
        return 1
    return _COMMANDS[cmd](rest)


if __name__ == "__main__":
    sys.exit(main())
