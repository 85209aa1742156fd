"""``python -m paddle_tpu_torch <command>`` — the counterpart of
``paddle_tpu/cli.py``, with its ``master`` and ``worker`` subcommands: an HA
master candidate of the elastic cluster plane, and one elastic trainer
process.  Every other subcommand of the JAX package's CLI raises
``NotImplementedError`` (ROADMAP Queue 1 item 7)."""

from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import List, Optional

__all__ = ["main", "cmd_master", "cmd_worker"]


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


# the JAX package's other subcommands, each waiting for its port
_NOT_PORTED = ("train", "version", "dump_config", "make_diagram", "merge_model",
               "plotcurve", "lint", "explore", "fuzz", "cache", "serve", "route",
               "scenario", "trace")


def _not_ported(name: str):
    def cmd(argv: List[str]) -> int:
        raise NotImplementedError(
            f"the {name!r} subcommand is not ported yet (ROADMAP Queue 1 item 7); "
            "the port's CLI has 'master' and 'worker'")

    return cmd


_COMMANDS = {"master": cmd_master, "worker": cmd_worker,
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
        print("not ported yet: " + ", ".join(_NOT_PORTED))
        return 0 if argv else 1
    cmd, rest = argv[0], argv[1:]
    if cmd not in _COMMANDS:
        print(f"unknown command {cmd!r}; try --help", file=sys.stderr)
        return 1
    return _COMMANDS[cmd](rest)


if __name__ == "__main__":
    sys.exit(main())
