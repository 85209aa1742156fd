"""Multi-host cluster launcher — the counterpart of
``paddle_tpu/launcher.py``, the replacement for the reference's fabric/ssh
job pusher (paddle/scripts/cluster_train/paddle.py).

The launcher computes each worker's environment (coordinator address,
process id and count under the ``PADDLE_TPU_TORCH_`` prefix) and starts
one Python per host: locally through subprocess, remotely through ssh.
Its elastic mode (``launch(elastic=True)``) runs a fleet of
``python -m paddle_tpu_torch.trainer.elastic`` workers, where a dying
worker is tolerated because the master requeues its leases.
:func:`init_cluster`, which joins a process group for a device mesh,
waits for the mesh (ROADMAP Queue 1 item 6) and raises.

    python -m paddle_tpu_torch.launcher --hosts localhost,localhost \
        --coordinator localhost:8476 --elastic worker.py --args...
"""

from __future__ import annotations

import argparse
import shlex
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

ENV_COORD = "PADDLE_TPU_TORCH_COORDINATOR"
ENV_NPROC = "PADDLE_TPU_TORCH_NUM_PROCESSES"
ENV_PROC_ID = "PADDLE_TPU_TORCH_PROCESS_ID"


def init_cluster(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
):
    """Join a multi-process group for a device mesh: not ported yet (the
    mesh is ROADMAP Queue 1 item 6).  Elastic fleets need no group: they
    meet through the master."""
    raise NotImplementedError(
        "launcher.init_cluster (a process group over a device mesh) is not ported yet "
        "(ROADMAP Queue 1 item 6); elastic fleets coordinate through the master")


def build_worker_env(
    coordinator: str, num_processes: int, process_id: int
) -> Dict[str, str]:
    """Environment fragment for one worker process."""
    return {
        ENV_COORD: coordinator,
        ENV_NPROC: str(num_processes),
        ENV_PROC_ID: str(process_id),
    }


def build_commands(
    hosts: Sequence[str],
    coordinator: str,
    script: str,
    script_args: Sequence[str] = (),
    python: str = sys.executable,
    workdir: Optional[str] = None,
    extra_env: Optional[Dict[int, Dict[str, str]]] = None,
) -> List[List[str]]:
    """One command per host: local hosts (localhost/127.0.0.1) run directly,
    remote hosts through ssh with the env inlined — the reference pushed
    jobs with fabric the same way (cluster_train/paddle.py job_start).

    ``extra_env``: per-process-id environment additions — how a chaos drill
    arms a fault point (e.g. ``PADDLE_TPU_TORCH_CHAOS=kill_worker@2``) on worker
    k of N and nowhere else."""
    cmds: List[List[str]] = []
    for pid, host in enumerate(hosts):
        env = build_worker_env(coordinator, len(hosts), pid)
        env.update((extra_env or {}).get(pid, {}))
        assignments = [f"{k}={v}" for k, v in env.items()]
        base = [python, script, *script_args]
        if host in ("localhost", "127.0.0.1"):
            cmds.append(["env", *assignments, *base])
        else:
            remote = " ".join(
                ["cd", shlex.quote(workdir or "."), "&&", "env"]
                + assignments
                + [shlex.quote(c) for c in base]
            )
            cmds.append(["ssh", host, remote])
    return cmds


def launch(
    hosts: Sequence[str],
    coordinator: str,
    script: str,
    script_args: Sequence[str] = (),
    workdir: Optional[str] = None,
    poll_interval: float = 0.2,
    elastic: bool = False,
    extra_env: Optional[Dict[int, Dict[str, str]]] = None,
    exit_codes: Optional[List[int]] = None,
    sleep=time.sleep,
) -> int:
    """Start every worker and wait.

    Default (gang) mode: the first worker to exit NONZERO kills the rest
    (the reference fabric launcher tears the job down on first failure
    too); returns the first nonzero exit code.

    ``elastic=True`` (the lease-based membership mode): a dying worker is
    the EXPECTED failure case, not the job's — survivors keep running, the
    master requeues the dead worker's shard leases, and the launcher simply
    waits for everyone.  Returns 0 when at least one worker finished
    cleanly, else the first nonzero code.  ``exit_codes`` (when given) is
    extended with every worker's return code in process-id order, so a
    chaos harness can assert the kill actually landed."""
    procs = [
        subprocess.Popen(cmd)
        for cmd in build_commands(
            hosts, coordinator, script, script_args, workdir=workdir,
            extra_env=extra_env,
        )
    ]
    rc = 0
    try:
        if elastic:
            for p in procs:
                p.wait()
            codes = [p.returncode or 0 for p in procs]
            rc = 0 if any(c == 0 for c in codes) else next(
                (c for c in codes if c), 0
            )
        else:
            while rc == 0 and any(p.poll() is None for p in procs):
                rc = next(
                    (p.poll() for p in procs if p.poll() not in (None, 0)), 0
                )
                if rc == 0:
                    sleep(poll_interval)
            if rc:  # tear the job down on first failure
                for p in procs:
                    if p.poll() is None:
                        p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
                rc = rc or (p.returncode or 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        if exit_codes is not None:
            exit_codes.extend(p.returncode or 0 for p in procs)
    return rc


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.launcher",
        description="Launch one SPMD training process per host.",
    )
    ap.add_argument("--hosts", required=True, help="comma-separated host list")
    ap.add_argument(
        "--coordinator",
        required=True,
        help="host:port of the coordinator (process 0)",
    )
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--dry-run", action="store_true", help="print commands only")
    ap.add_argument(
        "--elastic", action="store_true",
        help="lease-based membership: a dying worker is tolerated (its "
        "shard leases requeue via the master) instead of tearing down the "
        "job",
    )
    ap.add_argument("script")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    hosts = [h.strip() for h in args.hosts.split(",") if h.strip()]
    if args.dry_run:
        for cmd in build_commands(
            hosts, args.coordinator, args.script, args.script_args, workdir=args.workdir
        ):
            print(" ".join(shlex.quote(c) for c in cmd))
        return 0
    return launch(
        hosts, args.coordinator, args.script, args.script_args,
        workdir=args.workdir, elastic=args.elastic,
    )


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
