"""Master high availability: leader election + hot standby failover.

Reference: the Go master wins leadership through an etcd campaign, keeps it
with a lease, snapshots its queues into etcd, and a standby that wins the
next campaign recovers from the snapshot while clients re-resolve the
master address from etcd (go/master/etcd_client.go).

etcd-free equivalent over shared storage (the fleet's coordinator hosts
share a filesystem): leadership is a LEASE FILE renewed by mtime heartbeat,
takeover is an atomic rename of a claim file, the queue snapshot is the
Service's existing JSON file, and the leader publishes its RPC address in
an endpoint file clients poll — the same four etcd roles (campaign, lease,
state, discovery), one directory.

Warm standby (the journaled state plane of master.py/master_journal.py):
while a candidate loses the campaign it TAILS the leader's snapshot +
append-only journal into an in-memory replica Service, applying each
CRC-verified record as it lands.  Winning the next campaign is then
``promote()`` — refresh lease deadlines, compact into a generation this
instance owns, publish the endpoint — not a restart: task leases stay
warm, per-task result payloads survive, and a failover mid-pass completes
the pass with ZERO recomputed tasks.  ``last_takeover`` records the
takeover span and how many journal records the replica replayed — the
recovery-time-after-fault metrics the failover bench commits.

    ha = HAMaster(dir, patterns)      # every candidate host runs this
    ha.start()                        # blocks until leader OR standby-watch
    ...
    client = HAClient(dir)            # discovers + follows the leader
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, Optional, Sequence

from paddle_tpu_torch import master_journal as _mj
from paddle_tpu_torch import master_wire as _wire
from paddle_tpu_torch.master import Client, MasterRPCError, Server, Service

__all__ = ["LeaseFile", "HAMaster", "HAClient", "discover_endpoint"]

_log = logging.getLogger("paddle_tpu_torch.master_ha")


class LeaseFile:
    """Heartbeat-lease leader election in a directory.

    The leader owns ``leader.lease`` and renews its mtime; a candidate may
    claim leadership only when the lease is missing or stale (now - mtime >
    lease_timeout).  Claims go through an exclusively-created claim file +
    atomic rename so two candidates racing for a stale lease cannot both
    win (the one whose rename lands second just overwrites with its own
    identity and the loser detects the foreign owner on verify).

    ``clock``/``sleep`` are injectable (for deterministic tests):
    staleness is judged against ``clock()`` and every heartbeat/claim stamps
    the file's mtime from the same clock, so lease-expiry tests advance a
    fake clock instead of sleeping real wall time."""

    def __init__(
        self,
        dir_: str,
        owner_id: str,
        lease_timeout: float = 5.0,
        clock=time.time,
        sleep=time.sleep,
    ):
        self.dir = dir_
        self.owner_id = owner_id
        self.lease_timeout = lease_timeout
        self._clock = clock
        self._sleep = sleep
        self.path = os.path.join(dir_, "leader.lease")
        os.makedirs(dir_, exist_ok=True)

    # -- inspection ------------------------------------------------------
    def current_owner(self) -> Optional[str]:
        try:
            with open(self.path) as f:
                return json.load(f)["owner"]
        except (OSError, ValueError, KeyError):
            return None

    def is_stale(self) -> bool:
        try:
            return self._clock() - os.path.getmtime(self.path) > self.lease_timeout
        except OSError:
            return True  # missing == stale

    def held_by_me(self) -> bool:
        return self.current_owner() == self.owner_id and not self.is_stale()

    # -- campaign --------------------------------------------------------
    def try_acquire(self) -> bool:
        if not self.is_stale():
            return self.current_owner() == self.owner_id
        claim = os.path.join(self.dir, f".claim-{self.owner_id}")
        now = self._clock()
        with open(claim, "w") as f:
            json.dump({"owner": self.owner_id, "t": now}, f)
        os.utime(claim, (now, now))  # mtime from the SAME clock is_stale reads
        # Re-check right before the rename: a stalled-but-alive leader may
        # have renewed since our staleness read (shrinks the clobber window
        # to the check->rename gap; the remaining dual-leader window is
        # bounded by the deposed side's next renew(), which detects the
        # foreign owner and steps down — snapshot writes are fenced).
        if not self.is_stale():
            try:
                os.remove(claim)
            except OSError:
                pass
            return False
        os.replace(claim, self.path)
        # verify after the dust settles: a racing rename may have landed on
        # top of ours (last-writer-wins is exactly one winner)
        self._sleep(0.01)
        return self.current_owner() == self.owner_id

    def renew(self) -> bool:
        if self.current_owner() != self.owner_id:
            return False  # usurped (we were stale and someone claimed)
        from paddle_tpu_torch.robustness import chaos as _chaos

        if _chaos.fire("stale_lease"):
            # chaos drill: the leader BELIEVES it renewed but the heartbeat
            # never reached shared storage (GC pause, NFS stall) — the lease
            # goes stale underneath it and a standby must take over while
            # this side detects the usurper and steps down
            return True
        now = self._clock()
        try:
            os.utime(self.path, (now, now))
        except OSError:
            return False  # lease file vanished under us: treat as usurped
        return True

    def release(self) -> None:
        if self.current_owner() == self.owner_id:
            try:
                os.remove(self.path)
            except OSError:
                pass


def _endpoint_path(dir_: str) -> str:
    return os.path.join(dir_, "endpoint.json")


def discover_endpoint(dir_: str) -> Optional[tuple]:
    """(host, port) of the current leader, or None (reference: clients
    watch the etcd master-addr key, etcd_client.go GetKey)."""
    try:
        with open(_endpoint_path(dir_)) as f:
            d = json.load(f)
        return (d["host"], d["port"])
    except (OSError, ValueError, KeyError):
        return None


class HAMaster:
    """One master candidate.  start() campaigns; the winner serves the
    task queues (recovering them from the shared snapshot), losers keep
    watching and take over when the lease goes stale."""

    def __init__(
        self,
        dir_: str,
        patterns: Sequence[str],
        owner_id: Optional[str] = None,
        lease_timeout: float = 5.0,
        renew_interval: Optional[float] = None,
        address=("127.0.0.1", 0),
        **service_kw,
    ):
        self.dir = dir_
        self.patterns = list(patterns)
        self.owner_id = owner_id or f"{os.uname().nodename}:{os.getpid()}"
        self.lease = LeaseFile(dir_, self.owner_id, lease_timeout)
        self.renew_interval = renew_interval or lease_timeout / 3.0
        self._address = address
        self._service_kw = dict(service_kw)
        self._service_kw.setdefault(
            "snapshot_path", os.path.join(dir_, "master_state.json")
        )
        # HA candidates run the durable state plane by default: every queue
        # transition is an fsync'd journal record, so OUR standby peers can
        # tail it and take over warm (journal=False opts back into the
        # legacy debounced-snapshot mode)
        self._service_kw.setdefault("journal", True)
        self.service: Optional[Service] = None
        self.server: Optional[Server] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.is_leader = threading.Event()
        # -- warm-standby replica (journal tail) ---------------------------
        self._replica: Optional[Service] = None
        self._replica_key = None  # (journal_file, base_seq) it loaded from
        self._tail_path: Optional[str] = None
        self._tail_offset = 0
        self._tail_corrupt_warned = False
        self._snap_stat = None  # (mtime_ns, size, ino) of the parsed snapshot
        self._legacy_snapshot = False  # last parse found no journal_file
        # set each time this candidate assumes leadership: {"warm",
        # "replayed_records", "takeover_s", "t_leader"} — the recovery-
        # time-after-fault observables
        self.last_takeover: Optional[Dict[str, Any]] = None
        # a poisoned journal (unknown record type: version skew) is fatal
        # for the whole CANDIDATE, not just its campaign thread — a silent
        # thread death would leave a zombie that never takes over.  The
        # CLI loop polls this and exits nonzero.
        self.fatal: Optional[str] = None

    # ------------------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="paddle-ha-campaign", daemon=True
        )
        self._thread.start()

    def wait_leader(self, timeout: Optional[float] = None) -> bool:
        return self.is_leader.wait(timeout)

    # -- warm standby: tail the leader's journal into a replica ----------
    def _drop_replica(self) -> None:
        self._replica = None
        self._replica_key = None
        self._tail_path = None
        self._tail_offset = 0
        self._tail_corrupt_warned = False
        self._snap_stat = None
        self._legacy_snapshot = False

    def _standby_tick(self) -> None:
        """Advance the in-memory replica: (re)load the snapshot when the
        leader compacted into a new journal generation, then apply every
        complete CRC-verified record appended since our last read.  Any
        failure just leaves the replica where it was — takeover falls back
        to cold recovery, which replays the same files."""
        if not self._service_kw.get("journal"):
            return  # legacy mode: nothing to tail
        snap = self._service_kw["snapshot_path"]
        try:
            st = os.stat(snap)
        except OSError:
            return  # no leader yet: next tick retries
        snap_stat = (st.st_mtime_ns, st.st_size, st.st_ino)
        if self._tail_path is not None and not os.path.exists(self._tail_path):
            # our generation vanished: a compaction we missed swept it.
            # The stat-compare below can (rarely) miss the new snapshot —
            # coarse mtime + equal size + recycled inode — and a missed
            # generation change would freeze the replica FOREVER, so the
            # swept tail forces the full reparse
            self._snap_stat = None
        # the snapshot only moves at compaction (every ~512 records), but
        # it embeds every task's chunk metadata — skip the full JSON parse
        # on the overwhelmingly common unchanged tick; the journal tail
        # below carries everything newer than the snapshot anyway
        if ((self._replica is None and not self._legacy_snapshot)
                or snap_stat != self._snap_stat):
            try:
                with open(snap) as f:
                    state = json.load(f)
            except (OSError, ValueError):
                return  # no leader yet, or mid-rename: next tick retries
            jf = state.get("journal_file")
            self._legacy_snapshot = jf is None
            if jf is None:
                # legacy (journal-less) snapshot: no replica to build, but
                # REMEMBER the stat — else every tick re-parses the whole
                # snapshot of a --no-journal leader forever
                self._drop_replica()
                self._legacy_snapshot = True
                self._snap_stat = snap_stat
                return
            self._snap_stat = snap_stat
            key = (jf, int(state.get("seq", 0)))
            if self._replica is None or self._replica_key != key:
                kw = {
                    k: v for k, v in self._service_kw.items()
                    if k not in ("snapshot_path", "journal", "journal_fsync",
                                 "journal_compact_every")
                }
                svc = Service(snapshot_path=None, journal=False, **kw)
                svc.load_state(state, warm=True)
                # remember the generation so promotion compacts into gen+1
                # and never truncates the very file the snapshot still
                # references
                svc._journal_gen = _mj.parse_generation(jf)
                self._replica = svc
                self._replica_key = key
                self._tail_path = os.path.join(
                    os.path.dirname(snap) or ".", jf
                )
                self._tail_offset = 0
        if self._tail_path and os.path.exists(self._tail_path):
            try:
                records, info = _mj.read_records(
                    self._tail_path, self._tail_offset
                )
            except FileNotFoundError:
                # swept between the exists() check and the open() — the
                # leader compacted in that window.  Same handling as the
                # vanished-tail fast path above: force the reparse next
                # tick instead of letting the error destroy the replica
                self._snap_stat = None
                return
            for seq, rec in records:
                self._replica.apply_record(seq, rec)
            # a torn tail is an append IN FLIGHT: stay put and re-read the
            # frame once the leader finishes (or died — then promotion
            # replays the same consistent prefix).  A CRC-corrupt COMPLETE
            # frame is different: the tail is permanently stuck at the rot,
            # so a takeover from here silently loses every transition the
            # leader fsync'd past it — warn ONCE so the operator hears it
            # while the leader is still alive to re-compact past the rot.
            if info["corrupt"] and not self._tail_corrupt_warned:
                self._tail_corrupt_warned = True
                _log.warning(
                    "standby %s: journal %s: %s — replica tail is stuck at "
                    "the good prefix; a takeover from here would drop "
                    "every later acked transition",
                    self.owner_id, self._tail_path, info["error"],
                )
            self._tail_offset = info["end_offset"]

    def _become_leader(self) -> None:
        t0 = time.monotonic()
        warm = False
        svc = None
        if self._replica is not None:
            # final catch-up read, then promote the tailed replica: leases
            # refresh, a fresh journal generation is compacted, and the
            # takeover carries ZERO recomputed tasks.  A JournalError here
            # (unknown record type) propagates to the campaign loop's
            # fatal path — never assume a lossy recovery.
            self._standby_tick()
            # the tick itself can DROP the replica it was catching up (a
            # deposed --no-journal leader published a legacy snapshot in
            # the campaign window) — fall through to cold recovery rather
            # than promote None
            svc = self._replica
            self._drop_replica()
        if svc is not None:
            svc.promote(
                self._service_kw["snapshot_path"],
                journal_fsync=self._service_kw.get("journal_fsync"),
                journal_compact_every=self._service_kw.get(
                    "journal_compact_every"
                ),
            )
            self.service = svc
            warm = True
        else:
            # cold path (first leader, or nothing tailed yet): recover the
            # queues from the shared snapshot + bounded journal replay (a
            # fresh cluster has none; set_dataset is idempotent against
            # recovered state)
            self.service = Service(**self._service_kw)
        self.service.set_dataset(self.patterns)
        self.server = Server(self.service, address=self._address)
        host, port = self.server.address
        tmp = _endpoint_path(self.dir) + f".{self.owner_id}"
        with open(tmp, "w") as f:
            json.dump({"host": host, "port": port, "owner": self.owner_id}, f)
        os.replace(tmp, _endpoint_path(self.dir))
        self.last_takeover = {
            "warm": warm,
            "replayed_records": self.service.replayed_records,
            "takeover_s": time.monotonic() - t0,
            "t_leader": time.time(),
        }
        _log.info(
            "master %s assumed leadership (%s, %d journal records replayed, "
            "%.3fs)", self.owner_id, "warm" if warm else "cold",
            self.last_takeover["replayed_records"],
            self.last_takeover["takeover_s"],
        )
        self.is_leader.set()

    def _step_down(self) -> None:
        self.is_leader.clear()
        if self.server is not None:
            self.server.close()  # stops accepting AND drops live conns
            self.server = None
        if self.service is not None:
            self.service.fence()  # never write the shared files again
        self.service = None
        self._drop_replica()  # rebuild against the NEW leader's generation

    def _run(self) -> None:
        try:
            self._campaign_loop()
        except _mj.JournalError as exc:
            # poisoned journal (unknown record type: version skew).  The
            # candidate is DEAD, not just its thread: record it where
            # wait_fatal()/the CLI loop sees it, release any leadership,
            # and crash the thread loudly.
            self.fatal = f"poisoned journal: {exc}"
            _log.error("master %s is dead: %s", self.owner_id, self.fatal)
            if self.is_leader.is_set():
                self._step_down()
                self.lease.release()
            raise

    def _campaign_loop(self) -> None:
        while not self._stop.is_set():
            if self.is_leader.is_set():
                if not self.lease.renew():
                    self._step_down()  # usurped after a stall
                self._stop.wait(self.renew_interval)
            else:
                if self.lease.try_acquire():
                    try:
                        self._become_leader()
                    except _mj.JournalError:
                        # never campaign again against a journal we refuse
                        # to interpret — a lossy takeover would recompute
                        # or, worse, double-apply acked transitions
                        self._step_down()
                        self.lease.release()
                        raise
                    except Exception:
                        # corrupt snapshot / bind failure: surface it, give
                        # the lease back, keep campaigning after a backoff
                        _log.exception(
                            "master %s failed to assume leadership",
                            self.owner_id,
                        )
                        self._step_down()
                        self.lease.release()
                        self._stop.wait(self.lease.lease_timeout)
                else:
                    try:
                        self._standby_tick()
                    except _mj.JournalError:
                        raise  # poisoned journal: crash loudly, don't lurk
                    except Exception:  # noqa: BLE001 — replica is advisory
                        _log.exception(
                            "standby %s: journal tail failed; takeover "
                            "will recover cold", self.owner_id,
                        )
                        self._drop_replica()
                    self._stop.wait(self.renew_interval)
        if self.is_leader.is_set():
            self._step_down()
            self.lease.release()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    # test hook: simulate a crashed leader (no release, no renewals)
    def freeze(self) -> None:
        self._stop.set()
        self.is_leader.clear()
        if self._thread is not None:
            self._thread.join(timeout=10)
        if self.server is not None:
            self.server.close()
            self.server = None


class HAClient:
    """Client that discovers the leader from the endpoint file and
    re-resolves + reconnects when the master fails over (the reference
    client watches etcd and reconnects, client.go)."""

    def __init__(self, dir_: str, timeout: float = 30.0,
                 sleep=time.sleep, **client_kw):
        self.dir = dir_
        self.timeout = timeout
        self._sleep = sleep  # injectable: discovery/re-dial poll loops
        self._client_kw = client_kw
        self._client: Optional[Client] = None
        self._endpoint = None

    def _connect(self) -> Client:
        deadline = time.time() + self.timeout
        last_err: Optional[Exception] = None
        while time.time() < deadline:
            ep = discover_endpoint(self.dir)
            if ep is not None:
                try:
                    c = Client(ep, sleep=self._sleep, **self._client_kw)
                    self._endpoint = ep
                    return c
                except (ConnectionError, OSError) as e:
                    last_err = e
            self._sleep(0.1)
        raise TimeoutError(f"no master leader in {self.dir}: {last_err}")

    def _call(self, method, *args):
        deadline = time.time() + self.timeout
        while True:
            if self._client is None:
                self._client = self._connect()
            try:
                return getattr(self._client, method)(*args)
            except MasterRPCError:
                raise  # the master executed the call: a real app error
            except _wire.WireTypeError:
                raise  # unencodable payload: deterministic, re-dialing is futile
            except _wire.WireOversizeError:
                raise  # over rpc_max_message_mb: deterministic, same story
            except (_wire.MasterWireError, ConnectionError, EOFError, OSError):
                # leader died mid-call — or the Client's bounded retry
                # exhausted against a storm of corrupt/duplicated frames
                # (netem drills): drop the connection, re-discover the
                # leader, ride the failover window.  Send-side wire
                # errors (type/oversize) re-raised above: those are OUR
                # payload's fault, not the network's.
                try:
                    self._client.close()
                except Exception:
                    pass
                self._client = None
                if time.time() > deadline:
                    raise
                self._sleep(0.2)

    # -- surface (the Client subset trainers use) ------------------------
    def set_dataset(self, patterns):
        return self._call("set_dataset", patterns)

    def next_record(self):
        return self._call("next_record")

    def start_new_pass(self, target_pass=None, worker_id=None):
        return self._call("start_new_pass", target_pass, worker_id)

    def request_save_model(self, block_secs: float = 60.0):
        return self._call("request_save_model", block_secs)

    def __getattr__(self, name):
        """The elastic cluster surface (get_task, task_finished, registry,
        fences, pass_results, ...) delegates from ``master._METHODS`` with
        the reconnect-on-failover discipline of :meth:`_call` — mirrors
        Client.__getattr__, one definition for the whole surface."""
        from paddle_tpu_torch.master import _METHODS

        if name in _METHODS:
            return lambda *args: self._call(name, *args)
        raise AttributeError(
            f"{type(self).__name__!s} has no attribute {name!r}"
        )

    def reader(self):
        from paddle_tpu_torch.master import reader_over

        return reader_over(self.next_record)

    def close(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None
