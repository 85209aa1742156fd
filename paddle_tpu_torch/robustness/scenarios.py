"""Production-gate scenario harness — mixed traffic, SLOs, chaos under load;
the counterpart of ``paddle_tpu/robustness/scenarios.py``.

The scenarios compose the port's planes — the serving scheduler and its
SLO admission and shedding (serving/), the open-loop load generator
(reader/loadgen.py), the elastic master/worker fleet (master*.py,
trainer/elastic.py) and the chaos fault points (robustness/chaos.py,
netem.py) — into named, seeded, diffable runs, each returning one flat
JSON-able metrics dict: p50/p95/p99 latency, goodput under an SLO,
shed/reject/timeout counts and recovery time after a fault.

Fast scenarios (``FAST_SCENARIOS``, in-process, seconds each):

* ``overload`` — the shed-not-collapse gate: measure the serving plane's
  saturation rate, then offer 1x and 2x that rate open-loop with
  per-request deadlines; at 2x the goodput (completed within the SLO) must
  hold >= 80% of the 1x goodput and the p99 of served requests must stay
  inside the SLO.
* ``burst_overload`` — the same gate under the ``burst`` arrival process.
* ``nan_request_under_load`` / ``slow_client_under_load`` — a serving
  chaos point fired mid-traffic: recovery time after the fault, and only
  the poisoned request fails.
* ``mixed_train_serve`` — a deterministic training loop
  (trainer/elastic.NumpyLinearModel, on the host) beside the serving plane
  under load with ``nan_request`` fired; training must stay bit-identical
  to a solo run.
* ``partition_under_load`` — a real RPC training leg (journaled master
  Service and Server on localhost, an ElasticWorker on a wire-codec
  Client) beside live serving while netem corrupts a frame (the codec must
  reject it) and then severs the link mid-pass; the final parameters are
  bit-identical to an unfaulted leg and the journal lints clean.
* ``trace_replay_drift`` — record a two-class overload window to a ``.ptt``
  trace while serving it, replay it against a fresh scheduler, and gate
  replay-vs-live drift and the per-class contract.

Slow scenarios (``SLOW_SCENARIOS``, real process fleets):

* ``fleet_kill_worker`` / ``fleet_kill_master`` — an elastic fleet trains
  over the HA master plane while this process serves open-loop traffic;
  SIGKILL a worker holding a lease, or the leader master mid-pass.
  Reported: recovery time, zero-recompute accounting, bit-identity of the
  final parameters against an unfaulted reference, and the serving status
  mix (only shed or timed-out requests may fail).
* ``fleet_serving`` — N ``python -m paddle_tpu_torch serve --register``
  engine processes behind the router, SIGKILL one mid-window: the corpse
  is pruned by lease expiry, the fleet ledger is disjoint and no request
  is served twice.
* ``fleet_rolling_restart`` — drain and replace every engine under live
  traffic: the fleet never drops below N-1 live engines and no request
  dies to the restart.

The serving engine runs on the card unless the caller asks for the CPU
(``device="cpu"``); the fleet drills pass the device on each engine's
``serve --register`` line.  Every wait is bounded: a request, a thread, a
subprocess or a registration that outlives its bound raises (or fails its
gate), and every listener binds port 0.  ``python -m paddle_tpu_torch
scenario`` runs any of these from the command line.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = [
    "FAST_SCENARIOS",
    "SLOW_SCENARIOS",
    "run_scenario",
    "scenario_overload",
    "scenario_chaos_under_load",
    "scenario_mixed_train_serve",
    "scenario_partition_under_load",
    "scenario_trace_replay_drift",
    "fleet_reference",
    "run_fleet_chaos",
    "run_fleet_serving",
    "run_fleet_rolling_restart",
    "make_serving_engine",
]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# tiny-flagship serving shape: big enough that decode is a real dispatch
# chain, small enough that a scenario runs in seconds
_V, _E, _H, _MAXLEN = 60, 32, 64, 32


def _pct(xs: List[float], p: float) -> Optional[float]:
    from paddle_tpu_torch.serving import percentile

    return percentile(xs, p)


def _ms(x: Optional[float]) -> Optional[float]:
    return None if x is None else round(x * 1e3, 3)


def _wait_all(reqs, timeout_s: float = 300.0) -> None:
    """Every request finalized within one shared bound, else raise."""
    deadline = time.monotonic() + timeout_s
    for r in reqs:
        if not r.wait(max(deadline - time.monotonic(), 0.0)):
            raise RuntimeError(f"request {r.req_id} never finalized in {timeout_s} s")


def _join(thread: threading.Thread, timeout_s: float, what: str) -> None:
    thread.join(timeout_s)
    if thread.is_alive():
        raise RuntimeError(f"{what} still running after {timeout_s} s")


def _reap(p: subprocess.Popen, timeout_s: float = 60.0):
    """Wait out a subprocess (draining its pipes), killing it past the
    bound; returns its (stdout, stderr)."""
    try:
        return p.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        p.kill()
        return p.communicate(timeout=30.0)


def make_serving_engine(seed: int = 0, max_slots: int = 2,
                        hbm_budget_mb: int = 2,
                        prefill_chunk_tokens: int = 0,
                        block_steps: int = 1, device=None):
    """A prewarmed tiny-flagship serving engine on `device` (the card
    unless the caller asks for the CPU): every slot rung and source length
    the scenarios realize runs once before any measured window, so EWMAs
    and percentiles see steady dispatch."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.core.topology import reset_auto_names
    from paddle_tpu_torch.models.seq2seq import Seq2SeqGenerator, seq2seq_cost
    from paddle_tpu_torch.serving import Request, ServingEngine

    device = resolve_device(device)
    reset_auto_names()
    cost, _ = seq2seq_cost(_V, _V, word_dim=_E, hidden_dim=_H)
    params = paddle.parameters.create(cost, seed=seed, device=device)
    gen = Seq2SeqGenerator(
        params, _V, _V, word_dim=_E, hidden_dim=_H,
        bos_id=0, eos_id=1, max_length=_MAXLEN, device=device,
    )
    eng = ServingEngine(
        gen, max_slots=max_slots, hbm_budget_mb=hbm_budget_mb,
        max_new_tokens=_MAXLEN, block_steps=block_steps,
        prefill_chunk_tokens=prefill_chunk_tokens, device=device,
    )
    rungs, g = [], 1
    while g < max_slots:
        rungs.append(g)
        g *= 2
    rungs.append(max_slots)
    for gsz in rungs:
        for src_len in (5, 20):
            eng.admit([Request([2] * src_len) for _ in range(gsz)])
            for _ in range(8 * (_MAXLEN + src_len)):
                if not (eng.n_live or eng.n_prefilling):
                    break
                eng.step()
            else:
                raise RuntimeError("serving engine prewarm did not drain")
    return eng


def _srcs(seed: int, n: int, lo: int = 3, hi: int = 24) -> List[List[int]]:
    rng = np.random.RandomState(seed)
    return [
        rng.randint(2, _V, size=rng.randint(lo, hi)).tolist()
        for _ in range(n)
    ]


def _status_counts(reqs) -> Dict[str, int]:
    from paddle_tpu_torch.serving import status_counts

    return status_counts(reqs)


def _serve_window(engine, srcs, offered_rps: Optional[float], slo_s: float,
                  seed: int, process: str = "poisson",
                  queue_limit: Optional[int] = None,
                  callback=None) -> Dict[str, Any]:
    """One measured serving window: calibrate the scheduler's EWMA, offer
    the sources open-loop (or all at once when ``offered_rps`` is None),
    wait everything out, and report the SLO ledger."""
    from paddle_tpu_torch.reader.loadgen import OpenLoopLoadGen
    from paddle_tpu_torch.serving import Request, ServingScheduler

    reqs = [Request(s, callback=callback) for s in srcs]
    with ServingScheduler(engine, queue_limit=queue_limit) as sched:
        for s in srcs[:3]:  # EWMA calibration, outside the window
            sched.generate(s, timeout=60.0)
        t0 = time.perf_counter()
        if offered_rps is None:
            for r in reqs:
                r.deadline_s = slo_s if slo_s > 0 else None
                sched.submit(r)
        else:
            OpenLoopLoadGen(
                offered_rps, len(reqs), lambda i: reqs[i], seed=seed,
                process=process,
                deadline_s=slo_s if slo_s > 0 else None,
            ).run(sched.submit)
        _wait_all(reqs)
        wall = time.perf_counter() - t0
    served = [r for r in reqs if r.status == "served"]
    lat = [r.t_done - r.t_submit for r in served]
    in_slo = [x for x in lat if slo_s <= 0 or x <= slo_s]
    service = [
        r.t_done - r.t_admit for r in served if r.t_admit is not None
    ]
    return {
        "n_offered": len(reqs),
        "offered_rps": None if offered_rps is None else round(offered_rps, 2),
        "wall_s": round(wall, 3),
        "statuses": _status_counts(reqs),
        "goodput_rps": round(len(in_slo) / wall, 3) if wall > 0 else None,
        "goodput_frac": round(len(in_slo) / len(reqs), 4),
        "p50_ms": _ms(_pct(lat, 0.50)),
        "p95_ms": _ms(_pct(lat, 0.95)),
        "p99_ms": _ms(_pct(lat, 0.99)),
        "mean_service_ms": _ms(float(np.mean(service)) if service else None),
        "p95_service_ms": _ms(_pct(service, 0.95)),
        "_requests": reqs,
    }


def _resolve_slo_s(slo_ms: Optional[float], wave: Dict[str, Any]) -> float:
    """The scenario SLO: explicit, the ``scenario_slo_ms`` flag, or 2.5x
    the saturation wave's p95 SERVICE time floored at 50 ms — wide enough
    that an unloaded request is always feasible (the 1x goodput base is
    honest), tight enough that 2x queueing must shed."""
    from paddle_tpu_torch.utils import flags as _flags

    if slo_ms is None:
        slo_ms = _flags.get_flag("scenario_slo_ms")
    if slo_ms and slo_ms > 0:
        return float(slo_ms) / 1e3
    base = (wave.get("p95_service_ms")
            or 4.0 * (wave.get("mean_service_ms") or 10.0)) / 1e3
    return max(0.05, 2.5 * base)


def scenario_overload(slo_ms: Optional[float] = None, n_requests: int = 128,
                      seed: int = 0, process: str = "poisson",
                      engine=None, device=None) -> Dict[str, Any]:
    """The shed-not-collapse gate: goodput at 2x saturation must hold
    >= 80% of goodput at saturation, and served p99 must stay inside the
    SLO — reported as booleans and folded into ``passed``."""
    engine = engine if engine is not None else make_serving_engine(seed, device=device)
    # saturation: an all-at-once wave calibrates per-request service time
    # under full slot occupancy; capacity derives ANALYTICALLY as
    # slots / mean-service (the wave's raw wall clock is too noisy on a
    # shared host to gate on — service time averages the noise out)
    wave = _serve_window(
        engine, _srcs(seed, n_requests), None, 0.0, seed
    )
    saturation_rps = engine.max_slots / (wave["mean_service_ms"] / 1e3)
    slo_s = _resolve_slo_s(slo_ms, wave)
    at_1x = _serve_window(
        engine, _srcs(seed + 1, n_requests), saturation_rps, slo_s,
        seed + 1, process=process,
    )
    at_2x = _serve_window(
        engine, _srcs(seed + 2, 2 * n_requests), 2.0 * saturation_rps,
        slo_s, seed + 2, process=process,
    )
    g1, g2 = at_1x["goodput_rps"], at_2x["goodput_rps"]
    p99 = at_2x["p99_ms"]
    gate_goodput = bool(g1 and g2 and g2 >= 0.8 * g1)
    # served requests may cross the deadline by at most ~one dispatch (the
    # deadline sweep cancels at loop granularity): 10% tolerance
    gate_p99 = bool(p99 is not None and p99 <= slo_s * 1e3 * 1.1)
    out = {
        "scenario": "overload" if process == "poisson" else "burst_overload",
        "arrival": process,
        "slo_ms": round(slo_s * 1e3, 3),
        "saturation_rps": round(saturation_rps, 2),
        "saturation": {k: v for k, v in wave.items() if k != "_requests"},
        "at_1x": {k: v for k, v in at_1x.items() if k != "_requests"},
        "at_2x": {k: v for k, v in at_2x.items() if k != "_requests"},
        "goodput_2x_over_1x": round(g2 / g1, 4) if g1 and g2 else None,
        "gate_goodput_2x_ge_80pct": gate_goodput,
        "gate_p99_within_slo": gate_p99,
        "passed": gate_goodput and gate_p99,
    }
    return out


def scenario_chaos_under_load(point: str = "nan_request",
                              occurrence: int = 5,
                              slo_ms: Optional[float] = None,
                              n_requests: int = 48, seed: int = 0,
                              engine=None, device=None) -> Dict[str, Any]:
    """Fire a serving chaos point UNDER live open-loop traffic and report
    recovery-time-after-fault: the gap between the fault consultation and
    the next completed request.  Only the poisoned request may fail (for
    ``nan_request``); a frozen client callback may stall nothing but
    delivery (``serve_slow_client``)."""
    from paddle_tpu_torch.robustness import chaos

    if point not in ("nan_request", "serve_slow_client"):
        raise ValueError(f"not a serving chaos point: {point!r}")
    if occurrence <= 3:
        # the window's 3 EWMA-calibration submits consume the first 3
        # consultations; an earlier occurrence would poison calibration
        raise ValueError("occurrence must be > 3 (calibration offset)")
    engine = engine if engine is not None else make_serving_engine(seed, device=device)
    wave = _serve_window(engine, _srcs(seed, 24), None, 0.0, seed)
    saturation_rps = wave["n_offered"] / wave["wall_s"]
    slo_s = _resolve_slo_s(slo_ms, wave)
    delivered: List[Any] = []
    os.environ.setdefault("PADDLE_TPU_TORCH_CHAOS_HANG_SECS", "2")
    chaos.arm(f"{point}@{occurrence}")
    try:
        win = _serve_window(
            engine, _srcs(seed + 3, n_requests), 0.7 * saturation_rps,
            slo_s, seed + 3,
            # serve_slow_client freezes a client CALLBACK: the drill needs
            # real callbacks on the delivery thread to have one to freeze
            callback=delivered.append,
        )
    finally:
        chaos.disarm()
    reqs = win.pop("_requests")
    failed = [r for r in reqs if r.status not in ("served", "shed", "timeout")]
    # recovery: first completion after the fault's victim was finalized
    # (nan_request) / after the hang began (slow client freezes delivery,
    # so wait()-completion timestamps keep flowing — recovery ~ 0)
    if point == "nan_request":
        victims = [r for r in reqs if r.error and "non-integral" in r.error]
        t_fault = victims[0].t_done if victims else None
    else:
        victims = []
        t_fault = min((r.t_done for r in reqs if r.t_done), default=None)
    recovery_s = None
    if t_fault is not None:
        after = [
            r.t_done - t_fault for r in reqs
            if r.status == "served" and r.t_done is not None
            and r.t_done >= t_fault
        ]
        recovery_s = min(after) if after else None
    ok = (
        (point != "nan_request" or len(victims) == 1)
        and all(r.status in ("served", "shed", "timeout") or r in victims
                for r in reqs)
        and not [r for r in failed if r not in victims]
    )
    return {
        # match the registry key (serve_slow_client registers as
        # slow_client_under_load)
        "scenario": (
            "slow_client_under_load" if point == "serve_slow_client"
            else f"{point}_under_load"
        ),
        "chaos_point": f"{point}@{occurrence}",
        "slo_ms": round(slo_s * 1e3, 3),
        **{k: v for k, v in win.items()},
        "n_chaos_victims": len(victims),
        "recovery_after_fault_ms": _ms(recovery_s),
        "passed": bool(ok),
    }


def _train_linear(n_steps: int, dim: int = 8, seed: int = 1,
                  out: Optional[dict] = None) -> dict:
    """Deterministic in-process training loop (the jax-free elastic-plane
    model): the mixed-traffic scenario's training half.  Returns final
    params + steps/s; bit-identical across runs by construction — any
    divergence under co-located serving is a real isolation bug."""
    from paddle_tpu_torch.trainer.elastic import NumpyLinearModel

    rng = np.random.RandomState(seed)
    w_true = rng.randn(dim).astype(np.float32)
    records = []
    for _ in range(64):
        x = rng.randn(dim).astype(np.float32)
        records.append(
            np.concatenate([x, [np.float32(x @ w_true)]])
            .astype(np.float32).tobytes()
        )
    from paddle_tpu_torch import obs as _obs

    model = NumpyLinearModel(dim, lr=0.2)
    t0 = time.perf_counter()
    for step in range(n_steps):
        lo = (step * 8) % len(records)
        with _obs.span("train_step", cat="trainer", b=step):
            grads, _cost, _n = model.task_grad(
                records[lo:lo + 8], pass_id=0, task_id=step
            )
            model.apply(grads)
    wall = time.perf_counter() - t0
    res = {
        "w": model.w.copy(), "b": model.b.copy(),
        "steps_per_s": n_steps / wall if wall > 0 else None,
    }
    if out is not None:
        out.update(res)
    return res


def _traced_fleet_leg(seed: int) -> Optional[Dict[str, Any]]:
    """Only when span EXPORT is armed (``python -m paddle_tpu_torch scenario --trace``):
    run a one-worker elastic mini-pass over an in-process HA master so
    the merged timeline spans >= 2 PROCESSES and carries the master RPC
    plane — the parent contributes serving + master spans (the Server
    handles the worker's RPCs here), the worker subprocess contributes
    its lease→compute→ack spans, and the RPC request/response pairs give
    `trace merge` its clock-skew anchors.  Runs BEFORE the measured
    serving windows, so the SLO gates never pay its CPU."""
    from paddle_tpu_torch import obs

    if not obs.tracer.exporting:
        return None
    import tempfile

    from paddle_tpu_torch.master_ha import HAMaster

    d = tempfile.mkdtemp(prefix="paddle-tpu-torch-trace-fleet-")
    data = os.path.join(d, "data.rio")
    _write_linear_dataset(data, n=24, seed=seed)
    ha = HAMaster(os.path.join(d, "ha"), [data], owner_id="trace-master",
                  **_MASTER_KW)
    ha.start()
    try:
        if not ha.wait_leader(30):
            raise RuntimeError("trace-leg master never took leadership")
        rcs, errs, stats, _ = _collect_workers(
            d, 1, _spawn_workers(d, 1, 1), timeout=120
        )
        if rcs != [0]:
            raise RuntimeError(f"trace-leg worker failed: {rcs} {errs}")
    finally:
        ha.stop()
    return {
        "worker_rc": rcs[0],
        "tasks_done": stats.get(0, {}).get("tasks_done"),
    }


def scenario_mixed_train_serve(slo_ms: Optional[float] = None,
                               n_requests: int = 48, train_steps: int = 400,
                               seed: int = 0,
                               engine=None, device=None) -> Dict[str, Any]:
    """Train and serve concurrently in ONE process: the training loop runs
    on a side thread while the serving plane takes open-loop traffic with
    ``nan_request`` fired mid-stream.  Gates: training params bit-equal
    to the solo run (zero divergence), only the poisoned request fails,
    goodput holds.  Under ``--trace`` a one-worker fleet leg runs first
    (:func:`_traced_fleet_leg`) so the merged timeline is genuinely
    cross-process."""
    from paddle_tpu_torch.robustness import chaos

    traced_fleet = _traced_fleet_leg(seed)
    engine = engine if engine is not None else make_serving_engine(seed, device=device)
    solo = _train_linear(train_steps)
    wave = _serve_window(engine, _srcs(seed, 24), None, 0.0, seed)
    saturation_rps = wave["n_offered"] / wave["wall_s"]
    slo_s = _resolve_slo_s(slo_ms, wave)
    mixed: dict = {}
    trainer = threading.Thread(
        target=_train_linear, args=(train_steps,),
        kwargs={"out": mixed}, name="scenario-train", daemon=True,
    )
    chaos.arm("nan_request@7")
    try:
        trainer.start()
        win = _serve_window(
            engine, _srcs(seed + 4, n_requests), 0.7 * saturation_rps,
            slo_s, seed + 4,
        )
        trainer.join(60.0)
    finally:
        chaos.disarm()
    reqs = win.pop("_requests")
    poisoned = [r for r in reqs if r.error and "non-integral" in r.error]
    train_identical = (
        not trainer.is_alive()
        and np.array_equal(mixed.get("w"), solo["w"])
        and np.array_equal(mixed.get("b"), solo["b"])
    )
    serve_ok = len(poisoned) == 1 and all(
        r.status in ("served", "shed", "timeout") for r in reqs
        if r not in poisoned
    )
    out_trace = (
        {} if traced_fleet is None else {"traced_fleet": traced_fleet}
    )
    return {
        "scenario": "mixed_train_serve",
        "slo_ms": round(slo_s * 1e3, 3),
        **win,
        **out_trace,
        "train_steps": train_steps,
        "train_steps_per_s_solo": round(solo["steps_per_s"], 1),
        "train_steps_per_s_mixed": (
            round(mixed["steps_per_s"], 1) if mixed.get("steps_per_s")
            else None
        ),
        "train_bit_identical_to_solo": bool(train_identical),
        "passed": bool(train_identical and serve_ok),
    }


class _AckStamper:
    """Wraps a master client surface, stamping the wall-clock time of
    every SUCCESSFUL task_finished ack — the observable the partition
    drill measures recovery from (first ack landed after the link came
    back).  Everything else delegates untouched."""

    def __init__(self, inner):
        self._inner = inner
        self.ack_times: List[float] = []

    def __getattr__(self, name):
        fn = getattr(self._inner, name)
        if name != "task_finished":
            return fn

        def stamped(*args):
            out = fn(*args)
            if out:
                self.ack_times.append(time.time())
            return out

        return stamped


def _rpc_training_leg(workdir: str, seed: int, passes: int = 2,
                      out: Optional[dict] = None) -> dict:
    """One REAL-RPC training run, in-process: a journaled master Service
    served over localhost, driven by an ElasticWorker whose every call
    rides the master_wire codec (and, when netem chaos is armed, the
    fault-injecting transport).  Deterministic by the elastic protocol,
    so two legs over the same dataset are bit-identical — faulted or
    not."""
    from paddle_tpu_torch.master import Client, Server, Service
    from paddle_tpu_torch.trainer.elastic import ElasticWorker, NumpyLinearModel

    os.makedirs(workdir, exist_ok=True)
    data = os.path.join(workdir, "data.rio")
    _write_linear_dataset(data, n=48, seed=seed)
    svc = Service(
        snapshot_path=os.path.join(workdir, "master_state.json"),
        chunks_per_task=2, timeout_s=8.0, worker_timeout_s=10.0,
        auto_rotate=False, journal=True,
    )
    srv = Server(svc)
    client = Client(srv.address, call_timeout_s=0.75, reconnect_tries=4,
                    reconnect_backoff=0.1)
    stamper = _AckStamper(client)
    model = NumpyLinearModel(_DIM, lr=0.2)
    worker = ElasticWorker(stamper, "w0", model, min_workers=1,
                           rpc_retry_window_s=60.0)
    res: dict = {}
    try:
        client.set_dataset([data])
        summary = worker.run(passes)
        res = {
            "params": model.state(),
            "tasks_done": summary["tasks_done"],
            "pass_costs": summary["pass_costs"],
            "ack_times": list(stamper.ack_times),
            "master_stats": svc.stats(),
        }
    finally:
        try:
            client.close()
        except Exception:  # noqa: BLE001 — the link may be partitioned
            pass
        srv.close()
        jf = None
        try:
            with open(os.path.join(workdir, "master_state.json")) as f:
                jf = json.load(f).get("journal_file")
        except (OSError, ValueError):
            pass
        res["journal_path"] = (
            os.path.join(workdir, jf) if jf else None
        )
        if out is not None:
            out.update(res)
    return res


def scenario_partition_under_load(slo_ms: Optional[float] = None,
                                  n_requests: int = 48, seed: int = 0,
                                  engine=None, device=None) -> Dict[str, Any]:
    """The hostile-network gate: corrupt-frame rejection + a mid-pass
    link partition under live mixed train+serve traffic.

    Arms ``net_corrupt@2`` (one early client frame bit-flips in flight —
    the master_wire CRC must reject it server-side, counted, and the
    client's bounded retry must ride it) and ``net_partition@12`` (the
    link goes DOWN for ~1.2s as the 12th egress message leaves, mid-pass)
    on the CLIENT role only, while the serving plane takes open-loop
    deadline traffic in the same process.  Gates: the worker completes
    every pass through its retry window, final training params are
    BIT-IDENTICAL to an unfaulted reference leg, the codec reject counter
    is > 0, recovery-time-after-partition is bounded, the surviving
    journal lints clean, and only shed/timeout serving failures occur."""
    import tempfile

    from paddle_tpu_torch import master_journal as _mj
    from paddle_tpu_torch import master_wire as _wire
    from paddle_tpu_torch.robustness import chaos, netem

    engine = engine if engine is not None else make_serving_engine(seed, device=device)
    d = tempfile.mkdtemp(prefix="paddle-tpu-torch-partition-")
    # unfaulted reference leg FIRST (chaos unarmed): the bit-identity
    # target — itself over the real wire codec, same dataset, same seeds
    ref = _rpc_training_leg(os.path.join(d, "reference"), seed)
    wave = _serve_window(engine, _srcs(seed, 24), None, 0.0, seed)
    saturation_rps = wave["n_offered"] / wave["wall_s"]
    slo_s = _resolve_slo_s(slo_ms, wave)

    partition_secs = 1.2
    env_prev = {
        k: os.environ.get(k)
        for k in ("PADDLE_TPU_TORCH_NETEM_ROLE", "PADDLE_TPU_TORCH_NETEM_PARTITION_SECS",
                  "PADDLE_TPU_TORCH_NETEM_DIRECTION")
    }
    os.environ["PADDLE_TPU_TORCH_NETEM_ROLE"] = "client"
    os.environ["PADDLE_TPU_TORCH_NETEM_PARTITION_SECS"] = str(partition_secs)
    os.environ["PADDLE_TPU_TORCH_NETEM_DIRECTION"] = "both"
    _wire.counters.reset()
    netem.reset()
    chaos.arm("net_corrupt@2,net_partition@12")
    faulted: dict = {}
    trainer = threading.Thread(
        target=_rpc_training_leg,
        args=(os.path.join(d, "faulted"), seed),
        kwargs={"out": faulted}, name="scenario-partition-train",
        daemon=True,
    )
    # the serving schedule is sized to OUTLAST the faulted training leg
    # and truncates the moment it exits (run_fleet_chaos discipline), so
    # live deadline traffic genuinely spans the corrupt frame AND the
    # partition window — faults-at-rest prove nothing
    from paddle_tpu_torch.reader.loadgen import OpenLoopLoadGen
    from paddle_tpu_torch.serving import Request, ServingScheduler

    reqs: List[Any] = []
    all_srcs = _srcs(seed + 4, n_requests)

    def _mk(i):
        r = Request(all_srcs[i % len(all_srcs)])
        reqs.append(r)
        return r

    try:
        trainer.start()
        t0 = time.perf_counter()
        t_traffic0 = time.time()
        with ServingScheduler(engine) as sched:
            OpenLoopLoadGen(
                min(0.5 * saturation_rps, 60.0), 20 * n_requests, _mk,
                seed=seed + 4, deadline_s=slo_s,
            ).run(sched.submit, stop=lambda: not trainer.is_alive())
            t_traffic1 = time.time()
            trainer.join(120.0)
            _wait_all(reqs)
        wall = time.perf_counter() - t0
    finally:
        chaos.disarm()
        for k, v in env_prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    served = [r for r in reqs if r.status == "served"]
    lat = [r.t_done - r.t_submit for r in served]
    in_slo = [x for x in lat if x <= slo_s]
    win = {
        "n_offered": len(reqs),
        "wall_s": round(wall, 3),
        "statuses": _status_counts(reqs),
        "goodput_frac": (
            round(len(in_slo) / len(reqs), 4) if reqs else None
        ),
        "p50_ms": _ms(_pct(lat, 0.50)),
        "p95_ms": _ms(_pct(lat, 0.95)),
        "p99_ms": _ms(_pct(lat, 0.99)),
    }
    wire_counts = _wire.counters.snapshot()
    netem_counts = netem.counters.snapshot()
    t_part = netem.last_partition_start()
    recovery_s = None
    if t_part > 0:
        after = [t - t_part for t in faulted.get("ack_times", ())
                 if t >= t_part]
        recovery_s = min(after) if after else None
    train_identical = (
        not trainer.is_alive()
        and faulted.get("params") is not None
        and all(
            np.array_equal(faulted["params"][k], ref["params"][k])
            for k in ref["params"]
        )
        and len(faulted.get("pass_costs", ())) == len(ref["pass_costs"])
    )
    jpath = faulted.get("journal_path")
    journal_findings = (
        _mj.verify_journal(jpath) if jpath and os.path.exists(jpath)
        else [{"rule": "J001", "severity": "error",
               "message": "no surviving journal generation"}]
    )
    serve_ok = all(
        r.status in ("served", "shed", "timeout") for r in reqs
    )
    rejects = wire_counts.get("server_rejected_frames", 0)
    gates = {
        "gate_train_bit_identical": bool(train_identical),
        "gate_codec_rejected_corrupt_frame": rejects > 0,
        "gate_partition_fired": t_part > 0,
        # faults-at-rest prove nothing: the open-loop schedule must have
        # been live on BOTH sides of the partition onset
        "gate_traffic_spanned_partition": bool(
            t_part > 0 and t_traffic0 < t_part < t_traffic1
        ),
        "gate_recovered_after_partition": (
            recovery_s is not None and recovery_s < 10.0
        ),
        "gate_journal_lints_clean": not journal_findings,
        "gate_serving_only_shed_or_timeout": bool(serve_ok),
    }
    netem.reset()
    return {
        "scenario": "partition_under_load",
        "chaos_point": "net_corrupt@2,net_partition@12",
        "partition_secs": partition_secs,
        "slo_ms": round(slo_s * 1e3, 3),
        **win,
        "train_tasks_done": faulted.get("tasks_done"),
        "train_params_bit_identical": bool(train_identical),
        "recovery_after_partition_ms": _ms(recovery_s),
        "wire": wire_counts,
        "netem": netem_counts,
        "journal_findings": [f["message"] for f in journal_findings][:5],
        **gates,
        "passed": all(gates.values()),
    }


def _class_ledger(reqs, slo_s: float) -> Dict[str, Dict[str, Any]]:
    """Per-priority-class SLO ledger: offered/served/in-SLO/failed counts
    and goodput per ``class_label`` — the observable the per-class
    admission gate asserts on (high classes keep goodput while low
    classes shed first at overload)."""
    out: Dict[str, Dict[str, Any]] = {}
    for r in reqs:
        c = getattr(r, "class_label", "p1")
        d = out.setdefault(
            c, {"offered": 0, "served": 0, "in_slo": 0, "failed": 0}
        )
        d["offered"] += 1
        if r.status == "served":
            d["served"] += 1
            lat = (
                r.t_done - r.t_submit
                if r.t_done is not None and r.t_submit is not None
                else None
            )
            if lat is not None and (slo_s <= 0 or lat <= slo_s):
                d["in_slo"] += 1
        else:
            d["failed"] += 1
    for d in out.values():
        d["goodput_frac"] = round(d["in_slo"] / d["offered"], 4)
        d["failed_frac"] = round(d["failed"] / d["offered"], 4)
    return out


def scenario_trace_replay_drift(slo_ms: Optional[float] = None,
                                n_requests: int = 72, seed: int = 0,
                                engine=None, device=None,
                                trace_path: Optional[str] = None,
                                ) -> Dict[str, Any]:
    """The scenario-realism gate (robustness/traces.py): RECORD a mixed
    two-class overload window to a ``.ptt`` trace while serving it live,
    then REPLAY the trace against a fresh scheduler and gate the drift.

    The live window offers 2x the calibrated saturation rate with
    PrefixMixer sessions and two priority classes (p0 interactive every
    4th request, p2 batch otherwise); every submitted request is
    appended to the trace.  The replay rebuilds every request purely
    from the records (prompts, sessions, deadlines, priorities — never a
    live RNG) on the recorded arrival offsets.  Gates: the replayed
    offer is BIT-IDENTICAL to the live one (same src ids, sessions,
    classes, deadlines, in order), replay-vs-live p99 and goodput drift
    stay inside tolerance (wide — a shared host is noisy; the
    gate catches replays that collapse, not scheduler jitter), the high
    class beats both the aggregate and the batch class (nonzero) in
    BOTH windows, and the low class sheds first at 2x saturation in
    BOTH windows."""
    import tempfile

    from paddle_tpu_torch.reader.loadgen import OpenLoopLoadGen, PrefixMixer
    from paddle_tpu_torch.robustness import traces as _traces
    from paddle_tpu_torch.serving import Request, ServingScheduler

    engine = engine if engine is not None else make_serving_engine(seed, device=device)
    wave = _serve_window(engine, _srcs(seed, 24), None, 0.0, seed)
    saturation_rps = engine.max_slots / (wave["mean_service_ms"] / 1e3)
    slo_s = _resolve_slo_s(slo_ms, wave)
    if trace_path is None:
        trace_path = os.path.join(
            tempfile.mkdtemp(prefix="paddle-tpu-torch-trace-"), "window.ptt"
        )
    mixer = PrefixMixer(_V, pool_size=3, prefix_frac=0.5, seed=seed,
                        sessions=4)
    # policy: the batch class sheds EARLIER (slack > 1 inflates its
    # predicted-wait margin), the interactive class holds on LONGER
    shed_slack = {0: 0.7, 2: 1.5}

    def _ledger(reqs, wall):
        served = [r for r in reqs if r.status == "served"]
        lat = [r.t_done - r.t_submit for r in served]
        in_slo = [x for x in lat if x <= slo_s]
        return {
            "n_offered": len(reqs),
            "wall_s": round(wall, 3),
            "statuses": _status_counts(reqs),
            "goodput_frac": round(len(in_slo) / len(reqs), 4),
            "p50_ms": _ms(_pct(lat, 0.50)),
            "p99_ms": _ms(_pct(lat, 0.99)),
            "classes": _class_ledger(reqs, slo_s),
        }

    # --- live window, recorded ------------------------------------------
    live_reqs: List[Any] = []

    def mk(i):
        r = Request(
            mixer.source(i), req_id=f"trace-{seed}-{i}",
            session_id=mixer.session_of(i),
        )
        live_reqs.append(r)
        return r

    writer = _traces.TraceWriter(trace_path, meta={
        "scenario": "trace_replay_drift", "seed": seed,
        "slo_ms": round(slo_s * 1e3, 3),
    })
    with ServingScheduler(engine, class_shed_slack=shed_slack) as sched:
        for s in _srcs(seed, 3):
            sched.generate(s, timeout=60.0)
        t0 = time.perf_counter()
        OpenLoopLoadGen(
            2.0 * saturation_rps, n_requests, mk, seed=seed + 1,
            deadline_s=slo_s,
            priority_of=lambda i: 0 if i % 4 == 0 else 2,
        ).run(lambda r: (writer.record_request(r), sched.submit(r))[-1])
        _wait_all(live_reqs)
        live_wall = time.perf_counter() - t0
    writer.close()

    # --- replay from the artifact ---------------------------------------
    trace = _traces.read_trace(trace_path)
    replay_reqs: List[Any] = []

    def factory(rec):
        r = Request(
            list(rec["src"]), rec.get("mnt"), req_id=str(rec["id"]),
            deadline_s=rec.get("dl"), session_id=rec.get("sess"),
            priority=int(rec.get("prio", 1)),
        )
        replay_reqs.append(r)
        return r

    with ServingScheduler(engine, class_shed_slack=shed_slack) as sched:
        for s in _srcs(seed, 3):
            sched.generate(s, timeout=60.0)
        t0 = time.perf_counter()
        _traces.TraceReplayLoadGen(trace, request_factory=factory).run(
            sched.submit
        )
        _wait_all(replay_reqs)
        replay_wall = time.perf_counter() - t0

    live = _ledger(live_reqs, live_wall)
    replay = _ledger(replay_reqs, replay_wall)
    identical_offer = (
        len(replay_reqs) == len(live_reqs)
        and all(
            a.src_ids == b.src_ids
            and a.session_id == b.session_id
            and a.priority == b.priority
            and a.deadline_s == b.deadline_s
            for a, b in zip(live_reqs, replay_reqs)
        )
    )
    g_live, g_rep = live["goodput_frac"], replay["goodput_frac"]
    p99_live, p99_rep = live["p99_ms"], replay["p99_ms"]
    hi_live = live["classes"].get("p0", {})
    lo_live = live["classes"].get("p2", {})
    hi_rep = replay["classes"].get("p0", {})
    lo_rep = replay["classes"].get("p2", {})
    gates = {
        "gate_offer_bit_identical": bool(identical_offer),
        "gate_goodput_drift": bool(abs(g_rep - g_live) <= 0.35),
        "gate_p99_drift": bool(
            p99_live is not None and p99_rep is not None
            and p99_rep <= 3.0 * p99_live + 250.0
        ),
        # RELATIVE on purpose (like the overload scenario's 2x/1x ratio):
        # an absolute floor dies under the lock sanitizer's per-lock
        # overhead, where effective capacity lands far below the wave-
        # calibrated saturation.  The interactive class must beat both
        # the window aggregate and the batch class — and hold NONZERO
        # goodput (a collapsed replay fails here) — in both windows.
        "gate_high_class_goodput": bool(
            hi_live.get("goodput_frac", 0.0)
            >= max(g_live, lo_live.get("goodput_frac", 0.0)) - 1e-9
            and hi_live.get("goodput_frac", 0.0) > 0.0
            and hi_rep.get("goodput_frac", 0.0)
            >= max(g_rep, lo_rep.get("goodput_frac", 0.0)) - 1e-9
            and hi_rep.get("goodput_frac", 0.0) > 0.0
        ),
        # the BATCH class carries the overload: its failure fraction must
        # be at least the interactive class's in both windows
        "gate_low_class_sheds_first": bool(
            hi_live.get("failed_frac", 1.0)
            <= lo_live.get("failed_frac", 0.0) + 1e-9
            and hi_rep.get("failed_frac", 1.0)
            <= lo_rep.get("failed_frac", 0.0) + 1e-9
        ),
    }
    return {
        "scenario": "trace_replay_drift",
        "slo_ms": round(slo_s * 1e3, 3),
        "offered_rps": round(2.0 * saturation_rps, 2),
        "trace_path": trace_path,
        "trace_records": len(trace),
        "arrival": {
            k: round(float(v), 4)
            for k, v in trace.arrival_stats().items()
        },
        "live": live,
        "replay": replay,
        **gates,
        "passed": all(gates.values()),
    }


# ---------------------------------------------------------------------------
# fleet scenarios — real process groups (slow; tests/test_torch_scenarios_e2e.py)
# ---------------------------------------------------------------------------

_DIM = 8
_TASKS_PER_PASS = 12  # 96 records / 4 per chunk = 24 chunks at 2/task
# wide lease on purpose: a scheduling stall on a loaded host must
# never let the standby depose a HEALTHY leader mid-drill (see
# tests/test_master_failover_e2e.py for the full rationale)
_MASTER_KW = dict(chunks_per_task=2, timeout_s=30.0, worker_timeout_s=10.0,
                  auto_rotate=False, lease_timeout=6.0)


def _fleet_env() -> dict:
    return dict(
        os.environ, OMP_NUM_THREADS="1",
        OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1",
        PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
    )


def _write_linear_dataset(path: str, n: int = 96, seed: int = 0) -> None:
    from paddle_tpu_torch.io import recordio

    rng = np.random.RandomState(seed)
    w_true = rng.randn(_DIM).astype(np.float32)
    recs = []
    for _ in range(n):
        x = rng.randn(_DIM).astype(np.float32)
        recs.append(
            np.concatenate([x, [np.float32(x @ w_true)]])
            .astype(np.float32).tobytes()
        )
    recordio.write_records(path, iter(recs), max_chunk_records=4)


def _spawn_workers(d: str, n: int, passes: int, chaos_env=None):
    procs = []
    for i in range(n):
        env = _fleet_env()
        if chaos_env and i in chaos_env:
            env.update(chaos_env[i])
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.trainer.elastic",
             "--dir", os.path.join(d, "ha"), "--worker-id", f"w{i}",
             "--num-passes", str(passes), "--model", "numpy",
             "--model-arg", f"dim={_DIM}", "--model-arg", "lr=0.2",
             "--min-workers", str(n),
             "--checkpoint-dir", os.path.join(d, "ck"),
             "--stats-out", os.path.join(d, "stats-{worker}.json")],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        ))
    return procs


def _collect_workers(d: str, n: int, procs, timeout: float = 240.0):
    """communicate() drains stderr WHILE waiting — a never-read PIPE blocks
    a chatty worker at ~64KB and would deadlock the drill."""
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.trainer.elastic import NumpyLinearModel

    rcs, errs = [], {}
    deadline = time.monotonic() + timeout
    for i, p in enumerate(procs):
        # one shared bound: a worker past it is killed (its rc shows it)
        _out, err = _reap(p, max(deadline - time.monotonic(), 0.1))
        rcs.append(p.returncode)
        errs[i] = err.decode()[-2000:]
    stats = {}
    for i in range(n):
        sp = os.path.join(d, f"stats-w{i}.json")
        if os.path.exists(sp):
            with open(sp) as f:
                stats[i] = json.load(f)
    restored = CheckpointManager(os.path.join(d, "ck")).restore_latest(
        NumpyLinearModel(_DIM).state()
    )
    return rcs, errs, stats, restored


def fleet_reference(workdir: str, n_workers: int = 4,
                    passes: int = 2) -> Dict[str, Any]:
    """Unfaulted reference fleet: the bit-identity target every fleet
    chaos drill diffs its final training parameters against."""
    from paddle_tpu_torch.master_ha import HAMaster

    d = os.path.abspath(workdir)
    os.makedirs(d, exist_ok=True)
    data = os.path.join(d, "data.rio")
    _write_linear_dataset(data)
    ha = HAMaster(os.path.join(d, "ha"), [data], owner_id="ref",
                  **_MASTER_KW)
    ha.start()
    try:
        if not ha.wait_leader(30):
            raise RuntimeError("reference master never took leadership")
        rcs, errs, stats, restored = _collect_workers(
            d, n_workers, _spawn_workers(d, n_workers, passes)
        )
        master_stats = ha.service.stats() if ha.service else None
    finally:
        ha.stop()
    if rcs != [0] * n_workers or restored is None:
        raise RuntimeError(f"reference fleet failed: rcs={rcs} errs={errs}")
    return {
        "params": restored[1],
        "total_acks": sum(s["tasks_done"] for s in stats.values()),
        "master_stats": master_stats,
        "n_workers": n_workers,
        "passes": passes,
    }


def _load_chaos_report(path: str) -> Optional[Dict[str, Any]]:
    """The victim's chaos arming-audit report (robustness/chaos.py writes
    it at process exit when ``PADDLE_TPU_TORCH_CHAOS_REPORT`` names a path) —
    None when the process died before atexit ran (SIGKILL: expected) or
    never wrote one."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def run_fleet_chaos(workdir: str, kill: str = "kill_master",
                    reference: Optional[Dict[str, Any]] = None,
                    n_workers: int = 4, passes: int = 2,
                    slo_ms: Optional[float] = None, seed: int = 0,
                    serve_requests: int = 64,
                    engine=None, device=None) -> Dict[str, Any]:
    """The headline drill: a live train+serve mix with a fault fired under
    load.  An elastic fleet trains over the HA master plane; the PARENT
    process serves open-loop traffic with deadlines the whole time;
    ``kill`` selects the fault (``kill_worker``: SIGKILL a worker as it
    takes its 1st task, holding a shard lease; ``kill_master``: SIGKILL
    the subprocess LEADER at its 8th ack, the in-process standby takes
    over warm).  Returns the serving ledger, training accounting,
    recovery time after the fault, and bit-identity vs ``reference``."""
    from paddle_tpu_torch.master_ha import HAMaster, discover_endpoint
    from paddle_tpu_torch.reader.loadgen import OpenLoopLoadGen
    from paddle_tpu_torch.serving import Request, ServingScheduler

    if kill not in ("kill_worker", "kill_master"):
        raise ValueError(f"unknown fleet fault {kill!r}")
    d = os.path.abspath(workdir)
    os.makedirs(d, exist_ok=True)
    if reference is None:
        reference = fleet_reference(
            os.path.join(d, "reference"), n_workers, passes
        )
    drill = os.path.join(d, kill)
    os.makedirs(drill, exist_ok=True)
    chaos_report = os.path.join(drill, "chaos-report.json")
    data = os.path.join(drill, "data.rio")
    _write_linear_dataset(data)
    hadir = os.path.join(drill, "ha")

    # serving plane prewarmed BEFORE the fleet spawns: the measured window
    # must pay dispatch under contention, not warm-up under contention
    engine = engine if engine is not None else make_serving_engine(seed, device=device)
    wave = _serve_window(engine, _srcs(seed, 24), None, 0.0, seed)
    saturation_rps = wave["n_offered"] / wave["wall_s"]
    slo_s = _resolve_slo_s(slo_ms, wave)

    leader = None
    standby = None
    chaos_env = None
    t_kill = None
    takeover = None
    procs: list = []
    try:
        if kill == "kill_master":
            leader = subprocess.Popen(
                [sys.executable, "-m", "paddle_tpu_torch", "master",
                 "--dir", hadir, "--patterns", data,
                 "--chunks-per-task", "2", "--timeout-s", "30",
                 "--worker-timeout-s", "10", "--lease-timeout", "6",
                 "--chaos", "kill_master@8"],
                env=dict(_fleet_env(),
                         PADDLE_TPU_TORCH_CHAOS_REPORT=chaos_report),
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            )
            deadline = time.time() + 60
            while discover_endpoint(hadir) is None:
                if leader.poll() is not None:
                    raise RuntimeError(
                        "leader died early: "
                        + leader.stdout.read()[-2000:]
                    )
                if time.time() > deadline:
                    raise RuntimeError("no leader endpoint appeared")
                time.sleep(0.1)  # lock: allow[C306] supervises a REAL subprocess leader: wall-clock by design, driven end-to-end by the fleet drills
            standby = HAMaster(hadir, [data], owner_id="standby",
                               **_MASTER_KW)
            standby.start()
            deadline = time.time() + 20
            while standby._replica is None:  # warm: replica before workers
                if time.time() > deadline:
                    raise RuntimeError("standby never built a replica")
                time.sleep(0.05)  # lock: allow[C306] waits on the live HA thread's journal tail: wall-clock by design in a process-fleet drill
        else:
            standby = HAMaster(hadir, [data], owner_id="drill",
                               **_MASTER_KW)
            standby.start()
            if not standby.wait_leader(30):
                raise RuntimeError("drill master never took leadership")
            chaos_env = {1: {"PADDLE_TPU_TORCH_CHAOS": "kill_worker@1",
                             "PADDLE_TPU_TORCH_CHAOS_REPORT": chaos_report}}

        procs = _spawn_workers(drill, n_workers, passes, chaos_env)

        # a side thread watches the fault's victim process and stamps the
        # kill time the moment SIGKILL lands
        victim = leader if kill == "kill_master" else procs[1]
        kill_stamp: Dict[str, float] = {}

        def _watch_kill():
            while victim.poll() is None:
                time.sleep(0.01)  # lock: allow[C306] stamps the wall-clock moment SIGKILL lands on a real process — the recovery metric's zero point
            kill_stamp["t"] = time.time()

        watcher = threading.Thread(
            target=_watch_kill, name="scenario-kill-watch", daemon=True
        )
        watcher.start()

        # the serve window runs on THIS thread while the fleet trains: one
        # process group, mixed traffic, fault incoming.  The schedule is
        # sized to outlast the fleet and truncated the moment every worker
        # exits (traffic stays live across the whole faulted span)
        reqs: List[Any] = []
        t0 = time.perf_counter()
        with ServingScheduler(engine) as sched:
            for s in _srcs(seed + 6, 3):
                sched.generate(s, timeout=60.0)
            span_s = 120.0
            all_srcs = _srcs(seed + 5, serve_requests)

            def mk(i):
                r = Request(all_srcs[i % len(all_srcs)])
                reqs.append(r)
                return r

            OpenLoopLoadGen(
                max(serve_requests / span_s, 2.0), 10 * serve_requests, mk,
                seed=seed + 5, deadline_s=slo_s,
            ).run(
                sched.submit,
                stop=lambda: all(p.poll() is not None for p in procs),
            )
            _wait_all(reqs)
        serve_wall = time.perf_counter() - t0

        watcher.join(180.0)  # the stamp below says whether it ended
        if "t" not in kill_stamp:
            raise RuntimeError(f"{kill} chaos never fired")
        t_kill = kill_stamp["t"]
        if victim.returncode != -signal.SIGKILL:
            if victim.returncode == 0:
                # the armed process finished CLEAN: SIGKILL never landed,
                # so the armed point was never consulted.  The victim's
                # exit report (robustness/chaos.py arming audit, written
                # because PADDLE_TPU_TORCH_CHAOS_REPORT was set) proves it —
                # and an armed-but-never-consulted fault point is a drill
                # FAILURE (the kill coverage silently became a no-op: the
                # drill "passed" without ever exercising the fault), not
                # a scheduling flake to retry away.
                raise RuntimeError(
                    f"{kill} armed but never fired: victim exited 0; "
                    f"chaos report: {_load_chaos_report(chaos_report)!r}"
                )
            raise RuntimeError(
                f"{kill} victim exited {victim.returncode}, not SIGKILL"
            )

        rcs, errs, stats, restored = _collect_workers(
            drill, n_workers, procs
        )
        t_done = time.time()
        if kill == "kill_master":
            if rcs != [0] * n_workers:
                raise RuntimeError(
                    f"fleet did not ride through the bounce: {rcs} {errs}"
                )
            if not standby.is_leader.is_set():
                raise RuntimeError("standby never took over")
            takeover = dict(standby.last_takeover or {})
            recovery_s = takeover["t_leader"] - t_kill
        else:
            if rcs[1] != -signal.SIGKILL:
                raise RuntimeError(f"victim exited {rcs[1]}, not SIGKILL")
            if sorted(c for i, c in enumerate(rcs) if i != 1) != [0] * (n_workers - 1):
                raise RuntimeError(f"survivors failed: {rcs} {errs}")
            # the master requeues the dead worker's lease after one shard
            # timeout; recovery = kill -> fleet completion (upper bound)
            recovery_s = t_done - t_kill
        master_stats = standby.service.stats() if standby.service else None
    finally:
        if standby is not None:
            standby.stop()
        if leader is not None and leader.poll() is None:
            leader.kill()
        if leader is not None:
            _reap(leader, 30.0)
        for p in procs:
            if p.poll() is None:
                p.kill()
                _reap(p, 30.0)

    total_acks = sum(s["tasks_done"] for s in stats.values())
    params = restored[1] if restored is not None else None
    bit_identical = params is not None and all(
        np.array_equal(params[k], reference["params"][k])
        for k in ("w", "b")
    )
    served = [r for r in reqs if r.status == "served"]
    lat = [r.t_done - r.t_submit for r in served]
    fail_bad = [
        r for r in reqs if r.status not in ("served", "shed", "timeout")
    ]
    expected_acks = _TASKS_PER_PASS * passes
    zero_recompute = total_acks == expected_acks
    out = {
        "scenario": f"fleet_{kill}",
        "chaos_point": (
            "kill_master@8" if kill == "kill_master" else "kill_worker@1"
        ),
        "n_workers": n_workers,
        "passes": passes,
        "slo_ms": round(slo_s * 1e3, 3),
        "serve": {
            "n_offered": len(reqs),
            "offered_rps": round(len(reqs) / serve_wall, 2)
            if serve_wall > 0 else None,
            "saturation_rps": round(saturation_rps, 2),
            "wall_s": round(serve_wall, 3),
            "statuses": _status_counts(reqs),
            "goodput_frac": round(
                sum(1 for x in lat if x <= slo_s) / len(reqs), 4
            ),
            "p50_ms": _ms(_pct(lat, 0.50)),
            "p95_ms": _ms(_pct(lat, 0.95)),
            "p99_ms": _ms(_pct(lat, 0.99)),
        },
        "recovery_after_fault_s": round(recovery_s, 3),
        # SIGKILL skips atexit, so the victim's arming-audit report being
        # ABSENT here is the expected post-kill state — a present report
        # with zero consultations is the failure raised above
        "chaos_report_after_kill": _load_chaos_report(chaos_report),
        "total_task_acks": total_acks,
        "expected_task_acks": expected_acks,
        "zero_recomputed_tasks": bool(zero_recompute),
        "master_fail_events": (
            master_stats["fail_events"] if master_stats else None
        ),
        "train_params_bit_identical": bool(bit_identical),
        "only_shed_or_timeout_failed": not fail_bad,
        "passed": bool(
            bit_identical and not fail_bad
            and (zero_recompute if kill == "kill_master" else True)
        ),
    }
    if takeover is not None:
        out["takeover"] = {
            k: takeover.get(k) for k in ("warm", "replayed_records",
                                         "takeover_s")
        }
    return out


# ---------------------------------------------------------------------------
# serving fleet drills (serving/router.py): an in-process router frontend
# over real ``python -m paddle_tpu_torch serve --register`` engine subprocesses
# ---------------------------------------------------------------------------

_ENGINE_SLOTS = 2


def _spawn_engine(engine_id: str, router_addr, seed: int = 0, extra=(),
                  device: str = "cuda"):
    """One fleet engine subprocess (``python -m paddle_tpu_torch serve
    --register``) on the tiny flagship and on `device`, BLAS pinned to one
    thread (N engines on one host must not fight over OpenMP pools).
    ``extra``: additional CLI args."""
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "serve",
         "--register", f"{router_addr[0]}:{router_addr[1]}",
         "--engine-id", engine_id,
         "--max-slots", str(_ENGINE_SLOTS), "--hbm-budget-mb", "2",
         "--src-vocab", str(_V), "--trg-vocab", str(_V),
         "--word-dim", str(_E), "--hidden-dim", str(_H),
         "--max-length", str(_MAXLEN), "--seed", str(seed),
         "--drain-timeout-s", "60", "--device", str(device)] + list(extra),
        env=_fleet_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )


def _wait_engines(router, n: int, timeout_s: float = 120.0,
                  procs=()) -> None:
    deadline = time.time() + timeout_s
    while len(router.live_engines()) < n:
        for p in procs:
            if p.poll() is not None:
                _out, err = _reap(p, 30.0)
                raise RuntimeError(
                    f"engine died before registering (rc {p.returncode}): "
                    f"{err[-2000:]}"
                )
        if time.time() > deadline:
            raise RuntimeError(
                f"only {len(router.live_engines())}/{n} engines registered "
                f"in {timeout_s}s"
            )
        time.sleep(0.05)  # lock: allow[C306] fleet-assembly poll over real subprocesses: wall-clock by design


def _prewarm_fleet(router) -> None:
    """Compile every engine's serve path BEFORE the measured window (the
    prewarm discipline, one tier up): each engine's slot rungs are
    exercised through its own data plane, so the drill's latencies and
    EWMAs measure dispatch under routing, not warm-up."""
    from paddle_tpu_torch import master as _master
    from paddle_tpu_torch.serving.router import ENGINE_METHODS

    engines = router.fleet_stats()["engines"]
    for k, (eid, view) in enumerate(sorted(engines.items())):
        addr = tuple(view["address"])
        for j, src_len in enumerate((5, 20)):
            # rung 2 as well: two concurrent requests batch on the engine
            def _one(i, n=src_len, a=addr):
                c = _master.Client(a, methods=ENGINE_METHODS,
                                   call_timeout_s=180.0, reconnect_tries=2)
                try:
                    c.serve(f"warm-{a[1]}-{n}-{i}", [2] * n, 4, None, None,
                            None)
                finally:
                    c.close()
            ts = [threading.Thread(target=_one, args=(i,),
                                   name="scenario-fleet-warm", daemon=True)
                  for i in range(_ENGINE_SLOTS)]
            for t in ts:
                t.start()
            for t in ts:
                _join(t, 240.0, f"the prewarm of engine {eid}")


def _journal_double_serves(journal_path: str) -> int:
    """Count request ids finalized MORE than once in the routing journal —
    the on-disk proof of the zero-double-serve contract."""
    done: Dict[str, int] = {}
    with open(journal_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("t") == "done" and rec.get("req"):
                done[rec["req"]] = done.get(rec["req"], 0) + 1
    return sum(1 for c in done.values() if c > 1)


def run_fleet_serving(workdir: str, n_engines: int = 2,
                      n_requests: int = 36, rate_rps: float = 6.0,
                      slo_ms: Optional[float] = None,
                      seed: int = 0, device=None) -> Dict[str, Any]:
    """The serving-fleet kill drill: N real engine processes
    behind the affinity router, open-loop deadline traffic, then SIGKILL
    one engine mid-window.  Gates: the dead engine is pruned via lease
    expiry (recovery time bounded), traffic re-routes to the survivors
    (goodput holds — only shed/timeout may fail), the disjoint fleet
    ledger sums to the offered count, and the routing journal finalizes
    every request id EXACTLY once (zero double-serves)."""
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.reader.loadgen import OpenLoopLoadGen, PrefixMixer
    from paddle_tpu_torch.serving import FleetClient, Request, Router

    device = str(resolve_device(device))  # each engine's --device
    d = os.path.abspath(workdir)
    os.makedirs(d, exist_ok=True)
    journal = os.path.join(d, "journal.jsonl")
    slo_s = (float(slo_ms) / 1e3) if slo_ms and slo_ms > 0 else 30.0
    lease_s = 1.5
    router = Router(
        address=("127.0.0.1", 0), journal_path=journal,
        lease_timeout_s=lease_s, stats_poll_s=0.1,
    )
    procs = []
    reqs: List[Any] = []
    kill_stamp: Dict[str, float] = {}
    try:
        procs = [
            _spawn_engine(f"eng{i}", router.address, seed, device=device)
            for i in range(n_engines)
        ]
        _wait_engines(router, n_engines, procs=procs)
        _prewarm_fleet(router)

        mixer = PrefixMixer(_V, pool_size=3, prefix_frac=0.5, seed=seed,
                            sessions=4)

        def mk(i):
            r = Request(
                mixer.source(i), 8, req_id=f"flt-{seed}-{i}",
                session_id=mixer.session_of(i),
            )
            reqs.append(r)
            return r

        victim = procs[0]

        def _kill_mid_window():
            # fire roughly a third into the arrival schedule
            time.sleep((n_requests / rate_rps) / 3.0)
            kill_stamp["t"] = time.time()
            victim.kill()

        killer = threading.Thread(target=_kill_mid_window,
                                  name="scenario-fleet-kill", daemon=True)
        fc = FleetClient(router.address)
        t0 = time.perf_counter()
        try:
            killer.start()
            OpenLoopLoadGen(
                rate_rps, n_requests, mk, seed=seed, deadline_s=slo_s,
            ).run(fc.submit)
            _wait_all(reqs)
        finally:
            fc.close()
            _join(killer, 60.0, "the engine killer")
        wall = time.perf_counter() - t0

        # the lease plane prunes the corpse; recovery = SIGKILL -> pruned
        deadline = time.time() + 4 * lease_s + 5.0
        while "eng0" in router.live_engines():
            if time.time() > deadline:
                raise RuntimeError("killed engine never pruned")
            time.sleep(0.02)  # lock: allow[C306] watches a REAL lease expire: wall-clock by design
        recovery_s = time.time() - kill_stamp["t"]
        victim.communicate(timeout=60)
        fleet = router.fleet_stats()
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        survivor_rcs = []
        for p in procs:
            if p.stdout is not None and not p.stdout.closed:
                _reap(p, 90.0)
            survivor_rcs.append(p.returncode)
        router.close()

    statuses = _status_counts(reqs)
    served = [r for r in reqs if r.status == "served"]
    lat = [r.t_done - r.t_submit for r in served]
    in_slo = [x for x in lat if x <= slo_s]
    fail_bad = [
        r for r in reqs if r.status not in ("served", "shed", "timeout")
    ]
    double_serves = _journal_double_serves(journal)
    ledger_total = sum(fleet["ledger"].values())
    return {
        "scenario": "fleet_serving",
        "n_engines": n_engines,
        "slo_ms": round(slo_s * 1e3, 3),
        "n_offered": len(reqs),
        "offered_rps": round(rate_rps, 2),
        "wall_s": round(wall, 3),
        "statuses": statuses,
        "goodput_frac": round(len(in_slo) / len(reqs), 4) if reqs else None,
        "p50_ms": _ms(_pct(lat, 0.50)),
        "p95_ms": _ms(_pct(lat, 0.95)),
        "p99_ms": _ms(_pct(lat, 0.99)),
        "recovery_after_kill_s": round(recovery_s, 3),
        "reroutes": fleet["reroutes"],
        "duplicates_discarded": fleet["duplicates_discarded"],
        "double_served": double_serves,
        "ledger": fleet["ledger"],
        "ledger_disjoint": ledger_total
        == fleet["ledger"]["served"] + fleet["ledger"]["shed"]
        + fleet["ledger"]["rejected"] + fleet["ledger"]["timeout"]
        + fleet["ledger"]["closed"],
        "survivor_rcs": survivor_rcs[1:],
        "passed": bool(
            not fail_bad
            and double_serves == 0
            and recovery_s <= 4 * lease_s + 5.0
            and len(in_slo) / len(reqs) >= 0.5
            and all(rc == 0 for rc in survivor_rcs[1:])
        ),
    }


def run_fleet_rolling_restart(workdir: str, n_engines: int = 2,
                              n_requests: int = 30, rate_rps: float = 4.0,
                              slo_ms: Optional[float] = None,
                              seed: int = 0, device=None) -> Dict[str, Any]:
    """The rolling-restart drill: drain+replace EVERY engine
    under live open-loop traffic — replacement registers first, then the
    old engine drains via the router's drain protocol and exits on
    SIGTERM.  Gates: every drain clean and every retired engine exits 0,
    the fleet never drops below N-1 live engines, and no request dies to
    the restart (only served/shed/timeout terminal states)."""
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.reader.loadgen import OpenLoopLoadGen, PrefixMixer
    from paddle_tpu_torch.serving import FleetClient, Request, Router

    device = str(resolve_device(device))  # each engine's --device
    d = os.path.abspath(workdir)
    os.makedirs(d, exist_ok=True)
    journal = os.path.join(d, "journal.jsonl")
    router = Router(
        address=("127.0.0.1", 0), journal_path=journal,
        lease_timeout_s=2.0, stats_poll_s=0.1,
    )
    procs: Dict[str, Any] = {}
    reqs: List[Any] = []
    min_live = [n_engines]
    stop_sampling = threading.Event()

    def _sample_live():
        while not stop_sampling.is_set():
            min_live[0] = min(min_live[0], len(router.live_engines()))
            time.sleep(0.05)  # lock: allow[C306] samples REAL fleet membership over a wall-clock drill window

    sampler = threading.Thread(target=_sample_live,
                               name="scenario-fleet-sample", daemon=True)
    drains: Dict[str, Any] = {}
    rcs: Dict[str, int] = {}
    try:
        for i in range(n_engines):
            procs[f"eng{i}"] = _spawn_engine(f"eng{i}", router.address, seed,
                                             device=device)
        _wait_engines(router, n_engines, procs=list(procs.values()))
        _prewarm_fleet(router)
        sampler.start()

        mixer = PrefixMixer(_V, pool_size=3, prefix_frac=0.5, seed=seed,
                            sessions=4)

        def mk(i):
            r = Request(
                mixer.source(i), 8, req_id=f"roll-{seed}-{i}",
                session_id=mixer.session_of(i),
            )
            reqs.append(r)
            return r

        fc = FleetClient(router.address)
        gen_done = threading.Event()
        gen_err: List[BaseException] = []

        def _offer():
            try:
                OpenLoopLoadGen(rate_rps, n_requests, mk, seed=seed).run(
                    fc.submit
                )
            except BaseException as e:  # noqa: BLE001 — reported by the join below
                gen_err.append(e)
            finally:
                gen_done.set()

        offerer = threading.Thread(target=_offer,
                                   name="scenario-fleet-offer", daemon=True)
        t0 = time.perf_counter()
        try:
            offerer.start()
            for i in range(n_engines):
                old = f"eng{i}"
                new = f"eng{n_engines + i}"
                # replacement FIRST: the fleet grows to N+1, drains to N,
                # and never dips below N-1 even transiently
                procs[new] = _spawn_engine(new, router.address, seed, device=device)
                _wait_engines(router, n_engines + 1,
                              procs=[procs[new]])
                clean = router.drain_engine(old, timeout_s=90.0)
                drains[old] = clean
                p = procs[old]
                if p.poll() is None:
                    p.send_signal(signal.SIGTERM)
                _reap(p, 90.0)
                rcs[old] = p.returncode
            _join(offerer, 300.0, "the open-loop offer")
            if gen_err:
                raise gen_err[0]
            _wait_all(reqs)
        finally:
            fc.close()
        wall = time.perf_counter() - t0
        fleet = router.fleet_stats()
    finally:
        stop_sampling.set()
        if sampler.is_alive():
            sampler.join(5.0)
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for name, p in procs.items():
            if name not in rcs:
                _reap(p, 90.0)
        router.close()

    statuses = _status_counts(reqs)
    fail_bad = [
        r for r in reqs if r.status not in ("served", "shed", "timeout")
    ]
    double_serves = _journal_double_serves(journal)
    return {
        "scenario": "fleet_rolling_restart",
        "n_engines": n_engines,
        "rotations": n_engines,
        "n_offered": len(reqs),
        "wall_s": round(wall, 3),
        "statuses": statuses,
        "drains_clean": drains,
        "retired_rcs": rcs,
        "min_live_engines": min_live[0],
        "double_served": double_serves,
        "reroutes": fleet["reroutes"],
        "ledger": fleet["ledger"],
        "passed": bool(
            not fail_bad
            and double_serves == 0
            and all(drains.values())
            and all(rc == 0 for rc in rcs.values())
            and min_live[0] >= n_engines - 1
            and statuses["served"] >= 1
        ),
    }


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

FAST_SCENARIOS = {
    "overload": lambda **kw: scenario_overload(**kw),
    "burst_overload": lambda **kw: scenario_overload(process="burst", **kw),
    "nan_request_under_load": lambda **kw: scenario_chaos_under_load(
        point="nan_request", **kw
    ),
    "slow_client_under_load": lambda **kw: scenario_chaos_under_load(
        point="serve_slow_client", **kw
    ),
    "mixed_train_serve": lambda **kw: scenario_mixed_train_serve(**kw),
    "partition_under_load": lambda **kw: scenario_partition_under_load(**kw),
    "trace_replay_drift": lambda **kw: scenario_trace_replay_drift(**kw),
}

SLOW_SCENARIOS = {
    "fleet_kill_worker": lambda workdir, **kw: run_fleet_chaos(
        workdir, kill="kill_worker", **kw
    ),
    "fleet_kill_master": lambda workdir, **kw: run_fleet_chaos(
        workdir, kill="kill_master", **kw
    ),
    "fleet_serving": lambda workdir, **kw: run_fleet_serving(
        workdir, **kw
    ),
    "fleet_rolling_restart": lambda workdir, **kw: run_fleet_rolling_restart(
        workdir, **kw
    ),
}


def run_scenario(name: str, **kw) -> Dict[str, Any]:
    if name in FAST_SCENARIOS:
        return FAST_SCENARIOS[name](**kw)
    if name in SLOW_SCENARIOS:
        return SLOW_SCENARIOS[name](**kw)
    raise KeyError(
        f"unknown scenario {name!r}; known: "
        f"{sorted(FAST_SCENARIOS) + sorted(SLOW_SCENARIOS)}"
    )
