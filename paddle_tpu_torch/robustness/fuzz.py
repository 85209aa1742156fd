"""Coverage-guided chaos-composition fuzzer — seeded fault cocktails; the
counterpart of ``paddle_tpu/robustness/fuzz.py``.

Every chaos drill before this plane exercised ONE fault shape at a time
(a netem partition, a SIGKILL, a NaN request) against a hand-written
scenario.  Production outages are compositions: a burst arrival wave
lands WHILE the network duplicates frames and a worker stalls.  This
module samples seeded compositions from the existing fault vocabulary
(robustness/chaos.py points x robustness/netem.py link faults x the
open-loop arrival processes), runs each against the invariant set every
plane already promises, and ddmin-shrinks any violation to a minimal
replayable spec — the JAX package's interleave explorer's shrink/replay
contract (``paddle_tpu/analysis/interleave.py``) applied to whole-process
fault cocktails.  A spec file is the same JSON in both packages.

A composition is a list of declarative **axis items** (each one
independently removable, which is what makes ddmin meaningful):

* ``arrival`` — the offered-load shape: process (poisson / uniform /
  burst) and a rate factor over the engine's calibrated saturation
  (2.0 = overload; the shed-not-collapse regime).
* ``serve_chaos`` — a serving fault point (``nan_request`` /
  ``serve_slow_client``) armed at a sampled occurrence mid-window.
* ``netem`` — a link fault (``net_delay`` / ``net_drop`` / ``net_dup``
  / ``net_corrupt`` / ``net_partition``) on the CLIENT role of a real
  RPC training leg (scenarios._rpc_training_leg) that runs on a side
  thread WHILE the serving window is live.
* ``train_chaos`` — ``worker_hang`` (a bounded stall) on that leg.
* ``checkpoint`` — ``torn_checkpoint`` at save 1 or 2 of a two-save
  CheckpointManager cycle (restore must fall back, never load garbage).

Invariants checked after every composition (violations are strings —
the spec's ``violations`` field):

* every offered request reaches a TERMINAL status and the status ledger
  sums disjointly to the offered count;
* the faulted training leg's final params are BIT-IDENTICAL to an
  unfaulted reference leg and its journal lints clean;
* a torn checkpoint is never restored — ``restore_latest`` falls back
  to the intact step;
* zero leaked framework threads and zero leaked KV pages after
  teardown;
* every ARMED point was actually consulted (the arming audit —
  ``chaos.consult_report``): a composition that never drives its fault
  site proved nothing, and silently proving nothing is itself a bug.

``planted="ledger_skew"`` plants a detectable bookkeeping bug (the
served count over-reports by one, but only under an overload arrival
item) — the canary that proves the detect -> shrink -> replay pipeline
end-to-end (``python -m paddle_tpu_torch fuzz --plant ledger_skew``): the batch must flag it, ddmin must shrink
the composition to the single overload item, and ``--replay`` of the
shrunk spec must reproduce it (exit 0 iff reproduced).

The serving engine runs on the card unless the caller asks for the CPU
(``device="cpu"``); every wait is bounded (a request, the training leg and
the teardown of the scheduler's threads each have a limit, past which the
composition records a violation).
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = [
    "FUZZ_SPEC_VERSION",
    "sample_composition",
    "run_composition",
    "shrink_items",
    "fuzz_batch",
    "replay_fuzz_spec",
    "load_spec",
    "save_spec",
]

FUZZ_SPEC_VERSION = 1

_SERVE_POINTS = ("nan_request", "serve_slow_client")
_NETEM_POINTS = ("net_delay", "net_drop", "net_dup", "net_corrupt",
                 "net_partition")
_RATE_FACTORS = (0.5, 1.0, 2.0)
_PROCESSES = ("poisson", "uniform", "burst")

# per-process caches: the engine's calibrated saturation rate and the
# unfaulted reference training leg (both deterministic, both costly — a
# 25-composition batch pays each exactly once)
_saturation_cache: Dict[int, float] = {}
_train_ref: Dict[str, Any] = {}


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def sample_composition(rng: random.Random) -> List[Dict[str, Any]]:
    """One seeded composition: the arrival axis always, each fault axis
    with its own probability.  Axis items are plain dicts — declarative,
    JSON-able, independently removable (the ddmin unit)."""
    items: List[Dict[str, Any]] = [{
        "axis": "arrival",
        "process": rng.choice(_PROCESSES),
        "rate_factor": rng.choice(_RATE_FACTORS),
    }]
    if rng.random() < 0.5:
        items.append({
            "axis": "serve_chaos",
            "point": rng.choice(_SERVE_POINTS),
            "occurrence": rng.randint(2, 8),
        })
    if rng.random() < 0.4:
        point = rng.choice(_NETEM_POINTS)
        item = {
            "axis": "netem",
            "point": point,
            "occurrence": rng.randint(2, 10),
        }
        if point == "net_partition":
            item["partition_secs"] = round(rng.uniform(0.5, 1.2), 2)
        items.append(item)
    if rng.random() < 0.3:
        items.append({
            "axis": "train_chaos",
            "point": "worker_hang",
            "occurrence": rng.randint(1, 2),
            "hang_secs": round(rng.uniform(0.5, 1.5), 2),
        })
    if rng.random() < 0.3:
        items.append({
            "axis": "checkpoint",
            "point": "torn_checkpoint",
            "occurrence": rng.randint(1, 2),
        })
    return items


# ---------------------------------------------------------------------------
# the composition runner
# ---------------------------------------------------------------------------

def _saturation_rps(engine, seed: int = 0) -> float:
    """Calibrate (once per engine) the analytical saturation rate the
    rate factors scale — the overload scenario's discipline."""
    key = id(engine)
    if key not in _saturation_cache:
        from paddle_tpu_torch.robustness.scenarios import _serve_window, _srcs

        wave = _serve_window(engine, _srcs(seed, 16), None, 0.0, seed)
        _saturation_cache[key] = (
            engine.max_slots / (wave["mean_service_ms"] / 1e3)
        )
    return _saturation_cache[key]


def _reference_leg(workdir: str) -> Dict[str, Any]:
    """The unfaulted RPC training leg every faulted leg diffs against
    (bit-identity) — computed once per process, chaos disarmed."""
    if not _train_ref:
        from paddle_tpu_torch.robustness.scenarios import _rpc_training_leg

        _train_ref.update(
            _rpc_training_leg(os.path.join(workdir, "reference"), seed=0)
        )
    return _train_ref


def _items_by_axis(items: Sequence[Dict[str, Any]]) -> Dict[str, Dict]:
    """Last item per axis wins (a shrunk spec never holds duplicates;
    a hand-edited one gets deterministic behavior)."""
    out: Dict[str, Dict] = {}
    for it in items:
        out[str(it.get("axis"))] = dict(it)
    return out


def _new_framework_threads(baseline: set) -> List[str]:
    from paddle_tpu_torch.analysis.lock_sanitizer import THREAD_PREFIX

    return sorted(
        t.name for t in threading.enumerate()
        if t.name.startswith(THREAD_PREFIX) and t.name not in baseline
        and t.is_alive()
    )


def run_composition(items: Sequence[Dict[str, Any]], *,
                    engine=None, workdir: Optional[str] = None,
                    planted: Optional[str] = None,
                    n_requests: int = 16, device=None) -> Dict[str, Any]:
    """Run one composition and check the invariant set.  Returns
    ``{violations, observed}`` — empty ``violations`` means every plane
    kept its promise under this cocktail.  Deterministic given (items,
    engine state): the same spec replays to the same verdict, which is
    what makes ddmin-shrunk specs regression tests."""
    import numpy as np

    from paddle_tpu_torch import master_journal as _mj
    from paddle_tpu_torch import master_wire as _wire
    from paddle_tpu_torch.reader.loadgen import OpenLoopLoadGen
    from paddle_tpu_torch.robustness import chaos, netem
    from paddle_tpu_torch.robustness.scenarios import (
        _rpc_training_leg,
        _srcs,
        make_serving_engine,
    )
    from paddle_tpu_torch.serving import Request, ServingScheduler, status_counts
    from paddle_tpu_torch.serving.scheduler import TERMINAL_STATUSES

    import tempfile

    if workdir is None:
        workdir = tempfile.mkdtemp(prefix="paddle-tpu-torch-fuzz-")
    os.makedirs(workdir, exist_ok=True)
    engine = engine if engine is not None else make_serving_engine(0, device=device)
    axes = _items_by_axis(items)
    violations: List[str] = []
    observed: Dict[str, Any] = {}
    baseline_threads = {t.name for t in threading.enumerate()}

    # --- arm the whole cocktail at once (a composition is CONCURRENT) ---
    arrival = axes.get("arrival", {})
    rate_factor = float(arrival.get("rate_factor", 0.5))
    process = str(arrival.get("process", "uniform"))
    spec_parts: List[str] = []
    hang_secs = None
    for axis in ("serve_chaos", "netem", "train_chaos", "checkpoint"):
        it = axes.get(axis)
        if it:
            spec_parts.append(f"{it['point']}@{int(it['occurrence'])}")
            if "hang_secs" in it:
                hang_secs = float(it["hang_secs"])
    want_train = "netem" in axes or "train_chaos" in axes

    env_keys = ("PADDLE_TPU_TORCH_CHAOS_HANG_SECS", "PADDLE_TPU_TORCH_NETEM_ROLE",
                "PADDLE_TPU_TORCH_NETEM_PARTITION_SECS")
    env_prev = {k: os.environ.get(k) for k in env_keys}
    os.environ["PADDLE_TPU_TORCH_CHAOS_HANG_SECS"] = str(hang_secs or 1.0)
    if "netem" in axes:
        os.environ["PADDLE_TPU_TORCH_NETEM_ROLE"] = "client"
        os.environ["PADDLE_TPU_TORCH_NETEM_PARTITION_SECS"] = str(
            axes["netem"].get("partition_secs", 1.0)
        )
    saturation = _saturation_rps(engine)
    if want_train:
        _reference_leg(workdir)  # built with chaos DISARMED
    _wire.counters.reset()
    netem.reset()
    chaos.arm(",".join(spec_parts))
    faulted: dict = {}
    trainer = None
    try:
        if want_train:
            # a fresh directory per faulted leg: a master restores the
            # snapshot it finds, so a leg in an earlier leg's directory
            # would resume a finished job and never lease a task
            trainer = threading.Thread(
                target=_rpc_training_leg,
                args=(tempfile.mkdtemp(prefix="faulted-", dir=workdir),),
                kwargs={"seed": 0, "out": faulted},
                name="fuzz-train", daemon=True,
            )
            trainer.start()

        # --- the serving window (no calibration submits: occurrence 1
        # of a serving point must be reachable by a shrunk spec) --------
        reqs: List[Any] = []
        delivered: List[Any] = []
        all_srcs = _srcs(7, n_requests)

        def mk(i):
            # real callbacks: serve_slow_client freezes a client CALLBACK,
            # so the delivery thread needs one to freeze
            r = Request(all_srcs[i % len(all_srcs)],
                        callback=delivered.append)
            reqs.append(r)
            return r

        with ServingScheduler(engine) as sched:
            OpenLoopLoadGen(
                max(rate_factor * saturation, 1.0), n_requests, mk,
                seed=11, process=process, deadline_s=0.4,
            ).run(sched.submit)
            for r in reqs:
                if not r.wait(120):
                    violations.append(f"request_never_finalized:{r.req_id}")
        if trainer is not None:
            trainer.join(180.0)
            if trainer.is_alive():
                violations.append("train_leg_hung")

        # --- checkpoint axis: two saves, torn at the sampled one -------
        if "checkpoint" in axes:
            from paddle_tpu_torch.checkpoint import CheckpointManager

            ckdir = os.path.join(
                workdir, f"ck-{int(time.time() * 1e6) & 0xFFFFFF}"
            )
            mgr = CheckpointManager(ckdir)
            states = {
                1: {"w": np.full(4, 1.0, np.float32)},
                2: {"w": np.full(4, 2.0, np.float32)},
            }
            for step, tree in states.items():
                mgr.save(step, tree)
            got = mgr.restore_latest({"w": np.zeros(4, np.float32)})
            if got is None:
                violations.append("checkpoint_restore_none")
            else:
                step, tree, _extra = got
                want = states.get(step)
                if want is None or not np.array_equal(tree["w"], want["w"]):
                    violations.append(
                        f"torn_checkpoint_restored_garbage:step={step}"
                    )
                torn = int(axes["checkpoint"]["occurrence"])
                if step == torn and torn in states:
                    violations.append(
                        f"restored_the_torn_step:step={step}"
                    )
                observed["checkpoint_restored_step"] = step

        # --- invariants -------------------------------------------------
        counts = status_counts(reqs)
        if planted == "ledger_skew" and rate_factor >= 2.0:
            # the planted canary bug: the served ledger over-reports by
            # one under overload — detectable, shrinkable, replayable
            counts["served"] += 1
        bad_status = [
            f"non_terminal_status:{r.req_id}:{r.status}"
            for r in reqs if r.status not in TERMINAL_STATUSES
        ]
        violations.extend(bad_status)
        if not bad_status and sum(counts.values()) != len(reqs):
            violations.append(
                f"ledger_sum_mismatch:offered={len(reqs)}"
                f":sum={sum(counts.values())}"
            )
        observed["statuses"] = counts
        observed["n_offered"] = len(reqs)

        if want_train:
            ref = _train_ref
            params = faulted.get("params")
            if params is None:
                violations.append("train_leg_no_params")
            elif not all(
                np.array_equal(params[k], ref["params"][k])
                for k in ref["params"]
            ):
                violations.append("train_params_diverged")
            jpath = faulted.get("journal_path")
            if jpath and os.path.exists(jpath):
                for f in _mj.verify_journal(jpath):
                    violations.append(
                        f"journal_lint:{f.get('rule')}:{f.get('message')}"
                    )
            else:
                violations.append("no_surviving_journal")
            observed["train_tasks_done"] = faulted.get("tasks_done")

        # the arming audit: an armed-but-never-consulted point means the
        # composition never drove its fault site — it proved nothing
        report = chaos.consult_report()
        observed["chaos_report"] = report
        for point, rec in report.items():
            if rec["consultations"] == 0:
                violations.append(f"armed_never_consulted:{point}")
    finally:
        chaos.disarm()
        netem.reset()
        for k, v in env_prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    if engine.pages.n_used != 0:
        violations.append(f"leaked_pages:{engine.pages.n_used}")
    deadline = time.time() + 3.0
    leaked = _new_framework_threads(baseline_threads)
    while leaked and time.time() < deadline:
        time.sleep(0.05)  # lock: allow[C306] teardown grace for exiting scheduler threads in a real drill
        leaked = _new_framework_threads(baseline_threads)
    if leaked:
        violations.append(f"leaked_threads:{','.join(leaked)}")
    return {"violations": violations, "observed": observed}


# ---------------------------------------------------------------------------
# shrink + batch + replay (the interleave explorer's contract)
# ---------------------------------------------------------------------------

def shrink_items(items: Sequence[Dict[str, Any]],
                 fails: Callable[[Sequence[Dict[str, Any]]], bool],
                 max_rounds: int = 64) -> List[Dict[str, Any]]:
    """ddmin over axis items: the smallest sub-list that still violates
    (complement testing with chunk halving, then a greedy single-item
    pass — the JAX package's ``analysis/interleave.py`` ``shrink_events``
    over a different event type)."""
    current = list(items)
    if not fails(current):
        return current  # not reproducible: return as-is, caller decides
    n = 2
    rounds = 0
    while len(current) >= 2 and rounds < max_rounds:
        rounds += 1
        chunk = max(1, len(current) // n)
        reduced = False
        for i in range(0, len(current), chunk):
            cand = current[:i] + current[i + chunk:]
            if cand and fails(cand):
                current = cand
                n = max(n - 1, 2)
                reduced = True
                break
        if not reduced:
            if chunk == 1:
                break
            n = min(n * 2, len(current))
    i = 0
    while i < len(current) and rounds < max_rounds * 2:
        rounds += 1
        cand = current[:i] + current[i + 1:]
        if cand and fails(cand):
            current = cand
        else:
            i += 1
    return current


def _spec(seed: Optional[int], index: Optional[int],
          items: List[Dict[str, Any]], planted: Optional[str],
          violations: List[str]) -> Dict[str, Any]:
    return {
        "version": FUZZ_SPEC_VERSION,
        "kind": "chaos-fuzz",
        "seed": seed,
        "index": index,
        "items": items,
        "planted": planted,
        "violations": violations,
    }


def fuzz_batch(count: int = 25, seed: int = 0, *, engine=None,
               workdir: Optional[str] = None,
               planted: Optional[str] = None, shrink: bool = True,
               n_requests: int = 16,
               log: Optional[Callable[[str], None]] = None,
               device=None) -> Dict[str, Any]:
    """Run ``count`` seeded compositions (composition ``i`` samples from
    ``random.Random(f"{seed}:{i}")`` — any batch subset replays
    independently, the explorer's seeding discipline).  Stops at the
    first violation; with ``shrink`` the composition is ddmin-minimized
    and returned as a replayable spec."""
    from paddle_tpu_torch.robustness.scenarios import make_serving_engine

    engine = engine if engine is not None else make_serving_engine(0, device=device)

    def _run(items):
        return run_composition(items, engine=engine, workdir=workdir,
                               planted=planted, n_requests=n_requests)

    for i in range(int(count)):
        items = sample_composition(random.Random(f"{seed}:{i}"))
        out = _run(items)
        if log is not None:
            log(
                f"composition {i}: "
                f"{'+'.join(it['axis'] for it in items)} -> "
                f"{len(out['violations'])} violation(s)"
            )
        if out["violations"]:
            if shrink:
                items = shrink_items(
                    items, lambda cand: bool(_run(cand)["violations"])
                )
                out = _run(items)
            return {
                "violation_found": True,
                "compositions_run": i + 1,
                "spec": _spec(seed, i, list(items), planted,
                              out["violations"]),
            }
    return {"violation_found": False, "compositions_run": int(count),
            "spec": None}


def replay_fuzz_spec(spec: Dict[str, Any], *, engine=None,
                     workdir: Optional[str] = None, device=None) -> Dict[str, Any]:
    """Re-run a shrunk violation spec (``python -m paddle_tpu_torch fuzz
    --replay``).
    Returns ``{violations, reproduced}`` — ``reproduced`` means the
    replay violated again, the regression-test contract (the CLI exits
    0 iff reproduced)."""
    if spec.get("kind") != "chaos-fuzz":
        raise ValueError(
            f"not a chaos-fuzz spec (kind={spec.get('kind')!r})"
        )
    if spec.get("version") != FUZZ_SPEC_VERSION:
        raise ValueError(
            f"unsupported fuzz spec version {spec.get('version')!r}"
        )
    out = run_composition(
        spec.get("items", ()), engine=engine, workdir=workdir,
        planted=spec.get("planted"), device=device,
    )
    return {
        "violations": out["violations"],
        "observed": out["observed"],
        "reproduced": bool(out["violations"]),
    }


def save_spec(spec: Dict[str, Any], path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(spec, indent=1, sort_keys=True) + "\n")
    os.replace(tmp, path)


def load_spec(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)
