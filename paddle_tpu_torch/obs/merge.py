"""Merge per-process trace files into ONE clock-skew-aligned timeline.

A launcher/scenario run leaves one ``trace-<role>-<pid>.json`` per
process (obs/tracer.py).  Each file's timestamps come from that
process's own monotonic clock — arbitrary epoch, so the files cannot be
concatenated raw.  Two alignment sources, coarse to fine:

1. **Wall anchors** — every trace records one (monotonic, wall) clock
   pair at tracer init; mapping each process onto the wall clock aligns
   to NTP precision (good enough for processes that never talk).
2. **RPC pairs** — the master RPC plane stamps every exchange with a
   correlation id on BOTH sides: the client span ``rpc_call:<method>``
   (dial→reply, args.rpc) and the server span ``rpc:<method>``
   (recv→send, same args.rpc).  The server's handling midpoint must sit
   at the client's exchange midpoint (the classic NTP offset estimate);
   the median residual over all pairs between two processes refines
   their relative offset to dispatch precision.  Offsets propagate over
   the RPC-pair graph by BFS from the reference process, so a worker
   that only ever talked to the master still aligns against a serving
   process on the master's side.

The merged file is a normal Chrome-trace JSON (open in Perfetto):
every event keeps its own pid/tid, timestamps are rebased onto the
reference process's clock, and ``otherData.offsets_us`` records the
per-process corrections applied.
"""

from __future__ import annotations

import glob
import json
import os
from statistics import median as _median
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["load_trace", "merge_traces", "merge_dir", "validate_trace"]

_REQUIRED_KEYS = ("ph", "ts", "pid", "tid", "name")


def load_trace(path: str) -> Dict[str, Any]:
    with open(path) as f:
        obj = json.load(f)
    if isinstance(obj, list):  # bare-array Chrome trace form
        obj = {"traceEvents": obj, "otherData": {}}
    if "traceEvents" not in obj:
        raise ValueError(f"{path}: not a Chrome-trace file (no traceEvents)")
    return obj


def validate_trace(obj: Dict[str, Any]) -> List[str]:
    """Schema problems of one trace object (empty list = valid):
    required keys on every event, well-formed args, balanced B/E pairing
    per (pid, tid) with matching names."""
    problems: List[str] = []
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents is not a list"]
    stacks: Dict[Tuple[Any, Any], List[str]] = {}
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        for k in _REQUIRED_KEYS:
            if k not in ev:
                problems.append(f"event {i}: missing key {k!r}")
        if "args" in ev and not isinstance(ev["args"], dict):
            problems.append(f"event {i}: args is not an object")
        ph = ev.get("ph")
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            stacks.setdefault(key, []).append(ev.get("name"))
        elif ph == "E":
            stack = stacks.setdefault(key, [])
            if not stack:
                # an E with no open B is the expected ring-wrap artifact
                # (the deque dropped its B with the oldest events) — ANY
                # orphan-E-on-empty-stack is explainable that way, so it
                # is never an error; only a LIFO violation below is
                continue
            if stack[-1] != ev.get("name"):
                problems.append(
                    f"event {i}: E {ev.get('name')!r} closes B "
                    f"{stack[-1]!r} on pid/tid {key}"
                )
            stack.pop()
    # Bs left open at the end are expected too: a dump can happen MID-SPAN
    # (the flight recorder fires inside spans by design).  The enforced
    # pairing invariant is the LIFO name discipline of the retained pairs.
    return problems


def _span_mids(evs: List[dict], prefix: str) -> Dict[str, float]:
    """{rpc_id: midpoint_ts} of every completed ``prefix``* span carrying
    an args.rpc correlation id, per the file's OWN clock."""
    open_: Dict[Tuple[Any, str], Tuple[float, Optional[str]]] = {}
    mids: Dict[str, float] = {}
    for ev in evs:
        name = ev.get("name", "")
        if not name.startswith(prefix):
            continue
        key = (ev.get("tid"), name)
        if ev.get("ph") == "B":
            open_[key] = (ev["ts"], (ev.get("args") or {}).get("rpc"))
        elif ev.get("ph") == "E" and key in open_:
            t0, rpc = open_.pop(key)
            if rpc is not None:
                mids[rpc] = (t0 + ev["ts"]) / 2.0
    return mids


def merge_traces(objs: List[Dict[str, Any]],
                 reference_pid: Optional[int] = None) -> Dict[str, Any]:
    """One merged trace object from per-process trace objects.  The
    reference process (default: the one with the most events) keeps its
    clock; every other process is shifted by the RPC-pair offset when an
    RPC path to the reference exists, else by the wall anchors."""
    if not objs:
        raise ValueError("nothing to merge")
    by_pid: Dict[int, Dict[str, Any]] = {}
    for obj in objs:
        other = obj.get("otherData", {})
        pid = other.get("pid")
        if pid is None:  # infer from the first real event
            pids = [e.get("pid") for e in obj["traceEvents"] if "pid" in e]
            pid = pids[0] if pids else len(by_pid)
        by_pid[int(pid)] = obj
    pids = sorted(by_pid)
    if reference_pid is None:
        reference_pid = max(
            pids, key=lambda p: (len(by_pid[p]["traceEvents"]), -p)
        )

    # wall-anchor deltas: ts + dw maps onto the wall clock
    dw: Dict[int, float] = {}
    for pid, obj in by_pid.items():
        anchor = obj.get("otherData", {}).get("clock_anchor") or {}
        if "wall_us" in anchor and "mono_us" in anchor:
            dw[pid] = anchor["wall_us"] - anchor["mono_us"]

    # RPC pair edges: offset o means t_server ~ t_client + o (both local)
    client_mids = {
        pid: _span_mids(obj["traceEvents"], "rpc_call:")
        for pid, obj in by_pid.items()
    }
    server_mids = {
        pid: _span_mids(obj["traceEvents"], "rpc:")
        for pid, obj in by_pid.items()
    }
    edges: Dict[Tuple[int, int], List[float]] = {}
    for cp in pids:
        for sp in pids:
            if cp == sp:
                continue
            common = set(client_mids[cp]) & set(server_mids[sp])
            if common:
                edges.setdefault((cp, sp), []).extend(
                    server_mids[sp][r] - client_mids[cp][r] for r in common
                )

    # BFS the pair graph from the reference, assigning per-process deltas
    # (ts + delta = reference clock); wall anchors fill the gaps
    delta: Dict[int, float] = {reference_pid: 0.0}
    frontier = [reference_pid]
    while frontier:
        nxt: List[int] = []
        for p in frontier:
            for (cp, sp), offs in edges.items():
                o = _median(offs)
                if cp == p and sp not in delta:
                    # t_ref = t_cp + delta[cp]; t_sp - o ~ t_cp
                    delta[sp] = delta[p] - o
                    nxt.append(sp)
                elif sp == p and cp not in delta:
                    delta[cp] = delta[p] + o
                    nxt.append(cp)
        frontier = nxt
    for pid in pids:
        if pid not in delta:
            if pid in dw and reference_pid in dw:
                delta[pid] = dw[pid] - dw[reference_pid]
            else:
                delta[pid] = 0.0

    merged: List[dict] = []
    for pid in pids:
        d = delta[pid]
        for ev in by_pid[pid]["traceEvents"]:
            ev = dict(ev)
            if ev.get("ph") != "M":
                ev["ts"] = round(ev["ts"] + d, 3)
            merged.append(ev)
    merged.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0)))
    trace_ids = {
        by_pid[p].get("otherData", {}).get("trace_id") for p in pids
    } - {None}
    return {
        "traceEvents": merged,
        "otherData": {
            "trace_id": sorted(trace_ids)[0] if trace_ids else None,
            "merged_pids": pids,
            "reference_pid": reference_pid,
            "offsets_us": {str(p): round(delta[p], 3) for p in pids},
            "rpc_pair_edges": {
                f"{cp}->{sp}": len(offs)
                for (cp, sp), offs in sorted(edges.items())
            },
            "roles": {
                str(p): by_pid[p].get("otherData", {}).get("role")
                for p in pids
            },
        },
    }


def merge_dir(trace_dir: str, out_path: Optional[str] = None,
              pattern: str = "trace-*.json") -> Tuple[Dict[str, Any], str]:
    """Merge every per-process trace file under ``trace_dir``; write the
    result to ``out_path`` (default ``<trace_dir>/merged.json``).
    Returns (merged object, written path)."""
    paths = sorted(glob.glob(os.path.join(trace_dir, pattern)))
    if not paths:
        raise FileNotFoundError(
            f"no {pattern} files under {trace_dir} — did the run set the "
            "trace_dir flag (PADDLE_TPU_TORCH_TRACE_DIR)?"
        )
    merged = merge_traces([load_trace(p) for p in paths])
    merged["otherData"]["merged_from"] = [os.path.basename(p) for p in paths]
    if out_path is None:
        out_path = os.path.join(trace_dir, "merged.json")
    with open(out_path, "w") as f:
        json.dump(merged, f)
    return merged, out_path
