"""Divergence-localizing numerics sanitizer — the runtime leg of the
numerics plane; the counterpart of ``paddle_tpu/analysis/num_sanitizer.py``.

The divergence sentinel (robustness/sentinel.py and the step's own check in
trainer/step.py) detects that a step went non-finite and skips it, but it
cannot say WHICH op produced the first NaN/inf.  Armed by the
``num_sanitizer`` flag (``PADDLE_TPU_TORCH_NUM_SANITIZER=1``), the trainer
keeps a host copy of each step's inputs BEFORE the step updates the
parameters in place, and when the sentinel flags a step, the step is traced
(``trace_lint.trace_step``) on that copy and its graph re-executed **node
by node** (``torch.fx.Interpreter``, each value freed after its last use):

* the first node whose output is non-finite is named, with the layer that
  issued it and its source line (``meta["layer"]``, ``meta["site"]``);
  a flash-attention custom op is one node, and re-executing it launches
  the kernel;
* every input of the offending node gets max-abs / non-finite-count stats
  folded into StatSet ``num/<node>/in<j>_max_abs`` rows (non-finite
  observations land in the stat's own bucket), and the whole postmortem
  rides the flight-recorder dump (``flight-<pid>.json``,
  ``otherData.numerics``).

The JAX package steps into its scans and conds; the port's loops are
Python loops, unrolled in the trace, so every node is already a primitive.

Unarmed, the training path is untouched: no sanitizer is built, nothing is
captured or copied (``num_sanitizer/captures`` stays zero), and the
parameters are bit-identical either way (the sanitizer only observes).
"""

from __future__ import annotations

import logging
import math
from typing import Any, Dict, List, Optional

import torch

from paddle_tpu_torch.utils.timers import global_stats

__all__ = ["NumericsSanitizer", "num_sanitizer_armed", "find_first_nonfinite"]

_log = logging.getLogger("paddle_tpu_torch.analysis.num_sanitizer")


def num_sanitizer_armed() -> bool:
    """The ``num_sanitizer`` flag (environment:
    ``PADDLE_TPU_TORCH_NUM_SANITIZER``)."""
    from paddle_tpu_torch.utils import flags as _flags

    return bool(_flags.get_flag("num_sanitizer"))


# ---------------------------------------------------------------------------
# the node-by-node interpreter
# ---------------------------------------------------------------------------


class _Found(Exception):
    """Raised by the interpreter at the first non-finite-producing node;
    carries the postmortem record."""

    def __init__(self, record: Dict[str, Any]):
        super().__init__(record.get("primitive", "?"))
        self.record = record


def _tensors(x) -> List[torch.Tensor]:
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nonfinite(x) -> bool:
    return any(t.is_floating_point() and t.numel() and not bool(torch.isfinite(t).all())
               for t in _tensors(x))


def _val_stats(x) -> Dict[str, Any]:
    """Shape/dtype/max-abs/non-finite-count summary of one value."""
    if not torch.is_tensor(x):
        return {"shape": [], "dtype": type(x).__name__}
    out: Dict[str, Any] = {"shape": list(x.shape), "dtype": str(x.dtype).replace("torch.", "")}
    if x.is_floating_point() and x.numel():
        fin = torch.isfinite(x)
        n_bad = int(x.numel() - int(fin.sum()))
        absx = torch.where(fin, x.abs(), torch.zeros((), dtype=x.dtype, device=x.device))
        out["max_abs"] = float(absx.max().float()) if n_bad < x.numel() else None
        out["n_nonfinite"] = n_bad
    return out


def _record(node, idx: int, invals, outs) -> Dict[str, Any]:
    from paddle_tpu_torch.analysis.trace_lint import node_layer, node_site, op_name

    src, line = node_site(node)
    name = op_name(node)
    return {
        "node": f"{idx}:{name}",
        "primitive": name,
        "layer": node_layer(node),
        "source": src,
        "line": line,
        "backward": bool(node.meta.get("backward")),
        "inputs": [_val_stats(x) for x in invals],
        "outputs": [_val_stats(x) for x in _tensors(outs)],
    }


# data movement: a move of a value that is already non-finite only
# propagates it, so the record names the op that computes with it instead
_MOVES = frozenset({
    "aten.view", "aten._unsafe_view", "aten.reshape", "aten.expand", "aten.permute",
    "aten.t", "aten.transpose", "aten.squeeze", "aten.unsqueeze", "aten.slice",
    "aten.select", "aten.alias", "aten.clone", "aten.contiguous", "aten.detach",
    "aten._to_copy", "aten.copy", "aten.copy_", "aten.lift_fresh_copy", "aten.cat",
    "aten.stack", "aten.split", "aten.split_with_sizes", "aten.unbind", "getitem",
})


def _interpreter(gm):
    from paddle_tpu_torch.analysis.trace_lint import op_name

    class FirstNonfinite(torch.fx.Interpreter):
        """Runs the graph node by node (values freed after their last use)
        and stops at the first call whose output holds a NaN or an inf."""

        def __init__(self):
            super().__init__(gm, garbage_collect_values=True)
            self.index = {n: i for i, n in enumerate(gm.graph.nodes)}

        def run_node(self, n):
            out = super().run_node(n)
            if n.op == "call_function" and _nonfinite(out):
                args = self.map_nodes_to_values(n.args, n)
                kwargs = self.map_nodes_to_values(n.kwargs, n)
                flat = _tensors(list(args) + list(kwargs.values()))
                if op_name(n) in _MOVES and any(_nonfinite(t) for t in flat):
                    return out  # propagated, not produced
                raise _Found(_record(n, self.index[n], flat, out))
            return out

    return FirstNonfinite()


def find_first_nonfinite(fn, args) -> Optional[Dict[str, Any]]:
    """Trace ``fn`` on ``args`` and re-execute its graph node by node on a
    fresh copy of ``args``; returns the postmortem record of the first
    non-finite-producing node (with ``poisoned_inputs`` naming any input
    leaves that were ALREADY non-finite — the poisoned-feed case), or None
    when every value stays finite."""
    from paddle_tpu_torch.analysis.trace_lint import _clone_leaf, _flatten, trace_step

    traced = trace_step(fn, *args)
    leaves: List[torch.Tensor] = []
    labels: List[str] = []
    for i, a in enumerate(args):
        _flatten(a, f"arg{i}", leaves, labels)
    flat = [_clone_leaf(t) for t in leaves]
    poisoned = [{"input": lbl, **_val_stats(v)}
                for lbl, v in zip(labels, flat) if _nonfinite(v)]
    try:
        with torch.no_grad():
            _interpreter(traced.graph_module).run(*flat)
    except _Found as f:
        rec = f.record
        rec["poisoned_inputs"] = poisoned
        return rec
    if poisoned:
        # inputs were poisoned but nothing downstream blew up (masked away)
        return {"node": None, "primitive": None, "poisoned_inputs": poisoned,
                "inputs": [], "outputs": []}
    return None


# ---------------------------------------------------------------------------
# the trainer-facing sanitizer
# ---------------------------------------------------------------------------


def _host_copy(tree):
    """`tree` with every tensor copied to the host (the lengths' host
    copies ride along); other values as they are."""
    from paddle_tpu_torch.analysis.trace_lint import _flatten

    leaves: List[torch.Tensor] = []
    rebuild = _flatten(tree, "", leaves, [])
    copies = []
    for t in leaves:
        c = t.detach().to("cpu", copy=True)
        host = getattr(t, "_host_lengths", None)
        if host is not None:
            c._host_lengths = host
        copies.append(c)
    return rebuild(iter(copies))


def _to_device(tree, device):
    from paddle_tpu_torch.analysis.trace_lint import _flatten

    leaves: List[torch.Tensor] = []
    rebuild = _flatten(tree, "", leaves, [])
    moved = []
    for t in leaves:
        m = t.to(device)
        host = getattr(t, "_host_lengths", None)
        if host is not None:
            m._host_lengths = host
        moved.append(m)
    return rebuild(iter(moved))


class NumericsSanitizer:
    """Pre-step input capture + postmortem driver for one trainer.

    ``step_body`` is the train step's own body without the sentinel's
    decision (the same ``_train_step_body`` the trainer runs), traced fresh
    on the captured arguments — re-execution on a copy, with no effect on
    the training trajectory."""

    def __init__(self, step_body, stats=None):
        self._step_body = step_body
        self._stats = stats if stats is not None else global_stats
        self._captured = None
        self._device = None
        self._where = ""

    @classmethod
    def for_trainer(cls, trainer) -> "NumericsSanitizer":
        from paddle_tpu_torch.trainer.step import _train_step_body

        # sentinel=False: the postmortem wants the raw computation — the
        # skip decision would otherwise sit between the first NaN and the
        # metrics
        body = _train_step_body(trainer.network, trainer.optimizer, trainer._metrics_fn,
                                sentinel=False, prune_masks=trainer._prune_masks)
        return cls(body)

    def capture(self, params, state, opt_state, batch, rng, where: str = "") -> None:
        """Host-copy this step's inputs BEFORE the step updates the
        parameters in place.  Armed-mode cost only; the unarmed trainer
        never constructs this object."""
        self._stats.incr("num_sanitizer/captures")
        from paddle_tpu_torch.utils.tree import leaves

        first = next((v for v in leaves(params) if torch.is_tensor(v)), None)
        self._device = first.device if first is not None else torch.device("cpu")
        self._captured = _host_copy((params, state, opt_state, batch, rng))
        self._where = where

    def postmortem(self, reason: str) -> Optional[Dict[str, Any]]:
        """Re-execute the captured step node by node and dump the numerics
        postmortem into the flight recorder.  Never raises."""
        if self._captured is None:
            return None
        try:
            args = _to_device(self._captured, self._device)
            rec = find_first_nonfinite(self._step_body, args)
        except Exception:  # noqa: BLE001 — a postmortem must never crash
            _log.exception("numerics postmortem failed (%s)", reason)
            return None
        if rec is None:
            _log.warning("numerics sanitizer: %s but the re-executed step is finite "
                         "everywhere (non-determinism or fetch-side issue)", reason)
            return None
        rec["reason"] = reason
        rec["where"] = self._where
        tag = rec.get("node") or "input-only"
        for j, s in enumerate(rec.get("inputs", ())):
            if s.get("max_abs") is not None:
                self._stats.observe(f"num/{tag}/in{j}_max_abs", s["max_abs"])
            if s.get("n_nonfinite"):
                self._stats.observe(f"num/{tag}/in{j}_max_abs", math.nan)
        _log.error("numerics postmortem (%s): first non-finite at %s layer=%s %s:%s "
                   "poisoned=%s", reason, tag, rec.get("layer"), rec.get("source"),
                   rec.get("line"), [p["input"] for p in rec.get("poisoned_inputs", ())])
        from paddle_tpu_torch import obs as _obs

        rec["flight_dump"] = _obs.flight_dump(f"num-sanitizer: {reason}",
                                              extra={"numerics": rec})
        return rec

