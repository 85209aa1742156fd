"""Diagnostics: per-layer timing and parameter statistics — the counterpart
of the JAX package's ``utils/debug.py``.

Reference counterparts: the per-layer REGISTER_TIMER_INFO forward timers of
NeuralNetwork.cpp:247 (:func:`profile_layers`, which runs the graph
layer at a time with a device synchronise per layer: the numbers include
launch overhead, so use them for relative cost and the profiler for
truth), the show_parameter_stats_period logging of
TrainerInternal.cpp:83-110 (:func:`parameter_stats`, which
``SGD.train(show_parameter_stats_period=N)`` logs) and the
gradient_printer_evaluator (:func:`gradient_stats`)."""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from paddle_tpu_torch.utils.tree import dotted, leaf_paths


def profile_layers(
    network,
    params,
    batch,
    state=None,
    train: bool = False,
    rng=None,
    repeats: int = 3,
) -> List[Tuple[str, str, float]]:
    """[(layer_name, type, best_ms)] forward cost per layer, eager with a
    device synchronise per layer (reference FwdTimer per layer)."""
    topo = network.topology
    results: List[Tuple[str, str, float]] = []

    # run once through apply() to obtain every layer's output for reuse as
    # the timed layer's inputs (so each layer is timed in isolation)
    with torch.no_grad():
        outs, _ = network.apply(params, batch, state=state, train=train, rng=rng)

    for name in topo.order:
        conf = topo.layers[name]
        impl = network._impls[name]
        if conf.type in ("data", "step_input", "memory"):
            continue
        # identical param resolution + mixed-precision casts as training
        p, ins = network.resolve_layer_call(name, params, [outs[i] for i in conf.inputs])

        @torch.no_grad()
        def run_once():
            ctx = network.make_context(train=train, rng=rng, state=state)
            ctx.outputs.update(outs)
            out = impl.apply(conf, p, ins, ctx)
            if out.data.is_cuda:
                torch.cuda.synchronize(out.data.device)
            return out

        run_once()  # warm
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            run_once()
            best = min(best, (time.perf_counter() - t0) * 1000.0)
        results.append((name, conf.type, best))
    return results


def format_layer_profile(rows: List[Tuple[str, str, float]]) -> str:
    total = sum(r[2] for r in rows)
    lines = [f"{'layer':<32} {'type':<20} {'ms':>9} {'%':>6}"]
    for name, typ, ms in sorted(rows, key=lambda r: -r[2]):
        lines.append(f"{name:<32} {typ:<20} {ms:9.3f} {100 * ms / max(total, 1e-9):6.1f}")
    lines.append(f"{'TOTAL':<32} {'':<20} {total:9.3f}")
    return "\n".join(lines)


def parameter_stats(params) -> Dict[str, Dict[str, float]]:
    """{dotted_name: {min, max, avg, abs_avg, size}} over a parameter tree,
    reduced in float64 on the host."""
    out: Dict[str, Dict[str, float]] = {}
    for path, v in leaf_paths(params):
        a = v.detach().to(torch.float64).cpu().numpy() if torch.is_tensor(v) else np.asarray(v, np.float64)
        out[".".join(path)] = {
            "min": float(a.min()) if a.size else 0.0,
            "max": float(a.max()) if a.size else 0.0,
            "avg": float(a.mean()) if a.size else 0.0,
            "abs_avg": float(np.abs(a).mean()) if a.size else 0.0,
            "size": int(a.size),
        }
    return out


def format_parameter_stats(stats: Dict[str, Dict[str, float]]) -> str:
    lines = [f"{'parameter':<40} {'size':>9} {'avg':>11} {'abs_avg':>11} {'min':>11} {'max':>11}"]
    for name in sorted(stats):
        s = stats[name]
        lines.append(
            f"{name:<40} {s['size']:>9} {s['avg']:>11.4g} {s['abs_avg']:>11.4g} "
            f"{s['min']:>11.4g} {s['max']:>11.4g}"
        )
    return "\n".join(lines)


def gradient_stats(network, params, batch, state=None, rng=None) -> Dict[str, float]:
    """{layer.param: l2_norm} of d(mean cost)/d(param) — the functional
    replacement for the reference's gradient_printer_evaluator."""
    from paddle_tpu_torch.trainer.step import value_and_grad

    _, _, grads = value_and_grad(
        lambda p: network.cost(p, batch, state=state, rng=rng, train=True), params)
    return {dotted(path): float(torch.linalg.vector_norm(g.float()))
            for path, g in leaf_paths(grads)}
