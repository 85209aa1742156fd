"""Parameter statistics of ``SGD.train(show_parameter_stats_period=N)`` — the
counterpart of ``parameter_stats`` and ``format_parameter_stats`` in the JAX
package's ``utils/debug.py`` (reference TrainerInternal.cpp:83-110)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from paddle_tpu_torch.utils.tree import leaf_paths


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
