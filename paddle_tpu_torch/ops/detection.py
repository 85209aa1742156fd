"""SSD prior-box geometry — the part of the JAX package's ``ops/detection.py``
that the DSL's ``priorbox`` needs to size its layer (reference PriorBox.cpp).
The detection layers themselves (matching, the box codec, NMS) are not
ported yet; a network using them fails when it is compiled."""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


def make_priors(
    h: int,
    w: int,
    min_sizes: Sequence[float],
    max_sizes: Sequence[float],
    aspect_ratios: Sequence[float],
    img_h: int,
    img_w: int,
    clip: bool = True,
) -> np.ndarray:
    """[P, 4] corner-form (xmin,ymin,xmax,ymax) normalized priors for an
    h×w feature map over an img_h×img_w image; cell-major (row-major cells,
    prior variants fastest) to match NHWC conv predictions.  Per-cell order
    mirrors PriorBox.cpp: min box, sqrt(min*max) box, then r and 1/r boxes
    per aspect ratio."""
    step_x, step_y = img_w / w, img_h / h
    variants: List[Tuple[float, float]] = []  # (bw, bh) in pixels
    for k, s in enumerate(min_sizes):
        variants.append((s, s))
        if k < len(max_sizes):
            m = math.sqrt(s * max_sizes[k])
            variants.append((m, m))
        for r in aspect_ratios:
            if abs(r - 1.0) < 1e-6:
                continue
            sr = math.sqrt(r)
            variants.append((s * sr, s / sr))
            variants.append((s / sr, s * sr))
    out = np.zeros((h, w, len(variants), 4), np.float32)
    for i in range(h):
        cy = (i + 0.5) * step_y
        for j in range(w):
            cx = (j + 0.5) * step_x
            for k, (bw, bh) in enumerate(variants):
                out[i, j, k] = [
                    (cx - bw / 2) / img_w,
                    (cy - bh / 2) / img_h,
                    (cx + bw / 2) / img_w,
                    (cy + bh / 2) / img_h,
                ]
    out = out.reshape(-1, 4)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    return out


def priors_per_cell(n_min: int, n_max: int, aspect_ratios: Sequence[float]) -> int:
    n_ar = sum(1 for r in aspect_ratios if abs(r - 1.0) >= 1e-6)
    return n_min * (1 + 2 * n_ar) + n_max
