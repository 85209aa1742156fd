"""SSD detection ops: prior boxes, IoU matching, the box codec and NMS —
the counterpart of ``paddle_tpu/ops/detection.py`` (reference PriorBox.cpp,
MultiBoxLossLayer.cpp, DetectionOutputLayer.cpp and DetectionUtil.cpp).

Every function takes leading batch dimensions, so the layers run one
image's work for the whole batch at once (the JAX package ``vmap``s over
images).  The loops are fixed-length Python loops over tensor ops (G rounds
of matching, ``max_out`` rounds of NMS): no host sync, no data-dependent
shape.  Ties resolve as in JAX: ``torch.argmax`` takes the first maximum,
``jnp.argsort`` is stable and so is the sort here."""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch


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


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def box_area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]).clamp_min(0.0) * (b[..., 3] - b[..., 1]).clamp_min(0.0)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., N, 4] x [..., M, 4] corner-form -> [..., N, M] IoU (leading
    dimensions broadcast)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-10), torch.zeros_like(inter))


def _center_form(b: torch.Tensor):
    wh = b[..., 2:] - b[..., :2]
    c = (b[..., 2:] + b[..., :2]) * 0.5
    return c, wh.clamp_min(1e-8)


def encode_boxes(gt: torch.Tensor, priors: torch.Tensor, variances) -> torch.Tensor:
    """SSD codec (DetectionUtil.cpp encodeBBox): centre and size offsets
    scaled by the 4 variances; gt and priors [..., 4] corner form."""
    v = torch.as_tensor(variances, dtype=torch.float32, device=gt.device)
    gc, gwh = _center_form(gt)
    pc, pwh = _center_form(priors)
    d_c = (gc - pc) / pwh / v[:2]
    d_wh = torch.log(gwh / pwh) / v[2:]
    return torch.cat([d_c, d_wh], dim=-1)


def decode_boxes(loc: torch.Tensor, priors: torch.Tensor, variances) -> torch.Tensor:
    v = torch.as_tensor(variances, dtype=torch.float32, device=loc.device)
    pc, pwh = _center_form(priors)
    c = loc[..., :2] * v[:2] * pwh + pc
    wh = torch.exp(loc[..., 2:] * v[2:]) * pwh
    return torch.cat([c - wh / 2, c + wh / 2], dim=-1)


# ---------------------------------------------------------------------------
# matching (MultiBoxLossLayer::forward matching phase / matchBBox)
# ---------------------------------------------------------------------------


@torch.no_grad()
def match_priors(priors: torch.Tensor, gt: torch.Tensor, gt_valid: torch.Tensor,
                 overlap_threshold: float):
    """priors [P, 4], gt [..., G, 4], gt_valid [..., G] bool -> (matched_gt
    [..., P] int64, pos_mask [..., P] bool, max_iou [..., P]).

    Per prior: the best gt with IoU above the threshold.  Then the bipartite
    pass: G rounds, each claiming the globally best remaining (prior, gt)
    pair and excluding that prior and that gt, so every valid gt gets its
    own prior whatever the threshold.  The argmax runs over the [P, G] IoU
    flattened row-major, so a tie (two clipped priors with the same box)
    goes to the lower prior, as in the JAX package."""
    g = gt.shape[-2]
    iou = iou_matrix(priors, gt) * gt_valid[..., None, :].to(torch.float32)  # [..., P, G]
    max_iou = iou.amax(dim=-1)
    matched = torch.argmax(iou, dim=-1)
    pos = max_iou > overlap_threshold
    live = iou.clone()
    lead = live.shape[:-2]
    p = live.shape[-2]
    flat_live = live.reshape(*lead, p * g)
    rows = torch.arange(p, device=iou.device)
    cols = torch.arange(g, device=iou.device)
    for _ in range(g):
        flat = torch.argmax(flat_live, dim=-1, keepdim=True)  # [..., 1]
        best = torch.gather(flat_live, -1, flat)
        ok = best > 0.0
        pi, gi = flat // g, flat % g
        claim = ok & (rows == pi)  # [..., P]
        matched = torch.where(claim, gi, matched)
        pos = pos | claim
        drop = ok[..., None] & ((rows == pi)[..., :, None] | (cols == gi)[..., None, :])
        live = torch.where(drop, torch.full_like(live, -1.0), live)
        flat_live = live.reshape(*lead, p * g)
    return matched, pos, max_iou


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


@torch.no_grad()
def hard_negative_ranks(neg_score: torch.Tensor, neg_mask: torch.Tensor) -> torch.Tensor:
    """[..., P] rank of each negative prior by descending score (P where it
    is no candidate); keep a prior by comparing its rank with n_neg.  The
    sort is stable (``jnp.argsort`` is), so tied scores rank by index."""
    masked = torch.where(neg_mask, neg_score, torch.full_like(neg_score, -math.inf))
    order = torch.argsort(-masked, dim=-1, stable=True)
    n = neg_score.shape[-1]
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(n, device=order.device).expand_as(order))
    return torch.where(neg_mask, ranks, torch.full_like(ranks, n))


# ---------------------------------------------------------------------------
# NMS (DetectionUtil applyNMSFast) — fixed-round select-and-suppress
# ---------------------------------------------------------------------------


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over every leading index at once: boxes [..., N, 4] (may
    broadcast against scores' leading dimensions), scores [..., N] (-inf for
    no candidate) -> (idx [..., max_out] int64, kept [..., max_out]).  Unused
    slots have idx 0 and score 0.  Each of the max_out rounds selects the
    best live score, then suppresses it and every box overlapping it above
    the threshold."""
    live = scores
    neg_inf = torch.full_like(scores, -math.inf)
    idxs, kept = [], []
    lead = scores.shape[:-1]
    # the areas once: each round's IoU row is iou_matrix(selected, boxes)'s,
    # the same arithmetic, with the boxes' areas read back instead of redone
    area = box_area(boxes).expand(lead + scores.shape[-1:])
    boxes = boxes.expand(*lead, *boxes.shape[-2:])
    for _ in range(max_out):
        i = torch.argmax(live, dim=-1, keepdim=True)  # [..., 1]
        s = torch.gather(live, -1, i)
        sel = torch.gather(boxes, -2, i[..., None].expand(*lead, 1, 4))  # [..., 1, 4]
        wh = (torch.minimum(sel[..., 2:], boxes[..., 2:])
              - torch.maximum(sel[..., :2], boxes[..., :2])).clamp_min(0.0)
        inter = wh[..., 0] * wh[..., 1]
        union = torch.gather(area, -1, i) + area - inter
        over = torch.where(union > 0, inter / union.clamp_min(1e-10), 0.0) > iou_threshold
        live = torch.where(over, neg_inf, live).scatter(-1, i, neg_inf[..., :1])
        idxs.append(i)
        kept.append(s)
    idx, kept_s = torch.cat(idxs, -1), torch.cat(kept, -1)
    valid = kept_s > -math.inf
    return torch.where(valid, idx, torch.zeros_like(idx)), torch.where(
        valid, kept_s, torch.zeros_like(kept_s))
