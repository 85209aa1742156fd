"""SSD detection layers: priorbox, multibox_loss, detection_output — the
counterpart of ``paddle_tpu/layers/detection.py`` (reference
paddle/gserver/layers/{PriorBox,MultiBoxLossLayer,DetectionOutputLayer}.cpp).

Shapes as in the JAX package: ground truth is a padded dense sequence slot
[B, G, 6] = (label, xmin, ymin, xmax, ymax, difficult) with per-image valid
counts; detections come out as a fixed [B, keep_top_k, 6] = (label, score,
xmin, ymin, xmax, ymax) block padded with label -1.  The JAX package
``vmap``s each layer over images; here every op takes the batch as a
leading dimension (``ops/detection.py``), so matching runs G rounds and NMS
``nms_top_k`` rounds for the whole batch and every class at once.  All three
are full precision: f32 under a bf16 compute dtype."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.batch import SeqTensor
from paddle_tpu_torch.layers.base import register_layer
from paddle_tpu_torch.ops import detection as D
from paddle_tpu_torch.ops.beam import top_k


# ---------------------------------------------------------------------------
# priorbox
# ---------------------------------------------------------------------------


def _priorbox_plan(conf, compute_dtype):
    """{device: [P, 8] priors + variances}, filled on first use."""
    return {}


@register_layer("priorbox", auto_activation=False, full_precision=True, build=_priorbox_plan)
def priorbox_apply(conf, params, inputs, ctx):
    """Output [B, P, 8]: the corner-form normalised prior and its 4
    variances, one [P, 8] block expanded over the batch (no copy)."""
    x = inputs[0].data
    plan = ctx.plans[conf.name]
    key = str(x.device)
    packed = plan.get(key)
    if packed is None:
        a = conf.attrs
        priors = torch.as_tensor(a["_priors"], dtype=torch.float32)
        var = torch.tensor(a["variance"], dtype=torch.float32).expand_as(priors)
        packed = plan[key] = torch.cat([priors, var], dim=-1).to(x.device)
    return SeqTensor(packed[None].expand(x.shape[0], *packed.shape))


# ---------------------------------------------------------------------------
# multibox_loss
# ---------------------------------------------------------------------------


def _gather_preds(inputs, width):
    """Each prediction (an NHWC conv output [B, H, W, k * width], or an
    already flat [B, H * W * k * width]) as [B, P_i, width], concatenated
    along the priors: the cell-major order of ``make_priors``."""
    return torch.cat([t.data.reshape(t.data.shape[0], -1, width) for t in inputs], dim=1)


def _priors_of(priors_t):
    """([P, 4] priors, [4] variances) of a priorbox output [B, P, 8], or of a
    ``concat`` of several priorbox layers (flat [B, P * 8], the reference's
    layout: a multi-map SSD concatenates one priorbox per map)."""
    d = priors_t.data
    d = d.reshape(d.shape[0], -1, 8)
    return d[0, :, :4], d[0, 0, 4:]


def _drop_class(x, c):
    """x [..., C] without column c (slices: no index tensor to upload)."""
    return torch.cat([x[..., :c], x[..., c + 1:]], dim=-1)


@register_layer("multibox_loss", auto_activation=False, full_precision=True)
def multibox_loss_apply(conf, params, inputs, ctx):
    """inputs: (priorbox, label, loc_0..loc_{n-1}, conf_0..conf_{n-1});
    output [B, 1]: per image smooth-L1 over the positives plus softmax cross
    entropy over the positives and the mined hard negatives, with two-phase
    matching (MultiBoxLossLayer::forward), normalised by the batch's total
    match count."""
    a = conf.attrs
    n_in, n_cls, bg = a["input_num"], a["num_classes"], a["background_id"]
    priors_t, label_t = inputs[0], inputs[1]
    locs = _gather_preds(inputs[2: 2 + n_in], 4)  # [B, P, 4]
    confs = _gather_preds(inputs[2 + n_in:], n_cls)  # [B, P, C]
    priors, variances = _priors_of(priors_t)

    assert label_t.is_seq, f"{conf.name}: the label must be a sequence slot"
    gt = label_t.data  # [B, G, 6]
    gt_valid = label_t.mask() > 0
    gt_boxes = gt[..., 1:5]
    gt_labels = gt[..., 0].to(torch.int64)

    matched, pos, max_iou = D.match_priors(priors, gt_boxes, gt_valid, a["overlap_threshold"])
    posf = pos.to(locs.dtype)
    n_pos = posf.sum(-1)  # [B]
    # localisation over the positives
    target = D.encode_boxes(
        torch.gather(gt_boxes, 1, matched[..., None].expand(*matched.shape, 4)), priors, variances)
    loc_loss = (D.smooth_l1(locs - target).sum(-1) * posf).sum(-1)
    # confidence: positives -> their gt's class, negatives -> background
    probs = torch.softmax(confs, dim=-1)
    logp = torch.log(probs.clamp_min(1e-12))
    cls = torch.where(pos, torch.gather(gt_labels, 1, matched), torch.full_like(matched, bg))
    ce = -torch.gather(logp, -1, cls[..., None])[..., 0]  # [B, P]
    # hard negatives ranked by the max NON-background probability
    # (getMaxConfidenceScores), n_neg = min(ratio * n_pos, candidates)
    with torch.no_grad():
        neg_score = _drop_class(probs, bg).amax(-1)
        neg_cand = (~pos) & (max_iou < a["neg_overlap"])
        ranks = D.hard_negative_ranks(neg_score, neg_cand)
        n_neg = torch.minimum(a["neg_pos_ratio"] * n_pos, neg_cand.to(locs.dtype).sum(-1))
        keep = pos | (ranks < n_neg[:, None])
    raw = loc_loss + (ce * keep.to(ce.dtype)).sum(-1)
    # the reference normalises by the BATCH-total match count
    # (MultiBoxLossLayer.cpp:206,257): rows scaled so their mean is
    # sum(raw) / total matches
    total = n_pos.sum().clamp_min(1.0)
    return SeqTensor((raw * (raw.shape[0] / total))[:, None])


# ---------------------------------------------------------------------------
# detection_output
# ---------------------------------------------------------------------------


@register_layer("detection_output", auto_activation=False, full_precision=True)
def detection_output_apply(conf, params, inputs, ctx):
    """inputs: (priorbox, loc..., conf...); output [B, keep_top_k, 6] =
    (label, score, xmin, ymin, xmax, ymax), empty slots label -1
    (DetectionOutputLayer::forward: decode, per-class NMS over the
    foreground classes, a global top-k)."""
    a = conf.attrs
    n_in, n_cls, bg = a["input_num"], a["num_classes"], a["background_id"]
    locs = _gather_preds(inputs[1: 1 + n_in], 4)
    confs = _gather_preds(inputs[1 + n_in:], n_cls)
    priors, variances = _priors_of(inputs[0])
    b, p = locs.shape[:2]
    nms_top_k = min(a["nms_top_k"], p)
    keep_top_k = a["keep_top_k"]

    boxes = D.decode_boxes(locs, priors, variances)  # [B, P, 4]
    probs = torch.softmax(confs, dim=-1)  # [B, P, C]
    s = _drop_class(probs, bg).transpose(1, 2)  # [B, C', P], the classes in order
    s = torch.where(s >= a["confidence_threshold"], s, torch.full_like(s, float("-inf")))
    idx, kept = D.nms(boxes[:, None], s, a["nms_threshold"], nms_top_k)  # [B, C', K]
    # class-major, as the JAX package concatenates its per-class results
    scores = kept.reshape(b, -1)
    labels = _drop_class(torch.arange(n_cls, device=locs.device), bg).repeat_interleave(nms_top_k)
    bxs = torch.gather(boxes, 1, idx.reshape(b, -1, 1).expand(-1, -1, 4))
    k = min(keep_top_k, scores.shape[1])
    top, ti = top_k(scores, k)
    live = top > 0
    det = torch.cat([
        torch.where(live, labels[ti], torch.full_like(ti, -1)).to(top.dtype)[..., None],
        top.clamp_min(0.0)[..., None],
        torch.gather(bxs, 1, ti[..., None].expand(-1, -1, 4)) * live[..., None].to(top.dtype),
    ], dim=-1)  # [B, k, 6]
    if k < keep_top_k:
        pad = det.new_zeros((b, keep_top_k - k, 6))
        pad[..., 0] = -1.0
        det = torch.cat([det, pad], dim=1)
    return SeqTensor(det)
