"""Evaluators — the counterpart of ``paddle_tpu/evaluator.py`` (the reference's
``paddle/gserver/evaluators`` with the trainer_config_helpers surface).

Each evaluator has
  * an **update** over the step's layer outputs, which returns fixed-shape
    accumulator tensors (computed beside the step, without a host copy), and
  * a **finalize** on the host, which turns summed accumulators into scalar
    results.
The trainer sums the accumulators over batches (per batch for iteration
events, per pass for pass events and ``test``) and finalizes them.  Printers
print from their update and accumulate nothing.

Ported: all of them — classification_error, sum, column_sum, auc,
precision_recall, pnpair, chunk, ctc_error, detection_map and the value,
maxid, seq_text, maxframe, classification_error and gradient printers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.batch import SeqTensor
from paddle_tpu_torch.core.topology import LayerOutput, auto_name

Accums = Dict[str, torch.Tensor]


@dataclasses.dataclass
class Evaluator:
    name: str
    layers: List[LayerOutput]  # outputs the update needs
    update: Callable[[Dict[str, SeqTensor]], Accums]
    finalize: Callable[[Dict[str, object]], Dict[str, float]]


def _ids_of(t: SeqTensor) -> torch.Tensor:
    ids = t.data.to(torch.int64)
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    return ids


def _flat_valid(pred: SeqTensor, label: SeqTensor):
    """(pred2d [N, C], ids [N], weight [N]), flattening sequence time."""
    p = pred.data
    ids = _ids_of(label)
    if pred.is_seq and p.dim() == 3:
        w = pred.mask().reshape(-1)
        return p.reshape(-1, p.shape[-1]), ids.reshape(-1), w
    return p, ids.reshape(-1), torch.ones((p.shape[0],), device=p.device)


def _masked(t: SeqTensor) -> torch.Tensor:
    """The data with a sequence's padded steps zeroed."""
    if not t.is_seq:
        return t.data
    m = t.mask(t.data.dtype)
    return t.data * m.reshape(m.shape + (1,) * (t.data.dim() - 2))


def _one_hot(ids: torch.Tensor, c: int) -> torch.Tensor:
    """f32 one-hot rows; an id outside [0, c) gives a zero row."""
    return (ids[:, None] == torch.arange(c, device=ids.device)).float()


def _logits_or_output(outs, input: LayerOutput) -> SeqTensor:
    """argmax(softmax(x)) == argmax(x): the producer's pre-activation where
    it exposed one."""
    pred = outs.get(input.name + "@logits")
    return outs[input.name] if pred is None else pred


# ---------------------------------------------------------------------------
# classification_error, sum, column_sum
# ---------------------------------------------------------------------------


def classification_error_evaluator(
    input: LayerOutput, label: LayerOutput, name: Optional[str] = None
) -> Evaluator:
    nm = name or auto_name("classification_error")

    def update(outs):
        p, ids, w = _flat_valid(_logits_or_output(outs, input), outs[label.name])
        err = (torch.argmax(p, dim=-1) != ids).float()
        return {"err": torch.sum(err * w), "total": torch.sum(w)}

    def finalize(acc):
        return {nm: float(acc["err"]) / max(float(acc["total"]), 1.0)}

    return Evaluator(nm, [input, label], update, finalize)


def sum_evaluator(input: LayerOutput, name: Optional[str] = None) -> Evaluator:
    nm = name or auto_name("sum")

    def update(outs):
        return {"sum": torch.sum(_masked(outs[input.name]))}

    return Evaluator(nm, [input], update, lambda a: {nm: float(a["sum"])})


def column_sum_evaluator(input: LayerOutput, name: Optional[str] = None) -> Evaluator:
    nm = name or auto_name("column_sum")

    def update(outs):
        d = _masked(outs[input.name])
        rows = d.reshape(-1, d.shape[-1])
        return {"colsum": torch.sum(rows, dim=0),
                "n": torch.tensor(float(rows.shape[0]), device=d.device)}

    def finalize(acc):
        col = np.asarray(acc["colsum"]) / max(float(acc["n"]), 1.0)
        return {f"{nm}[{i}]": float(v) for i, v in enumerate(col)}

    return Evaluator(nm, [input], update, finalize)


# ---------------------------------------------------------------------------
# auc: a fixed-bin histogram of the positive-class score (the reference
# sorts on the host; the histogram gives the same statistic at fixed shapes)
# ---------------------------------------------------------------------------


def auc_evaluator(
    input: LayerOutput, label: LayerOutput, name: Optional[str] = None,
    num_bins: int = 4096,
) -> Evaluator:
    nm = name or auto_name("auc")

    def update(outs):
        p, ids, w = _flat_valid(outs[input.name], outs[label.name])
        # positive-class score: column 1 of a 2-column softmax, else column 0
        score = p[:, 1] if p.shape[-1] >= 2 else p[:, 0]
        bin_ = torch.clamp((score * num_bins).to(torch.int64), 0, num_bins - 1)
        pos = torch.zeros((num_bins,), device=p.device).index_add_(0, bin_, w * (ids == 1))
        neg = torch.zeros((num_bins,), device=p.device).index_add_(0, bin_, w * (ids != 1))
        return {"pos": pos, "neg": neg}

    def finalize(acc):
        pos = np.asarray(acc["pos"], np.float64)
        neg = np.asarray(acc["neg"], np.float64)
        # walk the bins from high score to low, trapezoids on the ROC curve
        tp = np.cumsum(pos[::-1])
        fp = np.cumsum(neg[::-1])
        tot_p, tot_n = tp[-1], fp[-1]
        if tot_p == 0 or tot_n == 0:
            return {nm: 0.0}
        tpr = np.concatenate([[0.0], tp / tot_p])
        fpr = np.concatenate([[0.0], fp / tot_n])
        return {nm: float(np.trapezoid(tpr, fpr))}

    return Evaluator(nm, [input, label], update, finalize)


# ---------------------------------------------------------------------------
# precision_recall
# ---------------------------------------------------------------------------


def precision_recall_evaluator(
    input: LayerOutput, label: LayerOutput,
    positive_label: int = -1, name: Optional[str] = None,
) -> Evaluator:
    nm = name or auto_name("precision_recall")
    c = input.size

    def update(outs):
        p, ids, w = _flat_valid(outs[input.name], outs[label.name])
        onehot_pred = _one_hot(torch.argmax(p, dim=-1), c) * w[:, None]
        onehot_gold = _one_hot(ids, c) * w[:, None]
        return {
            "tp": torch.sum(onehot_pred * onehot_gold, dim=0),
            "pred": torch.sum(onehot_pred, dim=0),
            "gold": torch.sum(onehot_gold, dim=0),
        }

    def finalize(acc):
        tp = np.asarray(acc["tp"], np.float64)
        pred = np.asarray(acc["pred"], np.float64)
        gold = np.asarray(acc["gold"], np.float64)
        sel = [positive_label] if positive_label >= 0 else list(range(c))
        precs = [tp[i] / pred[i] if pred[i] else 0.0 for i in sel]
        recs = [tp[i] / gold[i] if gold[i] else 0.0 for i in sel]
        prec, rec = float(np.mean(precs)), float(np.mean(recs))
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        return {f"{nm}.precision": prec, f"{nm}.recall": rec, f"{nm}.F1": f1}

    return Evaluator(nm, [input, label], update, finalize)


# ---------------------------------------------------------------------------
# pnpair: positive-negative pair ratio within query groups
# ---------------------------------------------------------------------------


def pnpair_evaluator(
    input: LayerOutput, label: LayerOutput, query_id: LayerOutput,
    name: Optional[str] = None,
) -> Evaluator:
    nm = name or auto_name("pnpair")

    def update(outs):
        score_t = outs[input.name]
        score = score_t.data.reshape(-1)
        y = _ids_of(outs[label.name]).reshape(-1).float()
        q = _ids_of(outs[query_id.name]).reshape(-1)
        if score_t.is_seq:
            w = score_t.mask(torch.bool).reshape(-1)
        else:
            w = torch.ones(score.shape, dtype=torch.bool, device=score.device)
        mask = (q[:, None] == q[None, :]) & (y[:, None] > y[None, :]) & w[:, None] & w[None, :]
        sdiff = score[:, None] - score[None, :]
        return {"pos": torch.sum(mask & (sdiff > 0)).float(),
                "neg": torch.sum(mask & (sdiff < 0)).float(),
                "spe": torch.sum(mask & (sdiff == 0)).float()}

    def finalize(acc):
        pos, neg, spe = (float(acc[k]) for k in ("pos", "neg", "spe"))
        return {nm: (pos + 0.5 * spe) / max(neg + 0.5 * spe, 1e-12)}

    return Evaluator(nm, [input, label, query_id], update, finalize)


# ---------------------------------------------------------------------------
# chunk: F1 over chunk segmentations (reference ChunkEvaluator.cpp); a label
# id is chunk_type * tag_num + tag, and O is num_chunk_types * tag_num
# ---------------------------------------------------------------------------

_SCHEMES = {
    # tag ids within a type
    "plain": {"num": 1},
    "IOB": {"num": 2, "B": 0, "I": 1},
    "IOE": {"num": 2, "I": 0, "E": 1},
    "IOBES": {"num": 4, "B": 0, "I": 1, "E": 2, "S": 3},
}


def _shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """x [B, T] moved k steps later along T (k < 0: earlier), -1 filled."""
    fill = torch.full_like(x[:, : abs(k)], -1)
    return torch.cat([fill, x[:, :-k]], 1) if k > 0 else torch.cat([x[:, -k:], fill], 1)


def _chunk_bounds(ids, lengths, scheme: str, num_types: int):
    """(start [B, T] bool, end [B, T] bool, type [B, T]) per position."""
    sc = _SCHEMES[scheme]
    tag_num = sc["num"]
    is_o = ids >= num_types * tag_num
    typ = torch.where(is_o, -1, ids // tag_num)
    tag = torch.where(is_o, -1, ids % tag_num)
    tpos = torch.arange(ids.shape[1], device=ids.device)[None, :]
    lengths = lengths.to(ids.device)
    valid = tpos < lengths[:, None]
    prev_typ, prev_tag = _shift(typ, 1), _shift(tag, 1)
    last_pos = tpos == (lengths[:, None] - 1)
    next_typ = torch.where(last_pos, -1, _shift(typ, -1))
    next_tag = torch.where(last_pos, -1, _shift(tag, -1))
    first_pos = tpos == 0
    in_chunk = ~is_o & valid
    if scheme == "plain":
        start = in_chunk & (typ != prev_typ)
        end = in_chunk & (typ != next_typ)
    elif scheme == "IOB":
        start = in_chunk & ((tag == sc["B"]) | ((tag == sc["I"]) & ((prev_typ != typ) | first_pos)))
        end = in_chunk & ((next_typ != typ) | (next_tag == sc["B"]) | last_pos)
    elif scheme == "IOE":
        start = in_chunk & ((prev_typ != typ) | (prev_tag == sc["E"]) | first_pos)
        end = in_chunk & ((tag == sc["E"]) | (next_typ != typ) | last_pos)
    else:  # IOBES
        start = in_chunk & ((tag == sc["B"]) | (tag == sc["S"]))
        end = in_chunk & ((tag == sc["E"]) | (tag == sc["S"]))
    return start & valid, end & valid, typ


def _next_end_pos(end: torch.Tensor) -> torch.Tensor:
    """[B, T]: each position's next end at or after it (T if none)."""
    t_ = end.shape[1]
    idx = torch.where(end, torch.arange(t_, device=end.device)[None, :], t_)
    return idx.flip(1).cummin(dim=1).values.flip(1)


def chunk_evaluator(
    input: LayerOutput, label: LayerOutput,
    chunk_scheme: str = "IOB", num_chunk_types: int = 1,
    name: Optional[str] = None,
) -> Evaluator:
    """Chunk precision, recall and F1 of predicted label ids (a
    crf_decoding output) against the gold ids, by `chunk_scheme` (plain,
    IOB, IOE or IOBES): a chunk is right when its start, end and type all
    match.  The counts sum beside the step; the ratios finalize on the
    host."""
    nm = name or auto_name("chunk")
    if chunk_scheme not in _SCHEMES:
        raise ValueError(f"chunk_scheme {chunk_scheme!r}; known: {sorted(_SCHEMES)}")

    def update(outs):
        lab_t = outs[label.name]
        lengths = lab_t.lengths
        ps, pe, pt = _chunk_bounds(_ids_of(outs[input.name]), lengths, chunk_scheme,
                                   num_chunk_types)
        gs, ge, gt = _chunk_bounds(_ids_of(lab_t), lengths, chunk_scheme, num_chunk_types)
        correct = ps & gs & (pt == gt) & (_next_end_pos(pe) == _next_end_pos(ge))
        return {"correct": correct.sum().float(), "pred": ps.sum().float(),
                "gold": gs.sum().float()}

    def finalize(acc):
        c, p, g = float(acc["correct"]), float(acc["pred"]), float(acc["gold"])
        prec = c / p if p else 0.0
        rec = c / g if g else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        return {f"{nm}.precision": prec, f"{nm}.recall": rec, f"{nm}.F1": f1}

    return Evaluator(nm, [input, label], update, finalize)


# ---------------------------------------------------------------------------
# ctc_error — edit distance between the best-path CTC decode and the label
# ---------------------------------------------------------------------------


def _ctc_best_path(logits: torch.Tensor, lengths: torch.Tensor, blank: int):
    """Greedy decode and collapse on the logits' device: (ids [B, T] with the
    kept symbols first, their counts [B]).  argmax takes the first maximum
    and a stable argsort compacts, as in the JAX package."""
    t_ = logits.shape[1]
    am = torch.argmax(logits, dim=-1)  # [B, T]
    prev = torch.cat([am.new_full((am.shape[0], 1), -1), am[:, :-1]], dim=1)
    tpos = torch.arange(t_, device=am.device)[None, :]
    keep = (am != blank) & (am != prev) & (tpos < lengths[:, None])
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    return am.gather(1, order), keep.sum(1)


def _edit_distance(a: np.ndarray, alen: np.ndarray, b: np.ndarray, blen: np.ndarray):
    """Levenshtein distance of a[i, :alen[i]] to b[i, :blen[i]] per row, in
    integers on the host: the JAX package's two scans (one row of the table
    per position of a, frozen past alen), vectorised over the batch."""
    rows, ta = a.shape
    tb = b.shape[1]
    row = np.broadcast_to(np.arange(tb + 1, dtype=np.int64), (rows, tb + 1)).copy()
    for i in range(ta):
        sub = (a[:, i][:, None] != b).astype(np.int64)  # [B, Tb]
        new = np.empty_like(row)
        new[:, 0] = i + 1
        for j in range(tb):
            new[:, j + 1] = np.minimum(np.minimum(row[:, j + 1] + 1, new[:, j] + 1),
                                       row[:, j] + sub[:, j])
        row = np.where((i < alen)[:, None], new, row)
    return row[np.arange(rows), blen]


def ctc_error_evaluator(
    input: LayerOutput, label: LayerOutput, blank: int = 0,
    name: Optional[str] = None,
) -> Evaluator:
    """Sequence error: the edit distance of the best-path decode from the
    label, summed, over the summed label lengths (reference
    CTCErrorEvaluator.cpp:277).  The decode runs on the card; one copy per
    batch brings the decoded ids and the labels to the host, where the
    distances are computed."""
    nm = name or auto_name("ctc_error")

    def update(outs):
        pred_t, lab_t = outs[input.name], outs[label.name]
        dec, dec_len = _ctc_best_path(pred_t.data, pred_t.lengths, blank)
        lab = _ids_of(lab_t)
        if lab.dim() != 2:
            # _ids_of squeezes ids padded to T = 1, as the JAX package's does
            raise ValueError(f"{nm}: label ids of shape {tuple(lab.shape)}; a label "
                             "sequence padded to length 1 cannot be scored")
        t_ = dec.shape[1]
        host = torch.cat([dec, dec_len[:, None], lab,
                          lab_t.lengths.to(torch.int64)[:, None]], dim=1).cpu().numpy()
        dec_h, dec_len_h = host[:, :t_], host[:, t_]
        lab_h, lab_len_h = host[:, t_ + 1:-1], host[:, -1]
        dist = _edit_distance(dec_h, dec_len_h, lab_h, lab_len_h)
        return {
            "dist": torch.tensor(float(dist.sum())),
            "ref": torch.tensor(float(lab_len_h.sum())),
            "seqs": torch.tensor(float(dec_h.shape[0])),
        }

    def finalize(acc):
        return {nm: float(acc["dist"]) / max(float(acc["ref"]), 1.0)}

    return Evaluator(nm, [input, label], update, finalize)


# ---------------------------------------------------------------------------
# printers: side-effect evaluators
# ---------------------------------------------------------------------------


def value_printer_evaluator(input: LayerOutput, name: Optional[str] = None) -> Evaluator:
    nm = name or auto_name("value_printer")

    def update(outs):
        print(f"{nm} {outs[input.name].data.float().cpu().numpy()}")
        return {}

    return Evaluator(nm, [input], update, lambda a: {})


def maxid_printer_evaluator(input: LayerOutput, name: Optional[str] = None) -> Evaluator:
    nm = name or auto_name("maxid_printer")

    def update(outs):
        print(f"{nm} {torch.argmax(outs[input.name].data, dim=-1).cpu().numpy()}")
        return {}

    return Evaluator(nm, [input], update, lambda a: {})


def seq_text_printer_evaluator(
    input: LayerOutput,
    id_to_word=None,
    result_file: Optional[str] = None,
    id_input: Optional[LayerOutput] = None,
    dict_file: Optional[str] = None,
    name: Optional[str] = None,
) -> Evaluator:
    """Print id sequences as text, one line per sample (reference
    seqtext_printer_evaluator: dict_file + result_file).  `id_to_word` maps
    id to token (dict, list or callable); None prints the raw ids.
    `dict_file` loads that mapping, one token per line; `id_input` is
    accepted for the reference's surface (the ids printed are `input`'s).
    The JAX package prints through an io_callback under jit; here the
    update copies the ids to the host and prints."""
    nm = name or auto_name("seq_text_printer")
    if id_to_word is None and dict_file:
        with open(dict_file) as f:
            id_to_word = [ln.rstrip("\n").split("\t")[0] for ln in f]

    def to_text(ids: np.ndarray, lengths: Optional[np.ndarray]) -> None:
        lines = []
        for i in range(ids.shape[0]):
            row = ids[i][: int(lengths[i])] if lengths is not None else ids[i]
            if id_to_word is None:
                toks = [str(int(t)) for t in row.reshape(-1)]
            elif callable(id_to_word):
                toks = [str(id_to_word(int(t))) for t in row.reshape(-1)]
            else:
                toks = [str(id_to_word[int(t)]) for t in row.reshape(-1)]
            lines.append(" ".join(toks))
        text = "\n".join(lines)
        if result_file:
            with open(result_file, "a") as f:
                f.write(text + "\n")
        else:
            print(f"{nm}:\n{text}")

    def update(outs):
        t = outs[input.name]
        to_text(t.data.cpu().numpy(), t.lengths.cpu().numpy() if t.is_seq else None)
        return {}

    return Evaluator(nm, [input], update, lambda a: {})


def maxframe_printer_evaluator(input: LayerOutput, name: Optional[str] = None) -> Evaluator:
    """Print, per sample, the frame (timestep) holding the largest activation
    and that value (reference MaxFramePrinter); a non-sequence input gives
    the sample's largest feature.  The JAX package prints through an
    io_callback under jit; here the update copies the values to the host."""
    nm = name or auto_name("maxframe_printer")

    def update(outs):
        t = outs[input.name]
        data = t.data.float().cpu().numpy()
        lengths = t.lengths.cpu().numpy() if t.is_seq else None
        lines = []
        for i in range(data.shape[0]):
            row = data[i]
            if lengths is not None:
                row = row[: max(int(lengths[i]), 1)]
            flat = row.reshape(row.shape[0], -1) if row.ndim > 1 else row.reshape(-1, 1)
            per_frame = flat.max(axis=-1)
            frame = int(np.argmax(per_frame))
            lines.append(f"sample {i}: frame {frame} value {float(per_frame[frame]):.6g}")
        print(f"{nm}:\n" + "\n".join(lines))
        return {}

    return Evaluator(nm, [input], update, lambda a: {})


def classification_error_printer_evaluator(
    input: LayerOutput, label: LayerOutput, name: Optional[str] = None
) -> Evaluator:
    """Prints the per-instance error indicators (one 0/1 per sample, or per
    valid step of a sequence) instead of aggregating them."""
    nm = name or auto_name("classification_error_printer")

    def update(outs):
        p, ids, w = _flat_valid(_logits_or_output(outs, input), outs[label.name])
        err = (torch.argmax(p, dim=-1) != ids).float().cpu().numpy()
        vals = [str(int(e)) for e, ww in zip(err, w.cpu().numpy()) if ww > 0]
        print(f"{nm}: [" + " ".join(vals) + "]")
        return {}

    return Evaluator(nm, [input, label], update, lambda a: {})


def gradient_printer_evaluator(input: LayerOutput, name: Optional[str] = None) -> Evaluator:
    """The reference prints a layer's output gradient mid-backward; the
    gradient is one autograd pass here, so this prints the layer's forward
    value norm, as the JAX package does."""
    nm = name or auto_name("gradient_printer")

    def update(outs):
        n = torch.linalg.vector_norm(outs[input.name].data.float()).item()
        print(f"{nm} forward-norm {n}")
        return {}

    return Evaluator(nm, [input], update, lambda a: {})


# ---------------------------------------------------------------------------
# combination helpers (used by the trainer)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# detection mAP (reference DetectionMAPEvaluator.cpp:306)
# ---------------------------------------------------------------------------

_MAP_BINS = 1000


def detection_map_evaluator(
    input: LayerOutput,  # detection_output layer: [B, K, 6]
    label: LayerOutput,  # gt slot: [B, G, 6] (label, x1, y1, x2, y2, difficult)
    num_classes: int,
    overlap_threshold: float = 0.5,
    background_id: int = 0,
    evaluate_difficult: bool = False,
    ap_type: str = "11point",
    name: Optional[str] = None,
) -> Evaluator:
    """Streaming mAP, as the JAX package's: the update matches each image's
    detections to its ground truth greedily (by score, stable sort; one gt
    per detection; IoU >= threshold) in K steps over the whole batch, and
    adds TP/FP counts into per-class 1000-bin score histograms; finalize
    integrates the binned precision-recall curve on the host (``11point``
    or ``Integral``)."""
    from paddle_tpu_torch.ops.detection import iou_matrix

    nm = name or auto_name("detection_map")

    def update(outs):
        det_t, gt_t = outs[input.name], outs[label.name]
        det = det_t.data.float()  # [B, K, 6]
        gt = gt_t.data.float()  # [B, G, 6]
        b, k = det.shape[:2]
        dev = det.device
        valid = gt_t.mask() > 0 if gt_t.is_seq else torch.ones(gt.shape[:2], dtype=torch.bool,
                                                                  device=dev)
        g_lab = gt[..., 0].to(torch.int64)
        g_box = gt[..., 1:5]
        g_diff = gt[..., 5] > 0
        counted = valid & (evaluate_difficult | ~g_diff)
        in_range = (g_lab >= 0) & (g_lab < num_classes)
        n_gt = torch.zeros(num_classes, device=dev).index_put_(
            (g_lab.clamp(0, num_classes - 1).reshape(-1),),
            (counted & in_range).float().reshape(-1), accumulate=True)
        # by score, descending (detection_output's block is sorted over all
        # classes; the greedy match needs each class's order by score)
        order = torch.argsort(-det[..., 1], dim=-1, stable=True)
        det = torch.gather(det, 1, order[..., None].expand(-1, -1, 6))
        d_lab = det[..., 0].to(torch.int64)
        d_score = det[..., 1]
        ious = iou_matrix(det[..., 2:6], g_box)  # [B, K, G]
        rows = torch.arange(b, device=dev)
        used = torch.zeros(g_lab.shape, dtype=torch.bool, device=dev)
        tps, fps = [], []
        for j in range(k):
            lab = d_lab[:, j]
            # reference calcTFPos: the best-overlap gt over ALL same-class
            # gts; a hit on a used gt is an FP, a hit on a skipped difficult
            # gt is ignored and does not mark the gt used
            masked = torch.where(valid & (g_lab == lab[:, None]), ious[:, j],
                                 torch.full_like(ious[:, j], -1.0))
            best = torch.argmax(masked, dim=-1)
            hit = masked[rows, best] >= overlap_threshold
            live = (lab >= 0) & (lab != background_id) & (d_score[:, j] > 0)
            ignore = hit & g_diff[rows, best] & (not evaluate_difficult)
            already = used[rows, best]
            tps.append(live & hit & ~ignore & ~already)
            fps.append(live & (~hit | (hit & ~ignore & already)))
            used[rows, best] = already | (hit & live & ~ignore)
        bins = (d_score * _MAP_BINS).to(torch.int32).clamp(0, _MAP_BINS - 1).to(torch.int64)
        at = (d_lab.clamp(0, num_classes - 1).reshape(-1), bins.reshape(-1))
        zeros = torch.zeros((num_classes, _MAP_BINS), device=dev)
        return {
            "n_gt": n_gt,
            "tp": zeros.clone().index_put_(at, torch.stack(tps, 1).float().reshape(-1),
                                           accumulate=True),
            "fp": zeros.index_put_(at, torch.stack(fps, 1).float().reshape(-1),
                                   accumulate=True),
        }

    def finalize(acc):
        n_gt = np.asarray(acc["n_gt"])
        tp = np.asarray(acc["tp"])[:, ::-1]  # high-score bins first
        fp = np.asarray(acc["fp"])[:, ::-1]
        aps = []
        for c in range(num_classes):
            if c == background_id or n_gt[c] <= 0:
                continue
            ctp, cfp = np.cumsum(tp[c]), np.cumsum(fp[c])
            recall = ctp / n_gt[c]
            precision = ctp / np.maximum(ctp + cfp, 1e-10)
            if ap_type == "11point":
                ap = 0.0
                for t in np.linspace(0, 1, 11):
                    mask = recall >= t
                    ap += (precision[mask].max() if mask.any() else 0.0) / 11.0
            else:  # Integral: precision summed over the recall steps
                prev_r = 0.0
                ap = 0.0
                for r, p in zip(recall, precision):
                    ap += (r - prev_r) * p
                    prev_r = r
            aps.append(ap)
        return {nm: float(np.mean(aps)) if aps else 0.0}

    return Evaluator(nm, [input, label], update, finalize)


def combined_update(evaluators: Sequence[Evaluator]):
    """One update emitting every evaluator's accumulators, namespaced
    ``ev:<name>:<key>``."""

    @torch.no_grad()
    def update(outs) -> Accums:
        acc: Accums = {}
        for ev in evaluators:
            for k, v in ev.update(outs).items():
                acc[f"ev:{ev.name}:{k}"] = v
        return acc

    return update


def finalize_all(evaluators: Sequence[Evaluator], sums: Dict[str, object]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for ev in evaluators:
        prefix = f"ev:{ev.name}:"
        acc = {k[len(prefix):]: v for k, v in sums.items() if k.startswith(prefix)}
        if acc or not ev.layers:
            out.update(ev.finalize(acc))
    return out
