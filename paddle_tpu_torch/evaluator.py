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

Ported: classification_error, sum, column_sum, auc, precision_recall,
pnpair, chunk and the value, maxid, seq_text, maxframe, classification_error
and gradient printers.  Not ported yet: ctc_error and detection_map (their
layers are not in the port); calling either raises.
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


def _not_ported(name: str):
    def build(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet: its layers are not in the port "
            "(ROADMAP Queue 1 item 3)")

    build.__name__ = name
    return build


ctc_error_evaluator = _not_ported("ctc_error_evaluator")
detection_map_evaluator = _not_ported("detection_map_evaluator")


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
