"""Multi-dimensional (2D) LSTM — the counterpart of
``paddle_tpu/layers/mdlstm.py`` (reference MDLstmLayer.cpp:180-240, Graves'
multi-dimensional RNN): an LSTM whose recurrence runs over both image axes,
with one forget gate per axis.  The gates come pre-projected from the input
layer as 5 * size channels (i, f_row, f_col, o, g):

    c = gate(f_col) * c_left + gate(f_row) * c_top + gate(i) * act(g)
    h = gate(o) * state_act(c)

with ``w_col`` applied to the left neighbour's h, ``w_row`` to the top
neighbour's, and the bias.  ``reverse_h`` / ``reverse_w`` flip the scan
over either axis.

Lowering: a wavefront.  A cell needs only its left and top neighbours, so
every cell of one anti-diagonal i + j = d is independent of the others: the
JAX package's H * W sequential cells (a scan over rows of scans over
columns) become H + W - 1 steps over [B, H, 5n] blocks, the same arithmetic
per cell.  The input is gathered into the skewed layout [D, B, H, 5n] once
(the flips ride the gather's indices), each step keeps the previous
diagonal's h and c with a zero row on top so the left and top neighbours
are two views of one buffer, and the output is gathered back once.
:class:`MdlstmCore` is an autograd Function in the manner of
``ops/rnn.py``'s ``LstmCore``: its backward runs the wavefront in reverse
with one transposed GEMM per step and takes both recurrent weights'
gradients as one GEMM each over the saved diagonals."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import initializers as init
from paddle_tpu_torch.core.batch import SeqTensor
from paddle_tpu_torch.layers.base import register_layer
from paddle_tpu_torch.layers.conv import to_nhwc
from paddle_tpu_torch.ops.activations import get_activation
from paddle_tpu_torch.ops.rnn import _act_vjp


def mdlstm_init(conf, in_confs, gen, device):
    n = conf.attrs["channels"]
    p = {
        "w_row": init.normal(gen, (n, 5 * n), device=device),  # from the top neighbour
        "w_col": init.normal(gen, (n, 5 * n), device=device),  # from the left neighbour
    }
    if conf.bias:
        p["b"] = init.zeros((5 * n,), device)
    return p


def _zero_top(x: torch.Tensor) -> torch.Tensor:
    """[B, H, n] -> [B, H + 1, n] with a zero row 0: rows 1.. are the
    cells' own (left neighbours), rows ..H - 1 the rows above (top)."""
    return F.pad(x, (0, 0, 1, 0))


class MdlstmCore(torch.autograd.Function):
    """The wavefront.  xs: [D, B, H, 5n] skewed gate inputs (bias added;
    zero outside the image); w_row, w_col: [n, 5n]; mask: [D, 1, H, 1] bool
    (the cells of each diagonal); acts: (gate, act, state_act).  Returns hs
    [D, B, H, n], zero outside the image.  The forward saves each step's
    pre-activations, activations and cell; the backward runs one transposed
    GEMM per step and the weight gradients as two GEMMs after the loop."""

    @staticmethod
    def forward(ctx, xs, w_row, w_col, mask, acts):
        f_gate, f_act, f_state = (get_activation(a) for a in acts)
        n_diag, b, h, n5 = xs.shape
        n = n5 // 5
        w = torch.cat([w_col, w_row], dim=1)  # [n, 10n]
        hp = xs.new_zeros((b, h + 1, n))  # the previous diagonal's h, zero row on top
        cp = xs.new_zeros((b, h + 1, n))
        seqs = ([], [], [], [], [], [], [], [])  # h pads, c pads, p_s, y_s, p_g, g, c, s
        hs = []
        for d in range(n_diag):
            gh = torch.matmul(hp, w)  # [B, H + 1, 10n]
            a = xs[d] + gh[:, 1:, :n5] + gh[:, :-1, n5:]
            p_s, p_g = a[..., : 4 * n], a[..., 4 * n:]
            y_s = f_gate(p_s)  # i, f_row, f_col, o
            g = f_act(p_g)
            c = y_s[..., 2 * n: 3 * n] * cp[:, 1:] + y_s[..., n: 2 * n] * cp[:, :-1] \
                + y_s[..., :n] * g
            s = f_state(c)
            for acc, x in zip(seqs, (hp, cp, p_s, y_s, p_g, g, c, s)):
                acc.append(x)
            m = mask[d]
            hs.append(torch.where(m, y_s[..., 3 * n:] * s, 0.0))
            hp = _zero_top(hs[-1])
            cp = _zero_top(torch.where(m, c, 0.0))
        saved = [torch.stack(x) for x in seqs]
        ctx.acts = acts
        ctx.save_for_backward(*saved, w_row, w_col, mask)
        return torch.stack(hs)

    @staticmethod
    def backward(ctx, dhs):
        hp_seq, cp_seq, ps_seq, ys_seq, pg_seq, g_seq, c_seq, s_seq, w_row, w_col, mask = \
            ctx.saved_tensors
        acts = ctx.acts
        n_diag, b, h, n = dhs.shape
        w_t = torch.cat([w_col, w_row], dim=0).t()  # [5n, 2n]
        dh = dhs.new_zeros((b, h, n))
        dc = dhs.new_zeros((b, h, n))
        das = []
        for d in reversed(range(n_diag)):
            m = mask[d]
            dhm = torch.where(m, dh + dhs[d], 0.0)
            dcm = torch.where(m, dc, 0.0)
            y_s, s, cp = ys_seq[d], s_seq[d], cp_seq[d]
            dct = dcm + _act_vjp(acts[2], c_seq[d], s, dhm * y_s[..., 3 * n:])
            dy_s = torch.cat([dct * g_seq[d], dct * cp[:, :-1], dct * cp[:, 1:], dhm * s], -1)
            dp_s = _act_vjp(acts[0], ps_seq[d], y_s, dy_s)
            dp_g = _act_vjp(acts[1], pg_seq[d], g_seq[d], dct * y_s[..., :n])
            da = torch.cat([dp_s, dp_g], -1)  # [B, H, 5n]
            das.append(da)
            # to the previous diagonal: the same row as left neighbour, the
            # row above as top neighbour
            dlt = torch.matmul(da, w_t)  # [B, H, 2n]
            dh = dlt[..., :n] + F.pad(dlt[:, 1:, n:], (0, 0, 0, 1))
            dc = dct * y_s[..., 2 * n: 3 * n] + F.pad((dct * y_s[..., n: 2 * n])[:, 1:],
                                                        (0, 0, 0, 1))
        da_seq = torch.stack(das[::-1])  # [D, B, H, 5n]
        # one GEMM per weight over the saved diagonals
        dw_col = torch.einsum("dbhn,dbhg->ng", hp_seq[:, :, 1:], da_seq)
        dw_row = torch.einsum("dbhn,dbhg->ng", hp_seq[:, :, :-1], da_seq)
        return da_seq, dw_row, dw_col, None, None


def _skew_index(h: int, w: int, reverse_h: bool, reverse_w: bool, device):
    """(rows [D, H], cols [D, H], mask [D, H]): the image cell that the
    scan's cell (row i, column d - i) reads, clamped where d - i lies
    outside [0, W), and the cells that exist.  The scan runs in the flipped
    frame; the indices map it back to the image's own."""
    d = torch.arange(h + w - 1, device=device)[:, None]
    i = torch.arange(h, device=device)[None, :]
    j = d - i
    mask = (j >= 0) & (j < w)
    j = j.clamp(0, w - 1)
    rows = (h - 1 - i) if reverse_h else i
    cols = (w - 1 - j) if reverse_w else j
    return rows.expand_as(j), cols, mask


@register_layer("mdlstmemory", init=mdlstm_init, auto_activation=False)
def mdlstm_apply(conf, params, inputs, ctx):
    a = conf.attrs
    n = a["channels"]  # hidden width; conf.size is the flattened extent
    h_img, w_img, c_in = a["in_h"], a["in_w"], a["in_c"]
    assert c_in == 5 * n, (
        f"{conf.name}: input must be pre-projected to 5*size gates "
        f"(got {c_in} channels for size {n})")
    x = to_nhwc(inputs[0].data, h_img, w_img, c_in)  # [B, H, W, 5n]
    rev_h, rev_w = bool(a.get("reverse_h")), bool(a.get("reverse_w"))
    rows, cols, mask = _skew_index(h_img, w_img, rev_h, rev_w, x.device)
    xs = x[:, rows, cols] * mask[None, :, :, None].to(x.dtype)  # [B, D, H, 5n]
    if "b" in params:
        xs = xs + params["b"]
    xs = xs.transpose(0, 1).contiguous()  # [D, B, H, 5n]
    acts = (conf.attr("gate_act", "sigmoid"), conf.attr("active_type", "tanh"),
            conf.attr("state_act", "tanh"))
    hs = MdlstmCore.apply(xs, params["w_row"], params["w_col"], mask[:, None, :, None], acts)
    # back to the image: cell (r, c) of the image is the scan's cell at
    # row i = r' and diagonal i + j' in the flipped frame
    r = torch.arange(h_img, device=x.device)
    c = torch.arange(w_img, device=x.device)
    ri = (h_img - 1 - r) if rev_h else r
    cj = (w_img - 1 - c) if rev_w else c
    out = hs[ri[:, None] + cj[None, :], :, ri[:, None].expand(h_img, w_img)]  # [H, W, B, n]
    return SeqTensor(out.permute(2, 0, 1, 3).contiguous())
