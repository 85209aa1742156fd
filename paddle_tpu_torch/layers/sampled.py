"""Large-vocabulary output layers and the LambdaRank cost — the counterpart
of ``paddle_tpu/layers/sampled.py``: ``nce``, ``hsigmoid``,
``selective_fc`` and ``lambda_cost``.

Reference: paddle/gserver/layers/{NCELayer,HierarchicalSigmoidLayer,
SelectiveFullyConnectedLayer,LambdaCost}.cpp.

  * nce draws its [B, K] noise ids inside the step from the layer's
    generator on the activation's device (a fixed-seed one when the step
    has no seed, as the JAX package falls back to ``PRNGKey(0)``): uniform
    ids, or ids in proportion to ``noise_dist`` by inverse CDF, which needs
    no host synchronisation.
  * hsigmoid walks the reference's implicit complete binary tree (node ids
    from the bits of ``label + num_classes``) over the whole padded path at
    once: gather the path's rows, one batched product, mask, sum.
  * selective_fc takes the full [B, C] product and masks it.
"""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch.core import initializers as init
from paddle_tpu_torch.core.batch import SeqTensor
from paddle_tpu_torch.layers.base import register_layer
from paddle_tpu_torch.layers.cost import softplus


def _flat_concat(ts) -> torch.Tensor:
    return torch.cat([t.data.reshape(t.data.shape[0], -1) for t in ts], dim=-1)


# ---------------------------------------------------------------------------
# nce
# ---------------------------------------------------------------------------


def nce_init(conf, in_confs, gen, device):
    c = conf.attrs["num_classes"]
    d = sum(ic.size for ic in in_confs[: conf.attrs["num_feat_inputs"]])
    p = {"w": init.normal(gen, (c, d), init.default_std(d), device)}
    if conf.bias:
        p["b"] = init.zeros((c,), device)
    return p


def nce_build(conf, compute_dtype) -> dict:
    """The layer's plan: {device: (log q, CDF)}, filled on first use."""
    return {}


def noise_tables(conf, plan: dict, device):
    """(log q [C], the CDF of noise_dist [C] or None for uniform noise) on
    `device`, made once per device: log q is log(dist + 1e-12) in f32 with
    no renormalisation, as the JAX package takes it."""
    hit = plan.get(str(device))
    if hit is not None:
        return hit
    c = conf.attrs["num_classes"]
    dist = conf.attrs.get("noise_dist")
    if dist is None:
        tables = (torch.full((c,), -math.log(c), dtype=torch.float32, device=device), None)
    else:
        q = torch.tensor(dist, dtype=torch.float32)
        cdf = torch.cumsum(q.double(), 0)
        tables = (torch.log(q + 1e-12).to(device), (cdf / cdf[-1]).float().to(device))
    plan[str(device)] = tables
    return tables


def draw_noise(cdf, c: int, shape, gen, device) -> torch.Tensor:
    """[B, K] noise ids: uniform over [0, c) when `cdf` is None, else by
    inverse CDF (an id with probability 0 is never drawn)."""
    if cdf is None:
        return torch.randint(0, c, shape, generator=gen, device=device)
    u = torch.rand(shape, generator=gen, device=device)
    return torch.clamp(torch.searchsorted(cdf, u, right=True), max=c - 1)


@register_layer("nce", init=nce_init, auto_activation=False, full_precision=True,
                build=nce_build)
def nce_apply(conf, params, inputs, ctx):
    """Noise-contrastive estimation cost -> [B, 1]: inputs are the feature
    layer(s), then the label ids.  Each row scores its label and K noise
    ids, each logit less log(K q(id)), under the binary logistic loss.

    A sequence input runs frame by frame ([B*T] rows); a frame counts where
    both the feature's and the label's lengths hold it."""
    nfeat = conf.attrs["num_feat_inputs"]
    k = conf.attrs["num_neg_samples"]
    c = conf.attrs["num_classes"]
    seq_in = inputs[0].is_seq and inputs[0].data.dim() == 3
    if seq_in:
        x = torch.cat([t.data.reshape(-1, t.data.shape[-1]) for t in inputs[:nfeat]], dim=-1)
    else:
        x = _flat_concat(inputs[:nfeat])
    label = inputs[nfeat].data.to(torch.int64).reshape(-1)
    rows, device = x.shape[0], x.device
    logq, cdf = noise_tables(conf, ctx.plans[conf.name], device)
    gen = ctx.layer_rng(conf.name, device)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    noise = draw_noise(cdf, c, (rows, k), gen, device)
    ids = torch.cat([label[:, None], noise], dim=1)  # [B, 1+K]
    ids = torch.clamp(ids, 0, c - 1)
    logits = torch.bmm(params["w"][ids], x[:, :, None])[..., 0]
    if "b" in params:
        logits = logits + params["b"][ids]
    logits = logits - (math.log(k) + logq[ids])
    target = torch.zeros_like(logits)
    target[:, 0] = 1.0
    loss = (torch.clamp(logits, min=0) - logits * target
            + torch.log1p(torch.exp(-logits.abs()))).sum(dim=1)
    if seq_in:
        t0, lab = inputs[0], inputs[nfeat]
        frames = loss.reshape(t0.data.shape[0], t0.data.shape[1])
        m = t0.mask(frames.dtype)
        if lab.is_seq:
            m = m * lab.mask(frames.dtype)
        return SeqTensor((frames * m).sum(dim=1)[:, None])
    return SeqTensor(loss[:, None])


# ---------------------------------------------------------------------------
# hsigmoid
# ---------------------------------------------------------------------------


def hsigmoid_init(conf, in_confs, gen, device):
    c = conf.attrs["num_classes"]
    d = sum(ic.size for ic in in_confs[:-1])
    p = {"w": init.normal(gen, (c - 1, d), init.default_std(d), device)}
    if conf.bias:
        p["b"] = init.zeros((c - 1,), device)
    return p


def path_codes(label: torch.Tensor, c: int):
    """(node [B, L], bit [B, L], valid [B, L]) of each label's path from the
    root: node j is the internal node at step j, bit the branch taken.  The
    path length is the code's bit length less one, counted exactly in
    integers: the JAX package's floor(log2(code + 0.5)) in f32 gives the
    same for every code below 2^20 (num_classes up to 2^19) and can count
    one too many just below a larger power of two.  The shift counts past a
    path's end are clamped to 0 (a negative count is undefined in torch),
    and `valid` masks those steps."""
    maxlen = max(int(math.ceil(math.log2(c))), 1)
    code = label.to(torch.int64) + c
    powers = 2 ** torch.arange(1, maxlen + 2, device=label.device, dtype=torch.int64)
    plen = (code[:, None] >= powers).sum(dim=1)
    j = torch.arange(maxlen, device=label.device, dtype=torch.int64)[None, :]
    shift = plen[:, None] - j
    node = torch.bitwise_right_shift(code[:, None], torch.clamp(shift, min=0)) - 1
    bit = torch.bitwise_right_shift(code[:, None], torch.clamp(shift - 1, min=0)) & 1
    return torch.clamp(node, 0, c - 2), bit, j < plen[:, None]


@register_layer("hsigmoid", init=hsigmoid_init, auto_activation=False, full_precision=True)
def hsigmoid_apply(conf, params, inputs, ctx):
    """Hierarchical sigmoid cost -> [B, 1]: the negative log-likelihood of
    the label's path through the complete binary tree over num_classes."""
    c = conf.attrs["num_classes"]
    x = _flat_concat(inputs[:-1])
    node, bit, valid = path_codes(inputs[-1].data.reshape(-1), c)
    score = torch.bmm(params["w"][node], x[:, :, None])[..., 0]
    if "b" in params:
        score = score + params["b"][node]
    # P(branch) = sigmoid(score) on bit 0, sigmoid(-score) on bit 1
    z = torch.where(bit == 0, score, -score)
    loss = torch.where(valid, softplus(-z), torch.zeros_like(z)).sum(dim=1)
    return SeqTensor(loss[:, None])


# ---------------------------------------------------------------------------
# selective_fc
# ---------------------------------------------------------------------------


def selective_fc_init(conf, in_confs, gen, device):
    d = sum(ic.size for ic in in_confs[:-1])
    p = {"w": init.normal(gen, (d, conf.size), init.default_std(d), device)}
    if conf.bias:
        p["b"] = init.zeros((conf.size,), device)
    return p


@register_layer("selective_fc", init=selective_fc_init)
def selective_fc_apply(conf, params, inputs, ctx):
    """fc whose output is masked to the selected columns: the last input is
    the [B, C] selection (> 0 keeps); without one it is a plain fc (the
    reference's full_mode)."""
    has_sel = conf.attrs.get("has_selection", True)
    feats = inputs[:-1] if has_sel else inputs
    out = torch.matmul(_flat_concat(feats), params["w"])
    if "b" in params:
        out = out + params["b"]
    if has_sel:
        sel = inputs[-1].data.reshape(out.shape[0], -1)
        out = out * (sel > 0).to(out.dtype)
    return SeqTensor(out, feats[0].lengths)


# ---------------------------------------------------------------------------
# lambda_cost (LambdaRank)
# ---------------------------------------------------------------------------


@register_layer("lambda_cost", auto_activation=False, full_precision=True)
def lambda_cost_apply(conf, params, inputs, ctx):
    """Listwise LambdaRank cost per query -> [B, 1]: over the document pairs
    (i better than j), |dNDCG(i, j)| log(1 + exp(-(s_i - s_j))), NDCG
    truncated at attrs["ndcg_num"].  inputs: the model's score sequence and
    the gold relevance sequence ([B, T, 1] each).  A document's rank counts
    the valid documents scored strictly higher, so ties rank alike."""
    score_t, label_t = inputs
    if not score_t.is_seq:
        raise ValueError(f"{conf.name}: lambda_cost input must be a sequence")
    s = score_t.data[..., 0] if score_t.data.dim() == 3 else score_t.data
    y = label_t.data[..., 0] if label_t.data.dim() == 3 else label_t.data
    y = y.to(s.dtype)
    ndcg_num = conf.attrs.get("ndcg_num", 5)
    pos = torch.arange(s.shape[1], device=s.device)
    valid = pos[None, :] < score_t.lengths[:, None]

    # ideal DCG: labels sorted descending (padding as -inf), gains 2^y - 1,
    # discount 1 / log2(r + 2); the sort is stable, as jnp.sort is, so tied
    # grades take their positions (and their gradients) in the same order
    # on every device
    y_sorted = -torch.sort(-torch.where(valid, y, torch.full_like(y, -math.inf)), dim=1,
                           stable=True).values
    gains_sorted = torch.where(torch.isfinite(y_sorted), torch.pow(2.0, y_sorted) - 1.0,
                               torch.zeros_like(y_sorted))
    disc = 1.0 / torch.log2(pos.to(torch.float32) + 2.0)
    idcg = (gains_sorted * disc * (pos < ndcg_num)).sum(dim=1)
    idcg = torch.where(idcg > 0, idcg, torch.ones_like(idcg))

    rank = ((s[:, None, :] > s[:, :, None]) & valid[:, None, :]).sum(dim=2)
    doc_disc = torch.where(rank < ndcg_num, 1.0 / torch.log2(rank.to(torch.float32) + 2.0),
                           torch.zeros_like(s))
    gain = torch.pow(2.0, torch.where(valid, y, torch.zeros_like(y))) - 1.0
    dg = (gain[:, :, None] - gain[:, None, :]) * (doc_disc[:, :, None] - doc_disc[:, None, :])
    delta = dg.abs() / idcg[:, None, None]
    pair_loss = softplus(s[:, None, :] - s[:, :, None])
    better = (y[:, :, None] > y[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    cost = torch.where(better, delta * pair_loss, torch.zeros_like(delta)).sum(dim=(1, 2))
    return SeqTensor(cost[:, None])
