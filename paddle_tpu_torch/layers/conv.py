"""Image layers: conv, convt, pool (max / avg), batch_norm, the cross-map
norm, maxout, pad, crop, bilinear_interp, spp and featmap_expand — the
counterpart of ``paddle_tpu/layers/conv.py``.

Layout: image tensors flow NHWC between layers, as in the JAX package (its
``fc`` flatten, ``addto`` and the batch-norm axes assume it).  A contiguous
NHWC tensor permuted to NCHW is already a ``torch.channels_last`` tensor, so
convs and pools run cuDNN's NHWC kernels without a layout copy, and their
channels_last outputs permute back to contiguous NHWC.  A flat [B, C*H*W]
input (a data slot) is read in CHW order, as in the reference, and
transposed to NHWC once.  Conv kernels stay HWIO ``[kh, kw, cin/groups,
cout]`` as in the JAX package; each conv forms torch's ``[cout, cin/groups,
kh, kw]`` operand in channels_last (one copy of the weight); a convt forms
torch's ``[cin, cout/groups, kh, kw]`` operand from the same HWIO layout
(:func:`conv_transpose_nhwc`).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import initializers as init
from paddle_tpu_torch.core.batch import SeqTensor
from paddle_tpu_torch.layers.base import register_layer


def convt_output_size(in_size: int, filter_size: int, padding: int, stride: int) -> int:
    """Transposed-conv spatial output, (in - 1) * s + k - 2p: the DSL sizes
    ``conv_operator(trans=True)`` and ``conv_projection(trans=True)`` with
    it, as the JAX package does."""
    return (in_size - 1) * stride + filter_size - 2 * padding


def to_nhwc(x: torch.Tensor, h: int, w: int, c: int) -> torch.Tensor:
    """Accept [B, C*H*W] flat (CHW order) or 4-D NHWC; return contiguous
    NHWC (a no-op on a contiguous NHWC tensor)."""
    if x.dim() == 4:
        return x.contiguous()
    b = x.shape[0]
    return x.reshape(b, c, h, w).permute(0, 2, 3, 1).contiguous()


def _as_nchw(x: torch.Tensor) -> torch.Tensor:
    """NCHW view of a contiguous NHWC tensor: channels_last, no copy."""
    return x.permute(0, 3, 1, 2)


def _as_nhwc(y: torch.Tensor) -> torch.Tensor:
    """NHWC view of a channels_last NCHW result: contiguous, no copy."""
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# conv
# ---------------------------------------------------------------------------


def conv_init(conf, in_confs, gen, device) -> Dict[str, Any]:
    a = conf.attrs
    cout = a["channels"]
    shape = (a["filter_h"], a["filter_w"], a["in_c"] // a.get("groups", 1), cout)
    p = {"w": init.conv_normal(gen, shape, device)}
    if conf.bias:
        p["b"] = init.zeros((cout,), device)
    return p


@register_layer("conv", init=conv_init)
def conv_apply(conf, params, inputs, ctx):
    a = conf.attrs
    x = to_nhwc(inputs[0].data, a["in_h"], a["in_w"], a["in_c"])
    # HWIO -> OIHW; with groups both keep one group's input channels on the
    # kernel's input axis and each group's output channels contiguous
    w = params["w"].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    out = F.conv2d(
        _as_nchw(x), w, params.get("b"),
        stride=(a.get("stride_h", 1), a.get("stride_w", 1)),
        padding=(a.get("pad_h", 0), a.get("pad_w", 0)),
        groups=a.get("groups", 1),
    )
    return SeqTensor(_as_nhwc(out), inputs[0].lengths)


def conv_transpose_nhwc(x, w, *, strides, ph, pw, groups: int = 1):
    """Transposed conv of NHWC `x` with the HWIO kernel `w` (``[kh, kw,
    cin/groups, cout]``), as the JAX package's lhs-dilated conv computes it:
    output extent (in - 1) s + k - 2p.  That conv correlates the
    stride-dilated input with the kernel as it stands; conv_transpose2d
    correlates with its operand flipped in H and W and laid out [cin,
    cout/groups, kh, kw], so the kernel is flipped and group g's block of
    output channels moved behind its block of input channels.  Shared by
    the convt layer and ``conv_operator(trans=True)``."""
    kh, kw, cin_g, cout = w.shape
    wt = (w.flip(0, 1).reshape(kh, kw, cin_g, groups, cout // groups)
          .permute(3, 2, 4, 0, 1).reshape(groups * cin_g, cout // groups, kh, kw))
    out = F.conv_transpose2d(_as_nchw(x), wt.contiguous(memory_format=torch.channels_last),
                             stride=strides, padding=(ph, pw), groups=groups)
    return _as_nhwc(out)


@register_layer("convt", init=conv_init)
def convt_apply(conf, params, inputs, ctx):
    a = conf.attrs
    x = to_nhwc(inputs[0].data, a["in_h"], a["in_w"], a["in_c"])
    out = conv_transpose_nhwc(
        x, params["w"], strides=(a.get("stride_h", 1), a.get("stride_w", 1)),
        ph=a.get("pad_h", 0), pw=a.get("pad_w", 0), groups=a.get("groups", 1))
    if "b" in params:
        out = out + params["b"]
    return SeqTensor(out, inputs[0].lengths)


# ---------------------------------------------------------------------------
# pool (max / avg)
# ---------------------------------------------------------------------------


def _window_sizes(n_out: int, stride: int, k: int, extent: int, device) -> torch.Tensor:
    """Per output index, the size of its window clipped to [0, extent)."""
    start = torch.arange(n_out, device=device) * stride
    return torch.clamp(start + k, max=extent) - start


@register_layer("pool")
def pool_apply(conf, params, inputs, ctx):
    a = conf.attrs
    x = to_nhwc(inputs[0].data, a["in_h"], a["in_w"], a["in_c"])
    kh, kw = a["filter_h"], a["filter_w"]
    sh, sw = a.get("stride_h", 1), a.get("stride_w", 1)
    ph, pw = a.get("pad_h", 0), a.get("pad_w", 0)
    is_max = a.get("pool_type", "max").startswith("max")
    # The DSL sizes the output with v1's ceil mode (cnn_output_size); the
    # windows are laid out on an explicitly padded input whose high side
    # takes the ceil mode's extra rows, as in the JAX package (torch's own
    # ceil_mode drops a last window that starts in the padding, and its
    # padding may not exceed half the window).
    out_h, out_w = a["out_h"], a["out_w"]
    h, w = x.shape[1], x.shape[2]
    extra_h = max((out_h - 1) * sh + kh - h - 2 * ph, 0)
    extra_w = max((out_w - 1) * sw + kw - w - 2 * pw, 0)
    if ph or pw or extra_h or extra_w:
        x = F.pad(x, (0, 0, pw, pw + extra_w, ph, ph + extra_h),
                  value=-math.inf if is_max else 0.0)
    if is_max:
        out = F.max_pool2d(_as_nchw(x), (kh, kw), (sh, sw))
    else:
        summed = F.avg_pool2d(_as_nchw(x), (kh, kw), (sh, sw), divisor_override=1)
        # Reference avg pooling divides by the window clipped to the
        # explicitly padded extent: explicit padding counts, the ceil
        # mode's extra does not (CpuMatrix::avgPoolForward).
        counts = (_window_sizes(out_h, sh, kh, h + 2 * ph, x.device)[:, None]
                  * _window_sizes(out_w, sw, kw, w + 2 * pw, x.device)[None, :])
        out = summed / counts.to(summed.dtype)
    out = _as_nhwc(out)
    if tuple(out.shape[1:3]) != (out_h, out_w):
        raise ValueError(f"{conf.name}: pooled to {tuple(out.shape[1:3])}, "
                         f"the DSL sized it {(out_h, out_w)}")
    return SeqTensor(out, inputs[0].lengths)


# ---------------------------------------------------------------------------
# batch_norm — moving statistics live in layer state; train uses batch stats
# ---------------------------------------------------------------------------


def bn_init(conf, in_confs, gen, device):
    c = conf.attrs["channels"]
    std = conf.attr("param_std")
    # ParamAttr(initial_std=...) on batch_norm randomizes the scale
    scale = init.normal(gen, (c,), std, device) if std else init.ones((c,), device)
    p = {"scale": scale}
    if conf.bias:
        p["beta"] = init.zeros((c,), device)
    return p


def bn_init_state(conf, in_confs, device):
    c = conf.attrs["channels"]
    return {"mean": init.zeros((c,), device), "var": init.ones((c,), device)}


@register_layer("batch_norm", init=bn_init, init_state=bn_init_state)
def batch_norm_apply(conf, params, inputs, ctx):
    """The JAX package's batch norm, not ``F.batch_norm``: E[x] and E[x^2] in
    f32 (or wider), the biased variance max(E[x^2] - mean^2, 0), and moving
    statistics ``fraction * old + (1 - fraction) * batch`` (torch's running
    variance is the unbiased one, with the complementary momentum)."""
    a = conf.attrs
    eps = a.get("epsilon", 1e-5)
    fraction = a.get("moving_average_fraction", 0.9)
    x = inputs[0].data
    in_dtype = x.dtype
    if a.get("in_h") is not None:
        x = to_nhwc(x, a["in_h"], a["in_w"], a["channels"])
        dims = (0, 1, 2)
    else:
        dims = (0,)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    st = ctx.state.get(conf.name, {})
    use_global = (not ctx.train) or a.get("use_global_stats", False)
    if use_global and st:
        mean, var = st["mean"], st["var"]
    else:
        n = math.prod(x.shape[d] for d in dims)
        mean = xf.sum(dims) / n
        var = torch.clamp(xf.square().sum(dims) / n - mean.square(), min=0.0)
        if ctx.train and st:
            # statistics are values: the state holds no graph (nor xf)
            ctx.new_state[conf.name] = {
                "mean": fraction * st["mean"] + (1 - fraction) * mean.detach(),
                "var": fraction * st["var"] + (1 - fraction) * var.detach(),
            }
    inv = torch.rsqrt(var + eps)
    out = (xf - mean) * inv * params["scale"].to(xf.dtype)
    if "beta" in params:  # bias_attr=False BN has no shift
        out = out + params["beta"].to(xf.dtype)
    return SeqTensor(out.to(in_dtype), inputs[0].lengths)


# ---------------------------------------------------------------------------
# norm — the cross-map response normalization (AlexNet's LRN)
# ---------------------------------------------------------------------------


@register_layer("norm")
def cmrnorm_apply(conf, params, inputs, ctx):
    """x (1 + scale sum_{window over channels} x^2)^-power in f32, cast back
    to the input's dtype (reference CrossMapNormalOp.cpp).  The window
    starts (size - 1) // 2 channels to the left, so an even size reaches
    one channel further to the right."""
    a = conf.attrs
    size = a["norm_size"]
    x = to_nhwc(inputs[0].data, a["in_h"], a["in_w"], a["in_c"])
    x32 = x.float()
    half = (size - 1) // 2
    padded = F.pad(x32 * x32, (half, size - 1 - half))
    window = padded.unfold(3, size, 1).sum(-1)
    denom = (1.0 + a.get("scale", 0.0128) * window) ** (-a.get("power", 0.75))
    return SeqTensor((x32 * denom).to(x.dtype), inputs[0].lengths)


# ---------------------------------------------------------------------------
# maxout, pad, crop
# ---------------------------------------------------------------------------


@register_layer("maxout")
def maxout_apply(conf, params, inputs, ctx):
    """The max over each group of `groups` consecutive channels
    (MaxOutLayer.cpp): c -> (c // groups, groups)."""
    a = conf.attrs
    g = a["groups"]
    x = to_nhwc(inputs[0].data, a["in_h"], a["in_w"], a["in_c"])
    b, h, w, c = x.shape
    return SeqTensor(x.reshape(b, h, w, c // g, g).amax(-1), inputs[0].lengths)


@register_layer("pad")
def pad_apply(conf, params, inputs, ctx):
    """Zeros before and after along C, H and W (PadLayer.cpp)."""
    a = conf.attrs
    x = to_nhwc(inputs[0].data, a["in_h"], a["in_w"], a["in_c"])
    pc, ph, pw = (tuple(a.get(k, (0, 0))) for k in ("pad_c", "pad_h_pair", "pad_w_pair"))
    return SeqTensor(F.pad(x, (*pc, *pw, *ph)), inputs[0].lengths)


@register_layer("crop")
def crop_apply(conf, params, inputs, ctx):
    """The window of extent (out_h, out_w, out_c) at the offsets along H, W
    and C (CropLayer.cpp); a second input only sized it."""
    a = conf.attrs
    x = to_nhwc(inputs[0].data, a["in_h"], a["in_w"], a["in_c"])
    oh, ow, oc = a["out_h"], a["out_w"], a.get("out_c", a["in_c"])
    offh, offw, offc = a.get("offset_h", 0), a.get("offset_w", 0), a.get("offset_c", 0)
    out = x[:, offh:offh + oh, offw:offw + ow, offc:offc + oc]
    return SeqTensor(out.contiguous(), inputs[0].lengths)


# ---------------------------------------------------------------------------
# bilinear_interp
# ---------------------------------------------------------------------------


def resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] weights of one axis of ``jax.image.resize(...,
    "bilinear")``: half-pixel centres, the triangle kernel widened by
    n_in / n_out on a downsampled axis (antialiasing), each column
    normalised to sum 1, and zero where the sample lies outside the input.
    Computed in f32 on the device, as JAX computes it."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    f32 = torch.float32
    sample = (torch.arange(n_out, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(n_in, dtype=f32, device=device)[:, None]).abs()
    w = torch.clamp(1 - dist / kernel_scale, min=0.0)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(f32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


@register_layer("bilinear_interp")
def bilinear_interp_apply(conf, params, inputs, ctx):
    """``jax.image.resize(x, ..., "bilinear")`` (what the JAX package runs
    for BilinearInterpLayer.cpp): each axis whose extent changes is one
    product with its weight matrix (:func:`resize_weights`), H then W."""
    a = conf.attrs
    x = to_nhwc(inputs[0].data, a["in_h"], a["in_w"], a["in_c"])
    b, h, w, c = x.shape
    oh, ow = a["out_h"], a["out_w"]
    if oh != h:
        wh = resize_weights(h, oh, x.device).to(x.dtype)
        x = (wh.t() @ x.reshape(b, h, w * c)).reshape(b, oh, w, c)
    if ow != w:
        ww = resize_weights(w, ow, x.device).to(x.dtype)
        x = (ww.t() @ x.reshape(b * oh, w, c)).reshape(b, oh, ow, c)
    return SeqTensor(x, inputs[0].lengths)


# ---------------------------------------------------------------------------
# spp — a pyramid of pools, concatenated (SpatialPyramidPoolLayer.cpp)
# ---------------------------------------------------------------------------


@register_layer("spp")
def spp_apply(conf, params, inputs, ctx):
    """Level l pools into 2^l x 2^l bins with window = stride = ceil(extent /
    bins), the input padded on the bottom and the right only: -inf for max,
    zeros for avg, whose divisor kh kw counts the pad.  Each level's bins
    flatten NHWC; the levels concatenate."""
    a = conf.attrs
    x = to_nhwc(inputs[0].data, a["in_h"], a["in_w"], a["in_c"])
    b, h, w, c = x.shape
    is_max = a.get("pool_type", "max").startswith("max")
    outs = []
    for lvl in range(a.get("pyramid_height", 3)):
        bins = 2 ** lvl
        kh, kw = -(-h // bins), -(-w // bins)
        xp = F.pad(x, (0, 0, 0, kw * bins - w, 0, kh * bins - h),
                   value=-math.inf if is_max else 0.0)
        if is_max:
            pooled = F.max_pool2d(_as_nchw(xp), (kh, kw), (kh, kw))
        else:
            pooled = F.avg_pool2d(_as_nchw(xp), (kh, kw), (kh, kw))
        outs.append(_as_nhwc(pooled).reshape(b, -1))
    return SeqTensor(torch.cat(outs, dim=-1), inputs[0].lengths)


# ---------------------------------------------------------------------------
# featmap_expand (FeatureMapExpandLayer.cpp)
# ---------------------------------------------------------------------------


@register_layer("featmap_expand")
def featmap_expand_apply(conf, params, inputs, ctx):
    """The flattened input tiled num_filters times: whole copies one after
    another (as_row_vector), else each feature repeated in place."""
    x = inputs[0]
    n = conf.attrs["num_filters"]
    b = x.data.shape[0]
    flat = x.data.reshape(b, -1)
    d = flat.shape[1]
    if conf.attrs.get("as_row_vector", True):
        out = flat[:, None, :].expand(b, n, d)
    else:
        out = flat[:, :, None].expand(b, d, n)
    return SeqTensor(out.reshape(b, -1), x.lengths)
