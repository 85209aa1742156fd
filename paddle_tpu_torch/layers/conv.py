"""Image layers: conv, pool (max / avg) and batch_norm — the counterpart of
``paddle_tpu/layers/conv.py`` (:29-78, :125-225) for what LeNet and the
ResNet family run.

Layout: image tensors flow NHWC between layers, as in the JAX package (its
``fc`` flatten, ``addto`` and the batch-norm axes assume it).  A contiguous
NHWC tensor permuted to NCHW is already a ``torch.channels_last`` tensor, so
convs and pools run cuDNN's NHWC kernels without a layout copy, and their
channels_last outputs permute back to contiguous NHWC.  A flat [B, C*H*W]
input (a data slot) is read in CHW order, as in the reference, and
transposed to NHWC once.  Conv kernels stay HWIO ``[kh, kw, cin/groups,
cout]`` as in the JAX package; each conv forms torch's ``[cout, cin/groups,
kh, kw]`` operand in channels_last (one copy of the weight).

Not ported yet: convt, norm (cross-map), maxout, pad, crop, bilinear_interp,
spp and featmap_expand (compiling one raises).
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
