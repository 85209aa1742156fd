"""ResNet family — the model_zoo ResNet (reference:
v1_api_demo/model_zoo/resnet/resnet.py, built from the same conv/batch_norm/
addto DSL primitives; benchmark/paddle/image drivers are the perf baseline).

Bottleneck blocks as in the reference: conv_bn_layer chains with an addto
shortcut.  Everything stays NHWC 4D between layers, so cuDNN runs the conv
chain in channels_last without layout copies (``layers/conv.py``).  A copy
of ``paddle_tpu/models/resnet.py``: the topology serializes identically.
"""

from __future__ import annotations

from typing import Optional

import paddle_tpu_torch as paddle
from paddle_tpu_torch.core.topology import LayerOutput


def conv_bn(
    input: LayerOutput,
    ch_out: int,
    filter_size: int,
    stride: int,
    padding: int,
    active_type=None,
    ch_in: Optional[int] = None,
) -> LayerOutput:
    tmp = paddle.layer.img_conv(
        input,
        filter_size=filter_size,
        num_filters=ch_out,
        num_channels=ch_in,
        stride=stride,
        padding=padding,
        act=paddle.activation.Linear(),
        bias_attr=False,
    )
    return paddle.layer.batch_norm(tmp, act=active_type or paddle.activation.Relu())


def shortcut(input: LayerOutput, ch_out: int, stride: int) -> LayerOutput:
    ch_in = input.conf.attrs.get("channels") or input.conf.attrs.get("in_c")
    if ch_in != ch_out or stride != 1:
        return conv_bn(input, ch_out, 1, stride, 0, paddle.activation.Linear())
    return input


def bottleneck_block(input: LayerOutput, ch_out: int, stride: int) -> LayerOutput:
    short = shortcut(input, ch_out * 4, stride)
    conv1 = conv_bn(input, ch_out, 1, stride, 0)
    conv2 = conv_bn(conv1, ch_out, 3, 1, 1)
    conv3 = conv_bn(conv2, ch_out * 4, 1, 1, 0, paddle.activation.Linear())
    return paddle.layer.addto(
        [short, conv3], act=paddle.activation.Relu(), bias_attr=False
    )


def basic_block(input: LayerOutput, ch_out: int, stride: int) -> LayerOutput:
    short = shortcut(input, ch_out, stride)
    conv1 = conv_bn(input, ch_out, 3, stride, 1)
    conv2 = conv_bn(conv1, ch_out, 3, 1, 1, paddle.activation.Linear())
    return paddle.layer.addto(
        [short, conv2], act=paddle.activation.Relu(), bias_attr=False
    )


def layer_warp(block_fn, input, ch_out, count, stride):
    out = block_fn(input, ch_out, stride)
    for _ in range(count - 1):
        out = block_fn(out, ch_out, 1)
    return out


_DEPTH_CFG = {
    18: (basic_block, [2, 2, 2, 2]),
    34: (basic_block, [3, 4, 6, 3]),
    50: (bottleneck_block, [3, 4, 6, 3]),
    101: (bottleneck_block, [3, 4, 23, 3]),
    152: (bottleneck_block, [3, 8, 36, 3]),
}


def resnet(
    img: LayerOutput,
    depth: int = 50,
    class_num: int = 1000,
    img_size: int = 224,
    num_channels: int = 3,
) -> LayerOutput:
    """reference resnet.py deep_res_net; returns softmax predictions."""
    block_fn, counts = _DEPTH_CFG[depth]
    conv1 = conv_bn(
        img, 64, filter_size=7, stride=2, padding=3, ch_in=num_channels
    )
    pool1 = paddle.layer.img_pool(conv1, pool_size=3, stride=2, padding=1)
    res1 = layer_warp(block_fn, pool1, 64, counts[0], 1)
    res2 = layer_warp(block_fn, res1, 128, counts[1], 2)
    res3 = layer_warp(block_fn, res2, 256, counts[2], 2)
    res4 = layer_warp(block_fn, res3, 512, counts[3], 2)
    final_hw = res4.conf.attrs["out_h"]
    pool2 = paddle.layer.img_pool(
        res4, pool_size=final_hw, stride=1, pool_type=paddle.pooling.Avg()
    )
    return paddle.layer.fc(pool2, size=class_num, act=paddle.activation.Softmax())


def resnet_cost(
    depth: int = 50, class_num: int = 1000, img_size: int = 224, num_channels: int = 3
):
    img = paddle.layer.data(
        "image",
        paddle.data_type.dense_vector(img_size * img_size * num_channels),
        height=img_size,
        width=img_size,
    )
    label = paddle.layer.data("label", paddle.data_type.integer_value(class_num))
    predict = resnet(img, depth, class_num, img_size, num_channels)
    cost = paddle.layer.classification_cost(input=predict, label=label)
    return cost, predict
