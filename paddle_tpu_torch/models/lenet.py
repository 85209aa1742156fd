"""LeNet for MNIST — the v1_api_demo/mnist topology (reference:
v1_api_demo/mnist/mnist_conv.py style: conv-pool ×2 + fc + softmax).  A copy
of ``paddle_tpu/models/lenet.py``: the topology serializes identically."""

from __future__ import annotations

import paddle_tpu_torch as paddle
from paddle_tpu_torch.core.topology import LayerOutput


def lenet(img: LayerOutput, class_num: int = 10) -> LayerOutput:
    conv1 = paddle.layer.img_conv(
        img, filter_size=5, num_filters=20, num_channels=1, padding=2,
        act=paddle.activation.Relu(),
    )
    pool1 = paddle.layer.img_pool(conv1, pool_size=2, stride=2)
    conv2 = paddle.layer.img_conv(
        pool1, filter_size=5, num_filters=50, padding=2,
        act=paddle.activation.Relu(),
    )
    pool2 = paddle.layer.img_pool(conv2, pool_size=2, stride=2)
    fc1 = paddle.layer.fc(pool2, size=500, act=paddle.activation.Relu())
    return paddle.layer.fc(fc1, size=class_num, act=paddle.activation.Softmax())


def lenet_cost(class_num: int = 10):
    img = paddle.layer.data("pixel", paddle.data_type.dense_vector(784))
    label = paddle.layer.data("label", paddle.data_type.integer_value(class_num))
    predict = lenet(img, class_num)
    cost = paddle.layer.classification_cost(input=predict, label=label)
    return cost, predict
