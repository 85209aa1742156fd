"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``, for an NVIDIA
H100.  It keeps the JAX package's module layout, names and user surface;
the JAX package stays beside it as the reference.  It serves and trains
Transformer-base, with multi-head attention on hand-written CUDA
flash-attention kernels (``ops/flash_attention.py``: the forward, and the dq
and dk/dv backward kernels), and the image models LeNet and ResNet
(``models/lenet.py``, ``models/resnet.py``: convs and pools on cuDNN in
NHWC, batch norm with its moving statistics as layer state).  The training
spine is ported: dropout, error clipping, name-shared parameters, the eight
optimizers, the divergence sentinel, evaluators, the v1 parameter tar and
full-state checkpoints (``checkpoint.CheckpointManager``).  The attention
NMT model (``models/seq2seq.py``) trains through recurrent groups
(``layers/recurrent_group.py``) on the GRU and fused attention-GRU cores of
``ops/rnn.py``, fed by the token-budget bucketing reader
(``reader/bucketing.py``).  LSTM text classification runs on the LSTM core
(``networks.simple_lstm``), and the CRF sequence tagger
(``models/sequence_tagging.py``) on the simple-RNN core under
``crf``/``crf_decoding``.  The image types (``convt``, the cross-map norm,
``maxout``, ``pad``, ``crop``, ``bilinear_interp``, ``spp``,
``featmap_expand``, ``block_expand``), the conv operator and CTC
(``ctc``/``warp_ctc`` with ``evaluator.ctc_error_evaluator``) carry AlexNet
and CRNN-CTC line recognizers.  The op framework (``framework/``: Scope, the
ten ops, NetOp, Backward, RecurrentOp and the gradient checker), the GAN and
VAE trainers (``models/gan.py``, ``models/vae.py``) and the v2 surface
modules (``model``, ``plot``, ``utils/model_tools.py``,
``utils/plotcurve.py``, ``utils/preprocess_img.py``), the v1 command line
(``python -m paddle_tpu_torch train --job=train|test|time|checkgrad``,
``cli.py``), the profiler and NaN trap (``profiler``) and the config-time
graph lint (``analysis.lint_topology``) run on the same device rule::

    import paddle_tpu_torch as paddle
    paddle.init(seed=1, compute_dtype="bfloat16", use_flash_attention=True)
    cost, probs = paddle.models.transformer.transformer_base(32000, 32000)
    params = paddle.parameters.create(cost, seed=1)
    trainer = paddle.trainer.SGD(cost, params, paddle.optimizer.Momentum(
        learning_rate=0.05, momentum=0.9))
    trainer.train(paddle.batch(reader, 8), num_passes=1, feeding={...})
    with open("params.tar", "wb") as f:
        trainer.save_parameter_to_tar(f)
    with open("params.tar", "rb") as f:
        loaded = paddle.parameters.Parameters.from_tar(f)
    out = paddle.infer(probs, loaded, samples, feeding={...}, batch_size=8)

Entry points run on the card unless the caller passes ``device="cpu"``;
with no CUDA device they raise rather than fall back.
"""

from __future__ import annotations

from paddle_tpu_torch import activation  # noqa: F401
from paddle_tpu_torch import attr  # noqa: F401
from paddle_tpu_torch import checkpoint  # noqa: F401
from paddle_tpu_torch import evaluator  # noqa: F401
from paddle_tpu_torch import event  # noqa: F401
from paddle_tpu_torch import inference  # noqa: F401
from paddle_tpu_torch import optimizer  # noqa: F401
from paddle_tpu_torch import trainer  # noqa: F401
from paddle_tpu_torch import layers as layer  # noqa: F401
from paddle_tpu_torch.layers import networks  # noqa: F401
from paddle_tpu_torch import parameters  # noqa: F401
from paddle_tpu_torch import pooling  # noqa: F401
from paddle_tpu_torch import reader  # noqa: F401
from paddle_tpu_torch.reader import bucketing as _bucketing  # noqa: F401
from paddle_tpu_torch.core import data_types as data_type  # noqa: F401
from paddle_tpu_torch.core import topology  # noqa: F401
from paddle_tpu_torch.core.compiler import CompiledNetwork  # noqa: F401
from paddle_tpu_torch.core.topology import Topology  # noqa: F401
from paddle_tpu_torch.inference import Inference, infer  # noqa: F401
from paddle_tpu_torch.minibatch import batch  # noqa: F401
from paddle_tpu_torch.models import lenet as _lenet  # noqa: F401
from paddle_tpu_torch.models import resnet as _resnet  # noqa: F401
from paddle_tpu_torch.models import seq2seq as _seq2seq  # noqa: F401
from paddle_tpu_torch.models import sequence_tagging as _sequence_tagging  # noqa: F401
from paddle_tpu_torch.models import transformer as _transformer  # noqa: F401
from paddle_tpu_torch import models  # noqa: F401
from paddle_tpu_torch import model  # noqa: F401
from paddle_tpu_torch import plot  # noqa: F401
from paddle_tpu_torch import dataset  # noqa: F401
from paddle_tpu_torch import v1_compat  # noqa: F401
from paddle_tpu_torch import image  # noqa: F401
from paddle_tpu_torch import io  # noqa: F401
from paddle_tpu_torch import obs  # noqa: F401
from paddle_tpu_torch import master_wire  # noqa: F401
from paddle_tpu_torch import master_journal  # noqa: F401
from paddle_tpu_torch import master  # noqa: F401
from paddle_tpu_torch import launcher  # noqa: F401
from paddle_tpu_torch.utils import flags  # noqa: F401
from paddle_tpu_torch.utils import profiler  # noqa: F401

__version__ = "0.1.0"


def init(use_tpu=None, trainer_count=None, seed=None, compute_dtype=None, *, device=None,
         use_gpu=None, **kwargs) -> None:
    """paddle.init for the port, with the JAX package's positional order:
    seeds numpy, python and torch, sets the compute dtype ('bfloat16'
    enables mixed precision for networks built after this call) and the
    default device of the entry points (the card unless ``device="cpu"``;
    raises when CUDA is asked for and absent).

    ``use_tpu``, ``trainer_count`` and ``use_gpu`` are accepted for the JAX
    package's and the reference's surface and recorded as flags; they choose
    nothing: the device comes from ``device=`` alone, so
    ``init(use_gpu=False)`` still runs on the card.  Remaining keyword
    arguments set flags (e.g. use_flash_attention=True); unknown names are
    accepted and ignored, as the JAX package's init does.
    ``check_nans=True`` (by argument, or ``PADDLE_TPU_TORCH_CHECK_NANS=1``)
    arms the NaN trap (``profiler.enable_nan_checks``)."""
    import random

    import numpy as np
    import torch

    from paddle_tpu_torch.core.compiler import as_dtype, set_default_compute_dtype
    from paddle_tpu_torch.core.device import set_default_device
    from paddle_tpu_torch.ops import needs_f32_acc, pin_f32_accumulation

    set_default_device(device if device is not None else "cuda")
    explicit = {
        k: v
        for k, v in dict(use_gpu=use_gpu, use_tpu=use_tpu, trainer_count=trainer_count,
                         seed=seed).items()
        if v is not None
    }
    flags.set_flags(**explicit)
    seed_val = flags.get_flag("seed")
    random.seed(seed_val)
    np.random.seed(seed_val)
    torch.manual_seed(seed_val)
    for k, v in kwargs.items():
        try:
            flags.set_flag(k, v)
        except KeyError:
            pass  # v1 configs pass flags of other builds; accepted and ignored
    dtype_src = compute_dtype if compute_dtype is not None else flags.get_flag("compute_dtype")
    if dtype_src:
        set_default_compute_dtype(dtype_src)
        if needs_f32_acc(as_dtype(dtype_src)):
            pin_f32_accumulation()  # sub-f32 GEMMs accumulate in f32 (ops/__init__.py)
    if flags.get_flag("check_nans"):
        profiler.enable_nan_checks(True)
