"""The op-level framework (reference: paddle/framework/operator.h,
op_registry.h:338, scope.h:36, net_op.h, backward.cc,
python/paddle/v2/framework/); the counterpart of
``paddle_tpu/framework/``, with its names.

Ops are torch functions over the tensors of a Scope on one device (the card
unless the caller asks for the CPU).  A NetOp runs its op list eagerly, one
torch call per op; ``Backward`` derives the gradient with
``torch.autograd.grad`` over the forward's trace instead of per-op grad
ops; a RecurrentOp loops its step net over time."""

from paddle_tpu_torch.framework.scope import Scope, Variable  # noqa: F401
from paddle_tpu_torch.framework.op import (  # noqa: F401
    Operator,
    OpRegistry,
    create_op,
    register_op,
)
from paddle_tpu_torch.framework.net import NetOp  # noqa: F401
from paddle_tpu_torch.framework.backward import Backward, BackwardOp  # noqa: F401
from paddle_tpu_torch.framework.recurrent import RecurrentOp  # noqa: F401
from paddle_tpu_torch.framework import ops  # noqa: F401  (registers the op set)
from paddle_tpu_torch.framework.gradient_checker import (  # noqa: F401
    check_gradients,
    numeric_gradient,
)
