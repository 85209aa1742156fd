from paddle_tpu_torch.trainer.sgd import SGD  # noqa: F401
from paddle_tpu_torch.trainer.step import (  # noqa: F401
    make_eval_step, make_forward_fn, make_grad_step, make_multi_train_step, make_train_step)
