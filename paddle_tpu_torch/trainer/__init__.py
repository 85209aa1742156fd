from paddle_tpu_torch.trainer.sgd import SGD  # noqa: F401
from paddle_tpu_torch.trainer.step import make_eval_step, make_train_step  # noqa: F401
