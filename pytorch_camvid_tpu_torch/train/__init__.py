"""Training (counterpart of pytorch_camvid_tpu/train): schedules,
optimizers, the train state and the train / eval steps. The loop,
checkpoints and CLIs are not ported yet (ROADMAP.md)."""

from pytorch_camvid_tpu_torch.train.optim import adamw, sgd
from pytorch_camvid_tpu_torch.train.schedules import (
    constant_lr, exponential_sweep_lr, multistep_lr, onecycle_beta1,
    onecycle_lr, warmup_lr, warmup_then_multistep)
from pytorch_camvid_tpu_torch.train.state import TrainState
from pytorch_camvid_tpu_torch.train.steps import (make_eval_step,
                                                  make_train_step)

__all__ = ["adamw", "sgd", "constant_lr", "exponential_sweep_lr",
           "multistep_lr", "onecycle_beta1", "onecycle_lr", "warmup_lr",
           "warmup_then_multistep", "TrainState", "make_eval_step",
           "make_train_step"]
