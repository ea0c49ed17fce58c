"""QAT training: state, steps, losses, the learning-rate schedule, and
mixup/cutmix.

Counterpart of ``ivit_tpu/train/``.
"""

from .augment import MixupConfig, mixup_cutmix
from .losses import cross_entropy, distillation_loss, soft_target_cross_entropy, topk_accuracy
from .schedule import cosine_schedule
from .state import SGD, AdamW, TrainState, create_train_state
from .steps import make_eval_step, make_train_step

__all__ = [
    "AdamW",
    "MixupConfig",
    "SGD",
    "TrainState",
    "cosine_schedule",
    "create_train_state",
    "cross_entropy",
    "distillation_loss",
    "make_eval_step",
    "make_train_step",
    "mixup_cutmix",
    "soft_target_cross_entropy",
    "topk_accuracy",
]
