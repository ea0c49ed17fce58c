"""QAT training: state, steps, losses and the learning-rate schedule.

Counterpart of ``ivit_tpu/train/`` without ``augment.py`` (mixup and
cutmix come with the data pipeline).
"""

from .losses import cross_entropy, distillation_loss, soft_target_cross_entropy, topk_accuracy
from .schedule import cosine_schedule
from .state import AdamW, TrainState, create_train_state
from .steps import make_eval_step, make_train_step

__all__ = [
    "AdamW",
    "TrainState",
    "cosine_schedule",
    "create_train_state",
    "cross_entropy",
    "distillation_loss",
    "make_eval_step",
    "make_train_step",
    "soft_target_cross_entropy",
    "topk_accuracy",
]
