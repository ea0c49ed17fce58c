from .artifact import load_artifact, save_artifact
from .checkpoint import load_checkpoint, load_checkpoint_raw, save_checkpoint
from .metrics import AverageMeter, MetricLogger

__all__ = ["AverageMeter", "MetricLogger", "load_artifact", "load_checkpoint", "load_checkpoint_raw",
           "save_artifact", "save_checkpoint"]
