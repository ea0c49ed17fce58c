from .artifact import artifact_to_torch, validate_artifact
from .engine import build_vit_infer
from .synthetic import synthetic_vit_artifact

__all__ = ["artifact_to_torch", "build_vit_infer", "synthetic_vit_artifact", "validate_artifact"]
