from .artifact import artifact_to_torch, validate_artifact
from .convert import freeze_vit
from .engine import build_vit_infer
from .export import export_engine, load_engine
from .swin_artifact import swin_artifact_spec, swin_artifact_to_torch, validate_swin_artifact
from .swin_engine import build_swin_infer, freeze_swin
from .swin_synthetic import synthetic_swin_artifact
from .synthetic import synthetic_vit_artifact

__all__ = [
    "artifact_to_torch",
    "build_swin_infer",
    "build_vit_infer",
    "export_engine",
    "freeze_swin",
    "freeze_vit",
    "load_engine",
    "swin_artifact_spec",
    "swin_artifact_to_torch",
    "synthetic_swin_artifact",
    "synthetic_vit_artifact",
    "validate_artifact",
    "validate_swin_artifact",
]
