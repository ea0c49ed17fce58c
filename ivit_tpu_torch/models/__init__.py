from .registry import MODEL_REGISTRY, create_config, create_model
from .swin import swin_config
from .vit import VisionTransformer, vit_config

__all__ = ["MODEL_REGISTRY", "VisionTransformer", "create_config", "create_model", "swin_config", "vit_config"]
