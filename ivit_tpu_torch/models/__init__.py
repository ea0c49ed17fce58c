from .registry import MODEL_REGISTRY, create_config
from .swin import swin_config
from .vit import vit_config

__all__ = ["MODEL_REGISTRY", "create_config", "swin_config", "vit_config"]
