from .registry import FLOAT_REGISTRY, MODEL_REGISTRY, create_config, create_model
from .swin import swin_config
from .swin_float import FloatSwinTransformer
from .vit import VisionTransformer, vit_config
from .vit_float import FloatVisionTransformer

__all__ = ["FLOAT_REGISTRY", "FloatSwinTransformer", "FloatVisionTransformer", "MODEL_REGISTRY", "VisionTransformer",
           "create_config", "create_model", "swin_config", "vit_config"]
