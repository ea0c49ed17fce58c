from .qtensor import QTensor
from .quantizers import int_range, per_channel_minmax, symmetric_scale, weight_scale
from .ste import floor_ste, quantize, round_ste

__all__ = [
    "QTensor",
    "floor_ste",
    "int_range",
    "per_channel_minmax",
    "quantize",
    "round_ste",
    "symmetric_scale",
    "weight_scale",
]
