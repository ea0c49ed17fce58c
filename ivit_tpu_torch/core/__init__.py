from .quantizers import per_channel_minmax, quantize, symmetric_scale, weight_scale

__all__ = ["per_channel_minmax", "quantize", "symmetric_scale", "weight_scale"]
