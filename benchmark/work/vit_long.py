"""Operations an image of the ViT over long rows (``reference/vit_long.py``):
the ViT's own count (``vit.py``), since only the row sum of Shiftmax
differs."""

from .vit import forward_ops  # noqa: F401
