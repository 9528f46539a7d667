from .cm import EK500_COLORS, ek500_cmap

__all__ = ["ek500_cmap", "EK500_COLORS"]
