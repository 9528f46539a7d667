from .api import apply_mask, detect_seafloor, detect_shoal, frequency_differencing, regrid_mask

__all__ = [
    "apply_mask",
    "frequency_differencing",
    "regrid_mask",
    "detect_seafloor",
    "detect_shoal",
]
