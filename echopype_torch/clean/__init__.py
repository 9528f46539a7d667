from .api import (
    detect_transient,
    estimate_background_noise,
    mask_attenuated_signal,
    mask_impulse_noise,
    mask_transient_noise,
    remove_background_noise,
)

__all__ = [
    "estimate_background_noise",
    "remove_background_noise",
    "mask_transient_noise",
    "mask_impulse_noise",
    "mask_attenuated_signal",
    "detect_transient",
]
