from .api import add_depth, add_location, add_splitbeam_angle, swap_dims_channel_frequency

__all__ = ["swap_dims_channel_frequency", "add_depth", "add_location", "add_splitbeam_angle"]
