from .api import coerce_increasing_time, exist_reversed_time, orchestrate_reverse_time_check

__all__ = ["coerce_increasing_time", "exist_reversed_time", "orchestrate_reverse_time_check"]
