from .api import open_raw, to_file

__all__ = ["open_raw", "to_file"]
