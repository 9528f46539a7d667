from .bottom_basic import bottom_basic
from .bottom_blackwell import bottom_blackwell

__all__ = ["bottom_basic", "bottom_blackwell"]
