from .shoal_echoview import shoal_echoview
from .shoal_weill import shoal_weill

__all__ = ["shoal_echoview", "shoal_weill"]
