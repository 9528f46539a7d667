from .api import open_converted
from .echodata import EchoData
from .sensor_ep_version_mapping import map_ep_version

__all__ = ["EchoData", "open_converted", "map_ep_version"]
