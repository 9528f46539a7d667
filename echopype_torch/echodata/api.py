"""open_converted: lazy-open a converted store as EchoData.

Capability parity: echopype/echodata/api.py:9.
"""

from .echodata import EchoData

__all__ = ["open_converted"]


def open_converted(converted_raw_path, storage_options=None, **kwargs) -> EchoData:
    """Open a converted store (.zarr or .nc, local or fsspec URL) as EchoData."""
    return EchoData.from_file(converted_raw_path, storage_options=storage_options, **kwargs)
