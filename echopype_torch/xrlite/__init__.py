"""xrlite: a minimal, dependency-free labeled-array layer.

The reference framework (echopype) exposes xarray Datasets/DataArrays at every API
boundary.  This rebuild keeps that labeled-array UX at the *boundary* only — internals
are plain numpy arrays and torch tensors moving through the device kernels —
so all we need is a small, predictable labeled-array core:

- :class:`DataArray` — an ndarray + named dims + coords + attrs
- :class:`Dataset`   — a mapping of DataArrays sharing dims
- :func:`concat`, :func:`merge`, :func:`broadcast` helpers

Broadcasting is by *dimension name* (same rule xarray uses); label alignment is
intentionally strict (shared dims must have equal sizes) because every producer
in this framework emits consistent grids.

Capability parity notes: replaces the xarray usage documented in SURVEY.md §2.2
(reference: echopype/echodata/echodata.py:43 wraps xr.DataTree).
"""

from .dataarray import DataArray
from .dataset import Dataset
from .ops import align_dims, broadcast_arrays, concat, full_like, merge, where, zeros_like

__all__ = [
    "DataArray",
    "Dataset",
    "concat",
    "merge",
    "where",
    "broadcast_arrays",
    "align_dims",
    "zeros_like",
    "full_like",
]
