from .netcdf4 import open_dataset as open_netcdf_dataset
from .netcdf4 import open_netcdf_tree
from .netcdf4 import write_dataset as write_netcdf_dataset
from .netcdf4 import write_tree as write_netcdf_tree
from .zarr_lite import (
    open_dataset,
    open_zarr_tree,
    read_group,
    write_dataset,
    write_group,
    write_tree,
)

__all__ = [
    "write_group",
    "read_group",
    "write_tree",
    "open_zarr_tree",
    "write_dataset",
    "open_dataset",
    "write_netcdf_tree",
    "open_netcdf_tree",
    "write_netcdf_dataset",
    "open_netcdf_dataset",
]
