"""File I/O helpers: path validation, remote access, swap-store lifecycle.

Capability parity: echopype/utils/io.py — output path validation, existence
and permission checks, temp swap store lifecycle.  Paths with a URL scheme
("s3://", "memory://", ...) are routed through fsspec — raw-file reads
(reference convert/utils/ek_raw_io.py:102) and zarr stores
(reference utils/io.py:177) both accept ``storage_options``.
"""

import os
import shutil
import tempfile
from pathlib import Path


def is_remote_path(path) -> bool:
    """True when the path carries a non-local URL scheme fsspec should handle."""
    s = str(path)
    return "://" in s and not s.startswith("file://")


def read_source_bytes(path, storage_options=None) -> bytes:
    """Read a whole source file, locally or via fsspec for URL-style paths."""
    if is_remote_path(path):
        import fsspec

        with fsspec.open(str(path), "rb", **(storage_options or {})) as f:
            return f.read()
    return Path(path).read_bytes()


def source_exists(path, storage_options=None) -> bool:
    """Existence check that understands fsspec URLs."""
    if is_remote_path(path):
        import fsspec

        fs, _, paths = fsspec.core.get_fs_token_paths(
            str(path), storage_options=storage_options or {}
        )
        return fs.exists(paths[0])
    return Path(path).exists()

SUPPORTED_ENGINES = {
    ".nc": "netcdf4",
    ".zarr": "zarr",
}


ECHOPYPE_DIR = Path(os.path.expanduser("~")) / ".echopype_tpu"


def init_ep_dir():
    """Create the per-user working directory (reference utils/io.py:47-53)."""
    ECHOPYPE_DIR.mkdir(exist_ok=True)
    return ECHOPYPE_DIR


def get_file_format(path) -> str:
    p = str(path)
    if p.endswith(".zarr") or p.endswith(".zarr/"):
        return "zarr"
    if p.endswith(".nc"):
        return "netcdf4"
    raise ValueError(f"Unsupported file format for {p!r} (use .zarr or .nc)")


def validate_output_path(source_file: str, engine: str, output_storage_options=None, save_path=None):
    """Resolve the output path for a converted/combined store."""
    if save_path is None:
        base = Path(source_file).stem
        ext = ".zarr" if engine == "zarr" else ".nc"
        out_dir = Path("~/.echopype_tpu/temp_output").expanduser()
        out_dir.mkdir(parents=True, exist_ok=True)
        return str(out_dir / (base + ext))
    save_path = Path(save_path)
    if save_path.suffix == "":
        base = Path(source_file).stem
        ext = ".zarr" if engine == "zarr" else ".nc"
        save_path.mkdir(parents=True, exist_ok=True)
        return str(save_path / (base + ext))
    save_path.parent.mkdir(parents=True, exist_ok=True)
    return str(save_path)


def check_file_existence(path) -> bool:
    return Path(path).exists()


def check_file_permissions(out_dir):
    out_dir = Path(out_dir)
    if not os.access(out_dir if out_dir.exists() else out_dir.parent, os.W_OK):
        raise PermissionError(f"Writing to {out_dir} is not permitted.")


def create_temp_zarr_store(prefix="ep_tpu_swap_"):
    """Create a temp directory to hold a swap zarr store; caller owns cleanup."""
    return tempfile.mkdtemp(prefix=prefix)


def delete_zarr_store(store_path):
    shutil.rmtree(store_path, ignore_errors=True)


def env_dir() -> Path:
    d = Path("~/.echopype_tpu").expanduser()
    d.mkdir(parents=True, exist_ok=True)
    return d


def open_source(obj, kind: str = "dataset", storage_options=None):
    """Accept an in-memory object or a store path (reference utils/io.py:387-458).

    kind="dataset" opens a one-group zarr store as a Dataset;
    kind="echodata" opens a converted store as EchoData.
    """
    from pathlib import Path as _P

    if isinstance(obj, (str, _P)):
        if kind == "echodata":
            from ..echodata.echodata import EchoData

            return EchoData.from_file(obj, storage_options=storage_options)
        from .. import storage

        return storage.open_dataset(obj, storage_options=storage_options)
    return obj
