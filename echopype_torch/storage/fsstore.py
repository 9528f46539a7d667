"""fsspec-backed path shim for the storage backends.

The zarr_lite format logic is written against a small slice of the pathlib
API (truediv, mkdir, exists, read/write text+bytes, iterdir, rglob,
relative_to, parent, name, is_dir).  FsspecPath implements exactly that
slice over any fsspec filesystem, so "s3://", "memory://", "gs://" stores
work through the same code paths as local directories (reference analog:
fsspec.get_mapper in echopype/utils/io.py:177 and ek_raw_io.py:102).
"""

from __future__ import annotations

import posixpath
import shutil
from pathlib import Path, PurePosixPath


class FsspecPath:
    """Minimal pathlib-alike over an fsspec filesystem."""

    def __init__(self, fs, path: str):
        self.fs = fs
        self._p = str(path).rstrip("/")

    # -- structure -----------------------------------------------------
    def __truediv__(self, other) -> "FsspecPath":
        return FsspecPath(self.fs, posixpath.join(self._p, str(other)))

    @property
    def parent(self) -> "FsspecPath":
        return FsspecPath(self.fs, posixpath.dirname(self._p))

    @property
    def name(self) -> str:
        return posixpath.basename(self._p)

    def relative_to(self, other) -> PurePosixPath:
        base = str(other._p if isinstance(other, FsspecPath) else other)
        rel = posixpath.relpath(self._p, base)
        return PurePosixPath(rel)

    def __str__(self) -> str:
        proto = getattr(self.fs, "protocol", "")
        if isinstance(proto, (tuple, list)):
            proto = proto[0]
        return f"{proto}://{self._p.lstrip('/')}" if proto else self._p

    def __fspath__(self) -> str:
        return str(self)

    def __lt__(self, other) -> bool:
        return self._p < str(getattr(other, "_p", other))

    def __eq__(self, other) -> bool:
        return isinstance(other, FsspecPath) and self._p == other._p

    def __hash__(self) -> int:
        return hash(self._p)

    # -- queries ---------------------------------------------------------
    def exists(self) -> bool:
        return self.fs.exists(self._p)

    def is_dir(self) -> bool:
        return self.fs.isdir(self._p)

    def iterdir(self):
        for entry in self.fs.ls(self._p, detail=False):
            yield FsspecPath(self.fs, entry)

    def rglob(self, name: str):
        for entry in self.fs.find(self._p):
            if posixpath.basename(entry) == name:
                yield FsspecPath(self.fs, entry)

    # -- I/O ---------------------------------------------------------------
    def mkdir(self, parents: bool = False, exist_ok: bool = False) -> None:
        self.fs.makedirs(self._p, exist_ok=True)

    def read_bytes(self) -> bytes:
        with self.fs.open(self._p, "rb") as f:
            return f.read()

    def write_bytes(self, data: bytes) -> None:
        with self.fs.open(self._p, "wb") as f:
            f.write(data)

    def read_text(self) -> str:
        return self.read_bytes().decode("utf-8")

    def write_text(self, text: str) -> None:
        self.write_bytes(text.encode("utf-8"))

    def unlink(self) -> None:
        self.fs.rm(self._p)

    def rmtree(self) -> None:
        self.fs.rm(self._p, recursive=True)


def as_store_path(store_dir, storage_options=None):
    """Path for a local store, FsspecPath when the path has a URL scheme."""
    if isinstance(store_dir, (Path, FsspecPath)):
        return store_dir
    s = str(store_dir)
    if "://" in s and not s.startswith("file://"):
        import fsspec

        fs, _, paths = fsspec.core.get_fs_token_paths(
            s, storage_options=storage_options or {}
        )
        return FsspecPath(fs, paths[0])
    return Path(store_dir)


def rmtree_store(path) -> None:
    """Recursive delete for Path or FsspecPath stores."""
    if isinstance(path, FsspecPath):
        path.rmtree()
    else:
        shutil.rmtree(path)
