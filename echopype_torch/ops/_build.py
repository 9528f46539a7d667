"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (pointers and the stream as
``void*``, sizes as ``int``, ``cudaGetLastError()`` as the return value), so
it compiles in seconds without PyTorch's headers.  The shared library goes
to ``echopype_torch/_kernels/`` (listed in ``.gitignore``) under a name
that carries a hash of the source, at first use, and is loaded once per
process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["load_library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME); cannot build the kernels")
    return found


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source exists.

    Returns (library path, compiler output; empty when the build was reused).
    """
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{name}-{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True, timeout=600,
        )
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{res.stdout}{res.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, res.stdout + res.stderr


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library, built on first use."""
    with _lock:
        if name not in _loaded:
            path, _ = build(name)
            _loaded[name] = ctypes.CDLL(str(path))
        return _loaded[name]
