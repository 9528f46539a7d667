"""Native (C++) ingest runtime, loaded via ctypes.

The framing scan is the host-side hot loop of conversion (SURVEY.md marks
echopype's per-datagram Python loop, ek_raw_io.py:67, as the #1 hot spot and
a native-code candidate).  The C++ scanner here walks the length-prefixed
datagram stream in one pass; the Python fallback (convert/simrad/framing.py)
is used when no compiler is available.

The shared library is compiled on demand with g++ into this package
directory (``echopype_torch/native/_ingest.so``, not committed) and cached;
``load_native()`` returns None when unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_HERE = Path(__file__).parent
_SRC = _HERE / "src" / "ingest.cpp"
_LIB = _HERE / "_ingest.so"

_lib = None
_load_attempted = False


def _compile() -> bool:
    # build beside the target and rename: processes that load the library
    # at the same time never see a partly written file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_HERE)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", tmp],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _LIB)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_native():
    """Return the ctypes lib handle, compiling if needed; None if unavailable."""
    global _lib, _load_attempted
    if _lib is not None:
        return _lib
    if _load_attempted:
        return None
    _load_attempted = True
    if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
        if not _compile():
            return None
    try:
        lib = ctypes.CDLL(str(_LIB))
    except OSError:
        return None
    lib.ep_scan_datagrams.restype = ctypes.c_int64
    lib.ep_scan_datagrams.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.ep_gather_i16.restype = None
    lib.ep_gather_i16.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    for fused in ("ep_gather_i16_scale_f32", "ep_gather_angle_f32"):
        fn = getattr(lib, fused, None)
        if fn is not None:
            fn.restype = None
    lib.ep_gather_i16_scale_f32.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.ep_gather_angle_f32.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
    ]
    if hasattr(lib, "ep_gather_f32_nan"):
        lib.ep_gather_f32_nan.restype = None
        lib.ep_gather_f32_nan.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
        ]
    _lib = lib
    return _lib


def gather_f32_nan(buf, starts, counts, max_vals: int):
    """Fused native f32 gather, NaN-padded -> f4 [n, max_vals]; None if no lib."""
    lib = load_native()
    if lib is None or not hasattr(lib, "ep_gather_f32_nan"):
        return None
    u8 = np.frombuffer(buf, dtype="u1") if not isinstance(buf, np.ndarray) else buf
    starts = np.ascontiguousarray(starts, dtype="i8")
    counts = np.ascontiguousarray(counts, dtype="i8")
    out = np.empty((len(starts), max_vals), dtype="f4")
    lib.ep_gather_f32_nan(
        u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(starts),
        max_vals,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def gather_i16_scaled(buf, starts, counts, max_count: int, scale: float):
    """Fused native gather+scale+NaN-pad -> f4 [n, max_count]; None if no lib."""
    lib = load_native()
    if lib is None or not hasattr(lib, "ep_gather_i16_scale_f32"):
        return None
    u8 = np.frombuffer(buf, dtype="u1") if not isinstance(buf, np.ndarray) else buf
    starts = np.ascontiguousarray(starts, dtype="i8")
    counts = np.ascontiguousarray(counts, dtype="i8")
    out = np.empty((len(starts), max_count), dtype="f4")
    lib.ep_gather_i16_scale_f32(
        u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(starts),
        max_count,
        ctypes.c_float(scale),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def gather_angle(buf, starts, counts, max_count: int):
    """Fused native angle gather -> f4 [n, max_count, 2]; None if no lib."""
    lib = load_native()
    if lib is None or not hasattr(lib, "ep_gather_angle_f32"):
        return None
    u8 = np.frombuffer(buf, dtype="u1") if not isinstance(buf, np.ndarray) else buf
    starts = np.ascontiguousarray(starts, dtype="i8")
    counts = np.ascontiguousarray(counts, dtype="i8")
    out = np.empty((len(starts), max_count, 2), dtype="f4")
    lib.ep_gather_angle_f32(
        u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(starts),
        max_count,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def gather_i16(buf, starts: np.ndarray, counts: np.ndarray, max_count: int):
    """Native padded int16 gather; returns (vals i2 [n,max], valid bool) or
    None when the native library is unavailable.  ``buf`` may be bytes or a
    uint8 ndarray view -- no copy is made either way."""
    lib = load_native()
    if lib is None:
        return None
    u8 = np.frombuffer(buf, dtype="u1") if not isinstance(buf, np.ndarray) else buf
    n = len(starts)
    starts = np.ascontiguousarray(starts, dtype="i8")
    counts = np.ascontiguousarray(counts, dtype="i8")
    vals = np.empty((n, max_count), dtype="<i2")
    valid = np.empty((n, max_count), dtype="u1")
    lib.ep_gather_i16(
        u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        max_count,
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return vals, valid.view(np.bool_)


def scan_datagrams_native(buf: bytes, resync: bool = True):
    """Native framing scan -> (offsets i64, sizes i32, type_codes u32, ts_ns i64).

    Returns None if the native library is unavailable.
    Raises ValueError on bad framing when resync is False.
    """
    lib = load_native()
    if lib is None:
        return None
    n = len(buf)
    # worst case one datagram per 20 bytes (12-byte body + two size words)
    capacity = max(16, n // 20 + 2)
    offsets = np.empty(capacity, dtype=np.int64)
    sizes = np.empty(capacity, dtype=np.int32)
    type_codes = np.empty(capacity, dtype=np.uint32)
    ts = np.empty(capacity, dtype=np.int64)
    count = lib.ep_scan_datagrams(
        buf,
        n,
        1 if resync else 0,
        capacity,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        type_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if count < 0:
        raise ValueError(f"bad framing at byte {-count - 1}")
    return (
        offsets[:count].copy(),
        sizes[:count].copy(),
        type_codes[:count].copy(),
        ts[:count].copy(),
    )


def f32_to_i16_scaled(src, dst, scale: float):
    """One-pass ``dst[r,k] = rint(src[r,k]*scale)`` (NaN -> 0, saturating)
    into a possibly wider-strided int16 buffer.  src/dst are 2-D, rows of
    equal length; returns False (caller falls back to numpy) if the native
    lib is unavailable or the layouts aren't unit-stride rows."""
    lib = load_native()
    if (
        lib is None
        or not hasattr(lib, "ep_f32_to_i16_scale")
        or src.dtype != np.float32
        or dst.dtype != np.int16
        or src.ndim != 2
        or dst.ndim != 2
        or src.shape != dst.shape
        or src.strides[1] != 4
        or dst.strides[1] != 2
        or src.strides[0] % 4
        or dst.strides[0] % 2
    ):
        return False
    lib.ep_f32_to_i16_scale(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        src.shape[0],
        src.shape[1],
        src.strides[0] // 4,
        ctypes.c_float(scale),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        dst.strides[0] // 2,
    )
    return True
