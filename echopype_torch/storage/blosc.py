"""ctypes binding to the system c-blosc 1.x for zarr store interop.

The reference's zarr stores default to Blosc compression — zstd-3 with
bitshuffle for floats, lz4-5 with byteshuffle for ints/times/strings
(echopype/utils/coding.py:17-29).  zarr-python/numcodecs are not in this
environment, but the system libblosc.so.1 (c-blosc 1.21, all codecs incl.
zstd) is; this module binds its *_ctx context API (thread-safe, no global
init needed) so zarr_lite can read reference-produced stores and write
byte-compatible ones.
"""

from __future__ import annotations

import ctypes

# numcodecs Blosc shuffle constants (mirrored in .zarray metadata)
NOSHUFFLE = 0
SHUFFLE = 1
BITSHUFFLE = 2

_lib = None
_load_failed = False


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    for name in ("libblosc.so.1", "libblosc.so", "libblosc.1.dylib", "blosc"):
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.blosc_compress_ctx.restype = ctypes.c_int
        lib.blosc_decompress_ctx.restype = ctypes.c_int
        lib.blosc_cbuffer_sizes.restype = None
        _lib = lib
        return _lib
    _load_failed = True
    return None


def available() -> bool:
    return _load() is not None


def cbuffer_nbytes(buf: bytes) -> int:
    """Uncompressed size recorded in a blosc frame header."""
    lib = _load()
    nbytes = ctypes.c_size_t()
    cbytes = ctypes.c_size_t()
    blocksize = ctypes.c_size_t()
    lib.blosc_cbuffer_sizes(
        buf, ctypes.byref(nbytes), ctypes.byref(cbytes), ctypes.byref(blocksize)
    )
    return int(nbytes.value)


def decompress(buf: bytes) -> bytes:
    lib = _load()
    if lib is None:
        raise ValueError(
            "This store uses Blosc compression but no libblosc is available"
        )
    # blosc frames start with a 16-byte header; a truncated chunk must raise
    # here rather than let the C side read past the buffer
    if len(buf) < 16:
        raise ValueError(f"truncated blosc frame ({len(buf)} bytes)")
    n = cbuffer_nbytes(buf)
    out = ctypes.create_string_buffer(n) if n else b""
    if n == 0:
        return b""
    rc = lib.blosc_decompress_ctx(buf, out, ctypes.c_size_t(n), ctypes.c_int(1))
    if rc < 0 or rc != n:
        raise ValueError(f"blosc decompression failed (rc={rc}, expected {n} bytes)")
    return out.raw


def compress(
    data: bytes, typesize: int, cname: str = "zstd", clevel: int = 3, shuffle: int = BITSHUFFLE
) -> bytes:
    lib = _load()
    if lib is None:
        raise ValueError("libblosc is not available for compression")
    # blosc supports typesize 1..255; shuffling wider elements is meaningless
    if not 1 <= typesize <= 255:
        typesize, shuffle = 8, NOSHUFFLE
    n = len(data)
    dest = ctypes.create_string_buffer(n + 16 + 32)  # BLOSC_MAX_OVERHEAD
    rc = lib.blosc_compress_ctx(
        ctypes.c_int(clevel),
        ctypes.c_int(shuffle),
        ctypes.c_size_t(typesize),
        ctypes.c_size_t(n),
        data,
        dest,
        ctypes.c_size_t(len(dest)),
        cname.encode(),
        ctypes.c_size_t(0),  # automatic blocksize
        ctypes.c_int(1),
    )
    if rc <= 0:
        raise ValueError(f"blosc compression failed (rc={rc}, cname={cname})")
    return dest.raw[:rc]
