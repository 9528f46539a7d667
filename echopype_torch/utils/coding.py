"""Dtype and time encodings for storage.

Capability parity: echopype/utils/coding.py — int64-ns time encodings,
per-dtype compression defaults, dtype sanitation.  Compression here is
stdlib zlib (Blosc is not available in this environment); chunking targets
~100MB like the reference (utils/coding.py:179-241).
"""

import numpy as np

DEFAULT_TIME_ENCODING = {
    "units": "nanoseconds since 1970-01-01T00:00:00Z",
    "calendar": "proleptic_gregorian",
    "dtype": "int64",
}

COMPRESSION_SETTINGS = {
    "zarr": {"compressor": {"id": "zlib", "level": 4}},
}


def zarr_compressor_meta(dtype):
    """Reference-default zarr compressor per dtype (utils/coding.py:17-29):
    Blosc zstd-3 bitshuffle for floats, Blosc lz4-5 byteshuffle otherwise —
    falling back to zlib-4 when no libblosc is present."""
    from ..storage import blosc

    if blosc.available():
        if np.dtype(dtype).kind == "f":
            return {
                "id": "blosc", "cname": "zstd", "clevel": 3,
                "shuffle": blosc.BITSHUFFLE, "blocksize": 0,
            }
        return {
            "id": "blosc", "cname": "lz4", "clevel": 5,
            "shuffle": blosc.SHUFFLE, "blocksize": 0,
        }
    return dict(COMPRESSION_SETTINGS["zarr"]["compressor"])

DEFAULT_CHUNK_BYTES = 100 * 1024 * 1024  # 100 MB, matches reference default

TIME_DIMS = ("ping_time", "time1", "time2", "time3", "time4", "nmea_time", "filter_time")


def is_time_array(arr: np.ndarray) -> bool:
    return np.issubdtype(arr.dtype, np.datetime64)


def encode_array(arr: np.ndarray):
    """Return (encoded ndarray, extra attrs) suitable for on-disk storage."""
    if is_time_array(arr):
        return arr.astype("datetime64[ns]").astype("int64"), dict(DEFAULT_TIME_ENCODING)
    if arr.dtype == object:
        # all-null object arrays (e.g. the AD2CP vendor group's empty
        # `((), None)` variables) store as float64 NaN, matching xarray's
        # ensure_dtype_not_object in the reference's save chain
        flat = arr.ravel()
        if all(v is None or (isinstance(v, float) and np.isnan(v)) for v in flat):
            return np.full(arr.shape, np.nan, dtype="f8"), {}
        # object arrays of strings -> fixed-width unicode
        return arr.astype(str), {}
    return arr, {}


def encode_array_with(arr: np.ndarray, enc: dict):
    """``encode_array`` honoring a CF time encoding (units/calendar/dtype)
    when one is present — xarray's per-variable ``encoding=`` semantics for
    to_zarr/to_netcdf.  Non-time variables and empty encodings fall through
    to the default encoding rules."""
    units = (enc or {}).get("units")
    if units and np.issubdtype(np.asarray(arr).dtype, np.datetime64):
        # the reference package encodes these through xrlite/xarray_compat.py
        raise NotImplementedError(
            "CF time encodings in encoding= are not ported to echopype_torch yet "
            "(ROADMAP Queue 1)"
        )
    return encode_array(arr)


def decode_array(arr: np.ndarray, attrs: dict):
    """Invert encode_array using CF-ish time attrs."""
    units = attrs.get("units", "")
    if isinstance(units, str) and " since " in units and np.issubdtype(arr.dtype, np.integer):
        unit_word = units.split(" since ")[0].strip()
        epoch = units.split(" since ")[1].strip().rstrip("Z")
        np_unit = {
            "nanoseconds": "ns",
            "microseconds": "us",
            "milliseconds": "ms",
            "seconds": "s",
            "minutes": "m",
            "hours": "h",
            "days": "D",
        }.get(unit_word)
        if np_unit is not None:
            base = np.datetime64(epoch.replace(" ", "T"), "ns")
            step = np.timedelta64(1, np_unit).astype("timedelta64[ns]").astype("int64")
            return base + (arr.astype("int64") * step).astype("timedelta64[ns]")
    return arr


def auto_chunks(shape, dtype, target_bytes=None):
    """Pick chunk shape: chunk the leading dim until under target_bytes."""
    if target_bytes is None:
        target_bytes = DEFAULT_CHUNK_BYTES
    itemsize = np.dtype(dtype).itemsize if np.dtype(dtype).itemsize else 8
    total = int(np.prod(shape)) * itemsize
    if not shape or total <= target_bytes:
        return tuple(shape)
    inner = int(np.prod(shape[1:])) * itemsize
    lead = max(1, target_bytes // max(inner, 1))
    return (int(min(lead, shape[0])),) + tuple(shape[1:])


def sanitize_dtypes(arr: np.ndarray) -> np.ndarray:
    """Normalize exotic dtypes for storage (f16->f32, etc.)."""
    if arr.dtype == np.float16:
        return arr.astype(np.float32)
    return arr


# ---------------------------------------------------------------- reference-
# named encoding builders (echopype/utils/coding.py:142-300).  xrlite stores
# no per-variable `.encoding`; these return/stamp the same information the
# reference computes so migrating callers keep working, and the storage layer
# consumes the same defaults when writing.

DEFAULT_ENCODINGS = {
    name: dict(DEFAULT_TIME_ENCODING)
    for name in (
        "nmea_time", "ping_time", "ping_time_transmit",
        "time1", "time2", "time3", "time4", "time5", "filter_time",
    )
}


def set_time_encodings(ds):
    """Return a copy whose known time variables carry the default time
    encoding (reference: utils/coding.py:142-161).  Restricted to the fixed
    DEFAULT_ENCODINGS name list like the reference — an arbitrary
    ``*_time*`` data variable is NOT stamped — and routed through
    ``.encoding`` rather than attrs so CF-aware readers don't see decoding
    attrs on already-decoded datetime64 data."""
    out = ds.copy()
    for var, enc in DEFAULT_ENCODINGS.items():
        if var in out.coords or var in out.data_vars:
            target = out.coords[var] if var in out.coords else out.data_vars[var]
            # reference overwrites the full encoding with the default
            # (utils/coding.py:158); the datetime64[ns] encode/decode
            # round-trip it also runs is an identity at ns resolution
            target.encoding = dict(enc)
    return out


def get_zarr_compression(var, compression_settings: dict) -> dict:
    """Pick the compressor entry for a variable's dtype
    (reference: utils/coding.py:164-176)."""
    dtype = np.dtype(getattr(var, "dtype", var))
    if np.issubdtype(dtype, np.floating):
        return compression_settings["float"]
    elif np.issubdtype(dtype, np.integer):
        return compression_settings["int"]
    elif np.issubdtype(dtype, np.str_) or np.issubdtype(dtype, np.object_):
        return compression_settings["object"]
    elif np.issubdtype(dtype, np.datetime64):
        return compression_settings["time"]
    else:
        raise NotImplementedError(f"Zarr Encoding for dtype = {dtype} has not been set")


def set_zarr_encodings(ds, compression_settings: dict = None, chunk_size="100MB", ctol="10MB"):
    """Per-variable zarr encodings: compressor + auto chunks
    (reference: utils/coding.py:179-241)."""
    encoding = {}
    for name in list(ds.data_vars) + list(ds.coords):
        da = ds[name]
        if compression_settings is not None:
            comp = dict(get_zarr_compression(da, compression_settings))
        else:
            comp = {"compressor": zarr_compressor_meta(da.dtype)}
        comp["chunks"] = auto_chunks(da.shape, da.dtype)
        encoding[name] = comp
    return encoding


def set_netcdf_encodings(ds, compression_settings: dict = None):
    """Per-variable netCDF encodings: zlib for non-string variables
    (reference: utils/coding.py:244-277)."""
    settings = compression_settings or {"zlib": True, "complevel": 4}
    encoding = {
        name: dict(settings)
        for name in list(ds.data_vars) + list(ds.coords)
        if ds[name].dtype.kind not in ("U", "O")
    }
    return encoding


def set_storage_encodings(ds, compression_settings: dict, engine: str):
    """Dispatch to the zarr or netcdf encoding builder
    (reference: utils/coding.py:280-300)."""
    if engine == "zarr":
        return set_zarr_encodings(ds, compression_settings)
    elif engine == "netcdf4":
        return set_netcdf_encodings(ds, compression_settings)
    raise ValueError(f"Unknown storage engine {engine!r}")
