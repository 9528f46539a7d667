"""Present xrlite as an ``xarray`` module.

This lets xarray-idiomatic user code (and, in the test suite, the reference
implementation itself, executed as a differential oracle) run directly on
xrlite's labeled arrays.  The facade re-exports xrlite's ``Dataset`` and
module ops under xarray's names, adapts ``DataArray``'s constructor argument
order (xarray: ``DataArray(data, coords, dims, name, attrs)``; xrlite:
``DataArray(values, dims, coords, attrs, name)``), and adds the module-level
functions the reference uses (``where``, ``merge``, ``concat``,
``apply_ufunc``, ``align``, ``broadcast``, ``full_like``/``zeros_like``/
``ones_like``).

``install()`` registers the facade in ``sys.modules["xarray"]`` (no-op when a
real xarray is already importable).
"""

from __future__ import annotations

import importlib.machinery
import sys
import types

import numpy as np

from . import ops as _ops
from .dataarray import DataArray as _XrliteDataArray
from .dataset import Dataset

__all__ = ["DataArray", "Dataset", "install", "make_module"]


class _CompatMeta(type):
    """isinstance(x, facade.DataArray) accepts any xrlite DataArray.

    Reference code type-checks its inputs (e.g. env_params.py:109-110); our
    groups hold base-class xrlite arrays, so the facade class must treat them
    as its own.
    """

    def __instancecheck__(cls, obj):
        return isinstance(obj, _XrliteDataArray)


class DataArray(_XrliteDataArray, metaclass=_CompatMeta):
    """xrlite DataArray with xarray's constructor signature."""

    __slots__ = ()

    def __init__(self, data=None, coords=None, dims=None, name=None, attrs=None):
        if isinstance(dims, str):
            dims = (dims,)
        if isinstance(coords, (list, tuple)):
            # xarray positional coords: one entry per dim, in dim order
            if dims is None:
                raise ValueError("positional coords require explicit dims")
            coords = {
                d: (c.values if isinstance(c, _XrliteDataArray) else np.asarray(c))
                for d, c in zip(dims, coords)
            }
        super().__init__(data, dims=dims, coords=coords, attrs=attrs, name=name)


def where(cond, x, y, keep_attrs=None):
    return _ops.where(cond, x, y)


def merge(objects, compat="no_conflicts", join="outer", **kwargs):
    return _ops.merge(objects, compat=compat, join=join)


def concat(objs, dim, coords="minimal", data_vars="minimal", **kwargs):
    return _ops.concat(objs, dim, coords=coords, data_vars=data_vars)


def full_like(other, fill_value, dtype=None):
    return _ops.full_like(other, fill_value, dtype=dtype)


def zeros_like(other, dtype=None):
    return _ops.zeros_like(other, dtype=dtype)


def ones_like(other, dtype=None):
    return _ops.full_like(other, 1, dtype=dtype)


def broadcast(*args):
    """Broadcast DataArrays against each other by dim name."""
    if len(args) == 1:
        return args
    out = list(args)
    base = out[0]
    for i in range(1, len(out)):
        base, out[i] = _ops.broadcast_arrays(base, out[i])
    # second pass so earlier entries pick up dims introduced by later ones
    final = []
    for a in out:
        ab, _ = _ops.broadcast_arrays(a, base)
        final.append(ab)
    return tuple(final)


def align(*objects, join="inner", copy=True, fill_value=np.nan):
    """Label alignment. xrlite arrays are assumed pre-aligned (exact join)."""
    return objects


def combine_by_coords(data_objects, **kwargs):
    """1-D mosaic case of xarray's combine_by_coords: concatenate blocks
    along the single dim whose coordinates differ, ordered by coordinate.

    This is the composition EnvParams._apply uses for its extrapolate-below /
    interpolate-within / extrapolate-above blocks (reference
    calibrate/env_params_old.py:177-182).  N-D mosaics are out of scope.
    """
    blocks = list(data_objects)
    if not blocks:
        raise ValueError("must supply at least one object to combine")
    if len(blocks) == 1:
        return blocks[0]
    dims = set(blocks[0].dims)
    if any(set(b.dims) != dims for b in blocks[1:]):
        raise NotImplementedError("combine_by_coords facade: blocks must share dims")
    differing = [
        d
        for d in dims
        if len({np.asarray(b[d].values).tobytes() for b in blocks}) > 1
    ]
    if not differing:
        return _ops.merge(blocks)
    if len(differing) > 1:
        raise NotImplementedError("combine_by_coords facade supports one varying dim")
    dim = differing[0]
    blocks = sorted(blocks, key=lambda b: np.asarray(b[dim].values).ravel()[0])
    return _ops.concat(blocks, dim, coords="minimal", data_vars="all")


def apply_ufunc(
    func,
    *args,
    input_core_dims=None,
    output_core_dims=None,
    exclude_dims=frozenset(),
    vectorize=False,
    dask=None,
    output_dtypes=None,
    kwargs=None,
    keep_attrs=None,
    **extra,
):
    """Minimal xr.apply_ufunc: single output, numpy execution.

    Supports the reference's usage pattern (pulse compression,
    calibrate/ek80_complex.py:356-364): DataArray inputs with
    ``input_core_dims``/``output_core_dims`` and ``vectorize=True``; the
    function is applied over every loop-dim slice with core dims moved last.
    """
    kwargs = kwargs or {}
    das = [a for a in args if isinstance(a, _XrliteDataArray)]
    if not das:
        return func(*args, **kwargs)
    if input_core_dims is None:
        input_core_dims = [()] * len(args)
    if output_core_dims is None:
        output_core_dims = [()]
    n_out = len(output_core_dims)

    # broadcast DataArray inputs against each other over loop (non-core) dims
    base = das[0]
    loop_dims = tuple(
        d
        for a, cd in zip(args, input_core_dims)
        if isinstance(a, _XrliteDataArray)
        for d in a.dims
        if d not in cd
    )
    # stable-dedup loop dims
    seen = []
    for d in loop_dims:
        if d not in seen:
            seen.append(d)
    loop_dims = tuple(seen)

    prepared = []
    for a, cd in zip(args, input_core_dims):
        if isinstance(a, _XrliteDataArray):
            order = [d for d in loop_dims if d in a.dims] + list(cd)
            at = a.transpose(*order)
            # insert singleton axes for loop dims the input lacks
            vals = at.values
            shape = []
            for d in loop_dims:
                shape.append(at.sizes.get(d, 1))
            shape += [at.sizes[d] for d in cd]
            vals = vals.reshape(shape)
            prepared.append((vals, len(cd)))
        else:
            prepared.append((a, None))

    loop_sizes = {}
    for a, cd in zip(args, input_core_dims):
        if isinstance(a, _XrliteDataArray):
            for d in a.dims:
                if d not in cd:
                    loop_sizes[d] = a.sizes[d]
    loop_shape = tuple(loop_sizes.get(d, 1) for d in loop_dims)

    if not vectorize or not loop_shape:
        res = func(*[v for v, _ in prepared], **kwargs)
        results = list(res) if isinstance(res, tuple) else [res]
    else:
        # loop over every index of the loop dims
        results = [None] * n_out
        for idx in np.ndindex(*loop_shape):
            call_args = []
            for v, n in prepared:
                if n is None:
                    call_args.append(v)
                else:
                    sel = tuple(
                        0 if v.shape[i] == 1 else idx[i] for i in range(len(loop_shape))
                    )
                    call_args.append(v[sel])
            r = func(*call_args, **kwargs)
            r = r if isinstance(r, tuple) else (r,)
            for i in range(n_out):
                ri = np.asarray(r[i])
                if results[i] is None:
                    results[i] = np.empty(
                        loop_shape + ri.shape,
                        dtype=output_dtypes[i] if output_dtypes else ri.dtype,
                    )
                results[i][idx] = ri

    outs = []
    for i in range(n_out):
        result = np.asarray(results[i])
        out_dims = loop_dims + tuple(output_core_dims[i])
        if result.ndim != len(out_dims):
            # un-vectorized call that already returned full shape
            result = result.reshape(loop_shape + result.shape[len(loop_shape) :])
        out = _XrliteDataArray(result, out_dims, name=base.name)
        for k, v in base.coords.items():
            if set(v.dims) <= set(out_dims) and all(
                out.sizes.get(d) == v.sizes[d] for d in v.dims
            ):
                out.coords[k] = v
        outs.append(out)
    return outs[0] if n_out == 1 else tuple(outs)


def set_options(**kwargs):
    class _Ctx:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    return _Ctx()


def _make_coding_module() -> types.ModuleType:
    """xarray.coding.times subset: CF datetime encode/decode for the
    reference's time-encoding round-trip (utils/coding.py:85-95)."""
    coding = types.ModuleType("xarray.coding")
    times = types.ModuleType("xarray.coding.times")

    _UNIT_NS = {
        "nanoseconds": 1,
        "microseconds": 10**3,
        "milliseconds": 10**6,
        "seconds": 10**9,
        "minutes": 60 * 10**9,
        "hours": 3600 * 10**9,
        "days": 86400 * 10**9,
    }

    def _parse_units(units):
        unit, _, epoch = units.partition(" since ")
        epoch = epoch.strip().rstrip("Z").replace(" ", "T")
        return _UNIT_NS[unit.strip()], np.datetime64(epoch, "ns")

    def encode_cf_datetime(dates, units=None, calendar=None, dtype=None):
        units = units or "nanoseconds since 1970-01-01T00:00:00Z"
        step_ns, epoch = _parse_units(units)
        vals = np.asarray(dates, dtype="datetime64[ns]")
        num = (vals - epoch).astype("i8") // step_ns
        return num, units, calendar or "proleptic_gregorian"

    def decode_cf_datetime(num_dates, units, calendar=None, **kw):
        step_ns, epoch = _parse_units(units)
        num = np.asarray(num_dates, dtype="i8")
        return epoch + (num * step_ns).astype("timedelta64[ns]")

    times.encode_cf_datetime = encode_cf_datetime
    times.decode_cf_datetime = decode_cf_datetime
    coding.times = times
    return coding


def make_module() -> types.ModuleType:
    """Build a module object exposing this facade under the xarray API."""
    from . import datatree as _dt

    mod = types.ModuleType("xarray")
    # a spec without an origin: importlib.util.find_spec("xarray") raises on
    # a module whose __spec__ is None, and torch's compiler stack, which
    # torch.profiler imports, runs find_spec over a list of packages
    mod.__spec__ = importlib.machinery.ModuleSpec("xarray", None)
    mod.coding = _make_coding_module()
    sys.modules.setdefault("xarray.coding", mod.coding)
    sys.modules.setdefault("xarray.coding.times", mod.coding.times)
    # Variable: annotation-only in the reference (utils/coding.py:164);
    # xrlite DataArrays duck-type the Variable surface
    mod.Variable = _XrliteDataArray
    mod.DataArray = DataArray
    mod.Dataset = Dataset
    mod.DataTree = _dt.DataTree
    mod.open_dataset = _dt.open_dataset
    mod.open_datatree = _dt.open_datatree
    mod.open_groups = _dt.open_groups
    mod.where = where
    mod.merge = merge
    mod.concat = concat
    mod.full_like = full_like
    mod.zeros_like = zeros_like
    mod.ones_like = ones_like
    mod.broadcast = broadcast
    mod.align = align
    mod.combine_by_coords = combine_by_coords
    mod.apply_ufunc = apply_ufunc
    mod.set_options = set_options
    # a real (parseable, recent) version string: pandas' DataFrame.to_xarray
    # gates on a minimum xarray version before delegating to
    # Dataset.from_dataframe; identify the facade via __xrlite__ instead
    mod.__version__ = "2025.7.0"
    mod.__xrlite__ = True
    return mod


def install(force: bool = False) -> bool:
    """Register the facade as ``xarray`` in sys.modules.

    Returns True when installed.  When a real xarray is importable (or
    already imported) and ``force`` is False, does nothing.
    """
    if not force:
        if "xarray" in sys.modules:
            return bool(getattr(sys.modules["xarray"], "__xrlite__", False))
        try:
            import importlib.util

            if importlib.util.find_spec("xarray") is not None:
                return False
        except (ImportError, ValueError):
            pass
    sys.modules["xarray"] = make_module()
    return True
