"""External environmental data holder + interpolator (``EnvParams``).

Behavioral contract: echopype/calibrate/env_params_old.py:18-205 — a class
that holds a time- or position-indexed environmental Dataset and
interpolates it onto an EchoData object's Platform coordinates, returning
``{"temperature", "salinity", "pressure"}`` DataArrays on a ``time1`` dim.

Three data kinds:

- ``"stationary"`` (a fixed CTD): the env Dataset is indexed by ``time3``;
  values are interpolated onto the EchoData Platform's ``time3`` points with
  ``interp_method`` inside the source time range and ``extrap_method``
  (linearly/nearest extrapolated) outside it, then the dim is renamed
  ``time1`` (reference :136-182, :197-203).
- ``"mobile"`` (a ship track): the env Dataset carries scattered
  ``latitude``/``longitude`` coordinates; the Platform's lat/lon track is
  first aligned to ``ping_time`` and the env values are then interpolated
  onto the track positions by 2-D scattered-data interpolation
  (reference :105-133).
- ``"organized"`` (a CTD grid): tensor-product grid interpolation over
  (time, latitude, longitude).  Declared "not currently supported" by the
  reference (:70); we mirror the same structural path.

Like the reference (calibrate_base.py:40), ``compute_Sv(env_params=...)``
accepts only ``None | dict`` — an ``EnvParams`` instance is applied
explicitly via ``EnvParams._apply(echodata)`` and the resulting dict passed
on.  This is host-side metadata plumbing (a handful of CTD points), so it
runs in plain numpy/scipy — there is nothing here for the chip.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..xrlite import DataArray

__all__ = ["EnvParams", "VALID_INTERP_METHODS"]

VALID_INTERP_METHODS: Dict[str, List[str]] = {
    "stationary": ["linear", "nearest", "zero", "slinear", "quadratic", "cubic"],
    "mobile": ["linear", "nearest", "cubic"],
    "organized": ["linear", "nearest"],
}

_ENV_VARS = ("temperature", "salinity", "pressure")


def _as_numeric(vals: np.ndarray) -> np.ndarray:
    """datetime64 coords -> f8 ns (the facade/xarray interp convention)."""
    vals = np.asarray(vals)
    if np.issubdtype(vals.dtype, np.datetime64):
        return vals.astype("datetime64[ns]").astype("f8")
    return vals.astype("f8")


def _interp1d(x_old, y_old, x_new, method: str, extrapolate: bool) -> np.ndarray:
    """1-D interpolation matching xarray's scipy delegation (NaN-propagating,
    NaN fill outside the source range unless extrapolating)."""
    if method == "linear" and not extrapolate:
        # scipy interp1d (the reference's delegate) sorts via
        # assume_sorted=False; np.interp silently mis-interpolates on
        # unsorted x (real NMEA time1 streams can be out of order)
        x_old = np.asarray(x_old, dtype="f8")
        y_old = np.asarray(y_old, dtype="f8")
        order = np.argsort(x_old, kind="stable")
        x_old, y_old = x_old[order], y_old[order]
        out = np.interp(x_new, x_old, y_old)
        out = np.where((x_new < x_old[0]) | (x_new > x_old[-1]), np.nan, out)
        return out
    from scipy.interpolate import interp1d

    f = interp1d(
        x_old,
        y_old,
        kind=method,
        bounds_error=False,
        fill_value="extrapolate" if extrapolate else np.nan,
    )
    return f(x_new)


class EnvParams:
    def __init__(
        self,
        env_params,
        data_kind: str,
        interp_method: str = "linear",
        extrap_method: str = "linear",
    ):
        """Hold external environmental data for calibration.

        env_params : Dataset with ``temperature``/``salinity``/``pressure``
        variables, indexed by ``time3`` (stationary), ``latitude``/
        ``longitude`` (mobile) or ``time``/``latitude``/``longitude``
        (organized).  Reference contract: env_params_old.py:19-85.
        """
        if interp_method not in VALID_INTERP_METHODS[data_kind]:
            raise ValueError(f"invalid interp_method {interp_method} for data_kind {data_kind}")

        self.env_params = env_params
        self.data_kind = data_kind
        self.interp_method = interp_method
        self.extrap_method = extrap_method

    # ------------------------------------------------------------------
    def _apply(self, echodata) -> Dict[str, DataArray]:
        """Interpolate onto ``echodata``'s Platform coordinates.

        Returns ``{var: DataArray(time1)}`` for temperature/salinity/pressure
        (reference env_params_old.py:87-205, including its dim checks and
        error strings).
        """
        if self.data_kind == "stationary":
            dims = ["time3"]
        elif self.data_kind == "mobile":
            dims = ["latitude", "longitude"]
        elif self.data_kind == "organized":
            dims = ["time", "latitude", "longitude"]
        else:
            raise ValueError("invalid data_kind")

        platform = echodata["Platform"]
        for dim in dims:
            if dim not in platform:
                raise ValueError(
                    f"could not interpolate env_params; EchoData is missing dimension {dim}"
                )

        if self.data_kind == "mobile":
            return self._apply_mobile(echodata, platform)
        return self._apply_gridded(platform, dims)

    # ------------------------------------------------------------------
    def _apply_mobile(self, echodata, platform) -> Dict[str, DataArray]:
        """Scattered (lat, lon) -> ship-track interpolation
        (reference :105-133): align the Platform track to ping_time, then
        griddata the env values onto the track points."""
        time1 = np.asarray(platform["time1"].values)
        if np.isnan(time1.astype("f8") if time1.dtype.kind != "M" else time1.astype("i8")).all() or (
            time1.dtype.kind == "M" and np.isnat(time1).all()
        ):
            raise ValueError("cannot perform mobile interpolation without time1")

        ping_time = echodata["Sonar/Beam_group1"]["ping_time"]
        x_old = _as_numeric(time1)
        x_new = _as_numeric(ping_time.values)
        track = {}
        for coord in ("latitude", "longitude"):
            y_old = np.asarray(platform[coord].values, dtype="f8")
            track[coord] = _interp1d(x_old, y_old, x_new, "linear", extrapolate=False)

        from scipy.interpolate import griddata

        env = self.env_params
        points = np.column_stack(
            (np.asarray(env["latitude"].values, "f8"), np.asarray(env["longitude"].values, "f8"))
        )
        xi = np.column_stack((track["latitude"], track["longitude"]))
        out = {}
        for var in env.data_vars:
            interp = griddata(
                points, np.asarray(env[var].values, "f8"), xi, method=self.interp_method
            )
            da = DataArray(interp, ("time1",), name=var)
            da.coords["time1"] = DataArray(np.asarray(ping_time.values), ("time1",), name="time1")
            out[var] = da
        return {var: out[var] for var in _ENV_VARS}

    # ------------------------------------------------------------------
    def _apply_gridded(self, platform, dims) -> Dict[str, DataArray]:
        """Gridded interpolation (stationary / organized, reference
        :136-182): tensor-product 1-D passes per dim, interp_method inside
        the source range, extrap_method outside, on the unique-sorted
        Platform target points."""
        env = self.env_params

        # per-dim: unique-sorted targets (the reference's np.unique/isel
        # passes, :147,153) and the source range split
        targets, inside = {}, {}
        for dim in dims:
            tgt = np.unique(np.asarray(platform[dim].values))
            targets[dim] = tgt
            x_old = _as_numeric(np.asarray(env[dim].values))
            x_new = _as_numeric(tgt)
            inside[dim] = (x_new >= x_old.min()) & (x_new <= x_old.max())

        out = {}
        for var in env.data_vars:
            da = env[var]
            var_dims = tuple(da.dims)
            vals = np.asarray(da.values, dtype="f8")
            for dim in dims:
                if dim not in var_dims:
                    continue
                ax = var_dims.index(dim)
                moved = np.moveaxis(vals, ax, -1)
                flat = moved.reshape(-1, moved.shape[-1])
                x_old = _as_numeric(np.asarray(env[dim].values))
                order = np.argsort(x_old)
                x_new = _as_numeric(targets[dim])
                res = np.empty((flat.shape[0], x_new.size), dtype="f8")
                for i in range(flat.shape[0]):
                    y = flat[i][order]
                    within = _interp1d(x_old[order], y, x_new, self.interp_method, False)
                    if self.extrap_method is not None:
                        outside = _interp1d(
                            x_old[order], y, x_new, self.extrap_method, True
                        )
                        res[i] = np.where(inside[dim], within, outside)
                    else:
                        res[i] = within
                vals = np.moveaxis(
                    res.reshape(moved.shape[:-1] + (x_new.size,)), -1, ax
                )
            out_dims = tuple("time1" if d == dims[0] and d == "time3" else d for d in var_dims)
            oda = DataArray(vals, out_dims, name=var, attrs=dict(da.attrs))
            for d, od in zip(var_dims, out_dims):
                src = targets[d] if d in dims else np.asarray(env[d].values)
                oda.coords[od] = DataArray(src, (od,), name=od)
            out[var] = oda
        return {var: out[var] for var in _ENV_VARS}
