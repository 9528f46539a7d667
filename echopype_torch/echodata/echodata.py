"""EchoData: the standardized SONAR-netCDF4 group-tree container.

Capability parity: echopype/echodata/echodata.py:43-730.  Internally a flat
{group_path: Dataset} mapping (the "SonarBundle" of SURVEY.md §7) rather than
a DataTree; the on-disk format is the same zarr group tree.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .. import storage
from ..utils.log import _init_logger
from ..xrlite import Dataset
from .convention import GROUP_MAP

logger = _init_logger(__name__)

__all__ = ["EchoData"]

#: EK60 power data recording start offset correction (echodata.py:32)
TVG_CORRECTION_FACTOR = {"EK60": 2, "ES70": 2}


class EchoData:
    """Container for converted sonar data, one Dataset per convention group."""

    group_map = GROUP_MAP

    def __init__(self, tree=None, source_file=None, sonar_model=None, converted_raw_path=None):
        self._tree: dict = dict(tree) if tree else {}
        self.source_file = source_file
        self.sonar_model = sonar_model or self._infer_sonar_model()
        self.converted_raw_path = converted_raw_path

    def _infer_sonar_model(self):
        top = self._tree.get("Top-level")
        if top is not None:
            return top.attrs.get("keywords")
        return None

    # -------------------------------------------------------------- tree API
    def __getitem__(self, group_path: str) -> Dataset:
        if group_path in ("Top-level", "/"):
            group_path = "Top-level"
        if group_path not in self._tree:
            raise KeyError(
                f"Group {group_path!r} not found; available: {sorted(self._tree)}"
            )
        return self._tree[group_path]

    def __setitem__(self, group_path: str, ds: Dataset):
        if not isinstance(ds, Dataset):
            raise TypeError("EchoData groups must be xrlite Datasets")
        self._tree[group_path] = ds

    def __contains__(self, group_path: str):
        return group_path in self._tree

    def get(self, group_path, default=None):
        return self._tree.get(group_path, default)

    @property
    def group_paths(self):
        return tuple(self._tree.keys())

    @property
    def nbytes(self):
        return float(sum(ds.nbytes for ds in self._tree.values()))

    @property
    def version_info(self):
        """(major, minor, patch) of the echopype-family software that wrote
        this tree, from the Provenance attrs (reference echodata.py:283-304);
        None when the store was not written by an echopype-family converter.

        Combination provenance wins over conversion provenance, like the
        reference.  We additionally accept our own software name so stores
        written by this package report a version too.
        """
        prov = self._tree.get("Provenance")
        if prov is None:
            return None

        def _tuple(ptype):
            v = prov.attrs.get(f"{ptype}_software_version")
            if v is None:
                return None
            return tuple(int(i) for i in str(v).lstrip("v").split(".")[:3])

        for ptype in ("combination", "conversion"):
            if prov.attrs.get(f"{ptype}_software_name") in ("echopype", "echopype_tpu"):
                return _tuple(ptype)
        return None

    def __repr__(self):
        lines = [f"<EchoData: standardized raw data from {self.source_file or self.converted_raw_path}>"]
        for path, ds in self._tree.items():
            lines.append(f"  {path}: {dict(ds.sizes)}")
        return "\n".join(lines)

    def _group_description(self, path: str) -> str:
        """Convention description for a group; Beam_group descriptions come
        from the Sonar group's own beam_group_descr (capability parity:
        echodata/widgets/utils.py:_single_node_repr)."""
        from .convention import GROUP_MAP

        name = path.rsplit("/", 1)[-1] if path != "Top-level" else "Top-level"
        if name.startswith("Beam_group"):
            sonar = self._tree.get("Sonar")
            if sonar is not None and "beam_group_descr" in sonar.data_vars:
                try:
                    bg = list(np.asarray(sonar.coords["beam_group"].values))
                    i = bg.index(name)
                    return str(np.asarray(sonar["beam_group_descr"].values)[i])
                except (KeyError, ValueError, IndexError):
                    pass
        for spec in GROUP_MAP.values():
            if spec["name"] == name or (spec.get("ep_group") or "Top-level") == path:
                return spec["description"]
        return ""

    def _repr_html_(self):
        """Jupyter collapsible tree repr: one <details> node per group with
        its convention description, dims, and per-variable rows (capability
        parity: echodata/widgets/widgets.py jinja2 tree; independent
        <details>/<summary> implementation, no static assets)."""
        import html as _html

        src = self.source_file or self.converted_raw_path or "(in memory)"
        parts = [
            "<div style='font-family:monospace'>"
            f"<strong>EchoData: standardized raw data from {_html.escape(str(src))}"
            "</strong>"
        ]
        order = ["Top-level"] + sorted(p for p in self._tree if p != "Top-level")
        for path in order:
            ds = self._tree.get(path)
            if ds is None:
                continue
            dims = ", ".join(f"{k}: {v}" for k, v in ds.sizes.items())
            descr = _html.escape(self._group_description(path))
            head = (
                f"<b>{_html.escape(path)}</b>"
                + (f": <i>{descr}</i>" if descr else "")
                + (f" <span style='color:#888'>({dims})</span>" if dims else "")
            )
            rows = []
            for section, items in (("Coordinates", ds.coords),
                                   ("Data variables", ds.data_vars)):
                if not len(items):
                    continue
                rows.append(
                    f"<div style='margin-left:1em;color:#555'>{section}:</div>"
                )
                for vname, da in items.items():
                    vdims = ", ".join(str(d) for d in da.dims)
                    dt = getattr(getattr(da, "values", None), "dtype", "")
                    long_name = _html.escape(str(da.attrs.get("long_name", "")))
                    rows.append(
                        "<div style='margin-left:2em'>"
                        f"<b>{_html.escape(str(vname))}</b>"
                        f" <span style='color:#888'>({vdims}) {dt}</span>"
                        + (f" — {long_name}" if long_name else "")
                        + "</div>"
                    )
            if ds.attrs:
                rows.append(
                    "<div style='margin-left:1em;color:#555'>Attributes: "
                    f"{len(ds.attrs)}</div>"
                )
            parts.append(
                f"<details><summary>{head}</summary>{''.join(rows)}</details>"
            )
        parts.append("</div>")
        return "".join(parts)

    # ----------------------------------------------------------------- io
    def to_zarr(self, save_path, overwrite=False, compress=True, storage_options=None,
                zarr_format: int = 2, shard_spec=None, **kw):
        """Serialize the group tree to a zarr store (local path or fsspec URL).

        ``zarr_format=3`` writes the Zarr v3 on-disk layout the real echopype
        (zarr>=3, reference requirements.txt:20) produces; both formats are
        read back transparently by ``open_converted``/``from_file``.

        ``shard_spec`` (v3 only): per-dim shard sizes, e.g.
        ``{"ping_time": 512}`` — arrays with those dims are written as
        ``sharding_indexed`` shards of inner chunks (zarr-python 3's
        ``shards=`` layout), cutting file count on object stores.
        """
        storage.write_tree(
            save_path, self._tree, compress=compress, overwrite=overwrite,
            storage_options=storage_options,
            chunk_spec=getattr(self, "_chunk_spec", None),
            zarr_format=zarr_format, shard_spec=shard_spec,
        )
        self.converted_raw_path = str(save_path)
        return str(save_path)

    def to_netcdf(self, save_path, overwrite=False, compress=True, storage_options=None, **kw):
        """Serialize the group tree as one netCDF4 (HDF5) file.

        Reference parity: echodata/echodata.py:586 ``to_netcdf`` via the
        netcdf4 xarray engine; here written directly as the netCDF4-on-HDF5
        profile (dimension scales + DIMENSION_LIST) through h5py.
        """
        storage.write_netcdf_tree(
            save_path, self._tree, compress=compress, overwrite=overwrite,
            storage_options=storage_options,
        )
        self.converted_raw_path = str(save_path)
        return str(save_path)

    @classmethod
    def from_file(cls, converted_raw_path, storage_options=None, **kw) -> "EchoData":
        from ..utils.io import is_remote_path, source_exists

        path = converted_raw_path if is_remote_path(converted_raw_path) else Path(converted_raw_path)
        if not source_exists(path, storage_options):
            raise FileNotFoundError(str(path))
        suffix = "." + str(path).rsplit(".", 1)[-1] if "." in str(path) else ""
        if suffix in (".nc", ".netcdf4", ".h5") and (
            is_remote_path(path) or Path(path).is_file()
        ):
            tree = storage.open_netcdf_tree(path, storage_options=storage_options)
        else:
            tree = storage.open_zarr_tree(path, storage_options=storage_options)
        cls._migrate_legacy_names(tree)
        ed = cls(tree=tree, converted_raw_path=str(path))
        prov = tree.get("Provenance")
        if prov is not None:
            ed.source_file = prov.attrs.get("source_file")
        return ed

    @staticmethod
    def _migrate_legacy_names(tree: dict) -> None:
        """Rename pre-DataTree-era coordinates in older echopype stores
        (reference from_file legacy checks, echodata/echodata.py:170-243):
        Sonar ``channel`` -> ``channel_all``, Kongsberg Platform/NMEA
        ``time1`` -> ``nmea_time``."""
        top = tree.get("Top-level")
        keywords = str(top.attrs.get("keywords", "")) if top is not None else ""
        is_kongsberg = any(
            m in keywords for m in ("EK60", "ES70", "EK80", "ES80", "EA640")
        )
        sonar = tree.get("Sonar")
        if sonar is not None and "channel" in sonar.coords and "channel_all" not in sonar.coords:
            tree["Sonar"] = sonar.rename({"channel": "channel_all"})
        nmea = tree.get("Platform/NMEA")
        if (
            is_kongsberg
            and nmea is not None
            and "time1" in nmea.coords
            and "nmea_time" not in nmea.coords
        ):
            tree["Platform/NMEA"] = nmea.rename({"time1": "nmea_time"})

    def chunk(self, chunk_dict=None):
        """Record a per-dimension chunking request for serialization.

        Arrays stay eager host arrays (device sharding handles compute
        scale), but the requested chunking is honored by to_zarr's
        encodings — the role the reference's rechunk-all-groups plays
        (echodata.py:697-730).
        """
        if chunk_dict:
            spec = dict(getattr(self, "_chunk_spec", None) or {})
            spec.update(chunk_dict)
            self._chunk_spec = spec
        return self

    def cleanup_swap_files(self):
        """Delete memmap swap files created by open_raw(use_swap=...)
        (echodata.py:77-104)."""
        swap_dir = getattr(self, "swap_dir", None)
        if swap_dir is None:
            return
        import shutil

        # drop memmap references so the files can be unlinked on all platforms
        for ds in self._tree.values():
            for da in ds.data_vars.values():
                if isinstance(da.values, np.memmap):
                    da.values = np.asarray(da.values).copy()
        shutil.rmtree(swap_dir, ignore_errors=True)
        self.swap_dir = None
        self.swap_files = []

    def __del__(self):
        try:
            if getattr(self, "swap_dir", None) is not None:
                import shutil

                shutil.rmtree(self.swap_dir, ignore_errors=True)
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    # ------------------------------------------------------------- platform
    def update_platform(
        self, extra_platform_data, variable_mappings=None, extra_platform_data_file_name=None
    ):
        """Merge external platform data (e.g. ship GPS) into the Platform group.

        Capability parity: echodata.py:349-517 — CF trajectory inputs are
        unrolled onto their time coordinate; only mappings whose Platform
        variable pre-exists AND whose external variable carries valid data
        are applied; new variables arrive on fresh timeN dims clipped to one
        sample beyond the data time range; scalar lat/lon land on the first
        ping time; pre-existing time dims left without variables are
        dropped.
        """
        if variable_mappings is None:
            raise ValueError("variable_mappings is required")

        # CF Trajectory Discrete Sampling Geometry (e.g. Saildrone files):
        # select the first trajectory and swap the obs dim for time
        if (
            str(extra_platform_data.attrs.get("featureType", "")).lower()
            == "trajectory"
        ):
            trajectory_var = time_dim = None
            for coordvar in list(extra_platform_data.coords):
                cattrs = extra_platform_data.coords[coordvar].attrs
                if cattrs.get("cf_role") == "trajectory_id":
                    trajectory_var = coordvar
                if cattrs.get("standard_name") == "time":
                    time_dim = coordvar
            if trajectory_var is not None and time_dim is not None:
                # first trajectory only (reference selects coords[var][0])
                if trajectory_var in extra_platform_data.sizes:
                    extra_platform_data = extra_platform_data.isel(
                        {trajectory_var: 0}, drop=True
                    )
                extra_platform_data = extra_platform_data.drop_vars(
                    [trajectory_var], errors="ignore"
                )
                obs_dim = extra_platform_data[time_dim].dims[0]
                extra_platform_data = extra_platform_data.swap_dims({obs_dim: time_dim})

        platform = self._tree["Platform"]

        # reference filtering (utils_platform.get_mappings_expanded): the
        # Platform variable must pre-exist and the external data be valid
        mappings_expanded = {}
        for plat_name, ext_name in variable_mappings.items():
            if plat_name not in platform:
                continue
            if ext_name not in extra_platform_data:
                continue
            ext = extra_platform_data[ext_name]
            if ext.dtype.kind in "fi" and np.isnan(
                np.asarray(ext.values, dtype="f8")
            ).all():
                continue
            time_dim = ext.dims[0] if ext.dims else "scalar"
            mappings_expanded[plat_name] = dict(
                external_var=ext_name, ext_time_dim_name=time_dim
            )
        if not mappings_expanded:
            logger.warning(
                "No variables will be updated, check variable_mappings to "
                "ensure variable names are correctly specified!"
            )
        for lat_name, lon_name in (
            ("latitude", "longitude"),
            ("latitude_idx", "longitude_idx"),
            ("latitude_mru1", "longitude_mru1"),
        ):
            if lat_name in mappings_expanded or lon_name in mappings_expanded:
                if lat_name not in mappings_expanded or lon_name not in mappings_expanded:
                    raise ValueError(
                        f"Only one of {lat_name} and {lon_name} are specified. "
                        "Please include both, or neither."
                    )
                if (
                    mappings_expanded[lat_name]["ext_time_dim_name"]
                    != mappings_expanded[lon_name]["ext_time_dim_name"]
                ):
                    raise ValueError(
                        "The external latitude and longitude use different time "
                        "dimensions. They must share the same time dimension."
                    )
        dropped = set(variable_mappings) - set(mappings_expanded)
        if dropped:
            logger.warning(
                f"The following requested variables will not be updated: "
                f"{', '.join(sorted(dropped))}"
            )

        # next free timeN index
        existing = [d for d in platform.sizes if d.startswith("time")]
        next_idx = max([int(d[4:]) for d in existing if d[4:].isdigit()], default=0) + 1

        beam = self._tree.get("Sonar/Beam_group1")
        tmin, tmax = None, None
        if beam is not None and "ping_time" in beam.coords:
            pt = beam.coords["ping_time"].values
            if len(pt):
                tmin, tmax = pt.min(), pt.max()

        time_dim_for = {}
        for plat_name, info in mappings_expanded.items():
            ext = extra_platform_data[info["external_var"]]
            src_time = info["ext_time_dim_name"]
            old_attrs = dict(platform[plat_name].attrs) if plat_name in platform else {}
            if src_time == "scalar":
                if plat_name.startswith(("latitude", "longitude")) and platform[
                    plat_name
                ].dims:
                    # scalar lat/lon writes into the existing 1-element
                    # placeholder variable (echodata.py:494-505).  The
                    # reference also re-stamps the time coordinate with the
                    # first ping time, but that assignment is silently
                    # dropped by dataset-assignment alignment — the
                    # executable oracle keeps the original (NaT) stamp, and
                    # so do we.
                    dim = platform[plat_name].dims[0]
                    platform[plat_name] = (
                        (dim,),
                        np.full(
                            platform.sizes[dim], float(np.asarray(ext.values))
                        ),
                        old_attrs,
                    )
                else:
                    platform[plat_name] = ((), np.asarray(ext.values).reshape(()), old_attrs)
                continue
            if src_time not in time_dim_for:
                time_dim_for[src_time] = f"time{next_idx}"
                next_idx += 1
            new_dim = time_dim_for[src_time]
            tvals = ext.coords[src_time].values
            vals = ext.values
            if tmin is not None and len(tvals):
                # clip to data time range, keeping one sample beyond each
                # edge (utils_platform._clip_by_time_dim)
                keep = (tvals >= tmin) & (tvals <= tmax)
                lo = np.searchsorted(tvals, tmin)
                hi = np.searchsorted(tvals, tmax, side="right")
                keep[max(lo - 1, 0)] = True
                keep[min(hi, len(tvals) - 1)] = True
                tvals = tvals[keep]
                vals = vals[keep]
            platform._set_coord(new_dim, (new_dim, tvals))
            platform[plat_name] = ((new_dim,), vals, old_attrs)

        # drop pre-existing time dims no longer used by any data variable
        # (echodata.py:509-515)
        used_dims = {
            d for var in platform.data_vars.values() for d in var.dims
        }
        unused = [
            d for d in list(platform.sizes)
            if d.startswith("time") and d not in used_dims
        ]
        if unused:
            self._tree["Platform"] = platform = platform.drop_dims(unused, errors="ignore")
        # re-stamp L1A once valid location data exists (echodata.py:348)
        from ..utils.prov import PROCESSING_LEVELS, _valid_latlon

        if _valid_latlon(platform):
            top = self._tree.get("Top-level")
            if top is not None:
                top.attrs["processing_level"] = PROCESSING_LEVELS["L1A"]
                top.attrs["processing_level_url"] = (
                    "https://echopype.readthedocs.io/en/stable/processing-levels.html"
                )
        return self
