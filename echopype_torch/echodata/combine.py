"""combine_echodata: concatenate converted files along their append dims.

Capability parity: echopype/echodata/combine.py:860 — per-group concat along
the append dims {filenames, time1..4, nmea_time, ping_time, filter_time} with
minimal coords; channel consistency/selection checks (list or per-beam-group
dict, combine.py:226,298); ascending-first-time check (:458); Vendor_specific
identity check (:511); every group's attributes captured into a per-file
Provenance attribute table (:605); re-combining already-combined stores
(:731-750).  Reversed-time repair is NOT done here (matching the reference);
use qc.orchestrate_reverse_time_check / qc.coerce_increasing_time.

The table is built with plain numpy (no pandas): one variable per attribute
name on an ``echodata_filename`` dim, stamped with an ``echodata_group``
variable attribute identifying the source group — the layout the reference
produces via DataFrame.to_xarray + xr.merge.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils.log import _init_logger
from ..utils.prov import echopype_prov_attrs
from ..xrlite import DataArray, Dataset
from .echodata import EchoData

logger = _init_logger(__name__)

POSSIBLE_TIME_DIMS = {
    "time1",
    "time2",
    "time3",
    "time4",
    "nmea_time",
    "ping_time",
    "filter_time",
}
APPEND_DIMS = {"filenames"}.union(POSSIBLE_TIME_DIMS)
ED_GROUP = "echodata_group"
ED_FILENAME = "echodata_filename"
FILENAMES = "filenames"

__all__ = ["combine_echodata", "APPEND_DIMS", "POSSIBLE_TIME_DIMS"]


def check_eds(echodata_list):
    """Validate the input list; return (sonar_model, per-file basenames)
    (reference: combine.py:156-224)."""
    if not isinstance(echodata_list, list) or not all(
        isinstance(ed, EchoData) for ed in echodata_list
    ):
        raise TypeError("The input, eds, must be a list of EchoData objects!")
    if not echodata_list:
        raise TypeError("The input, eds, must be a non-empty list of EchoData objects!")
    sonar_model = echodata_list[0].sonar_model
    if sonar_model is None:
        raise ValueError("all EchoData objects must have non-None sonar_model values")
    echodata_filenames = []
    for ed in echodata_list:
        if ed.sonar_model is None:
            raise ValueError("all EchoData objects must have non-None sonar_model values")
        if ed.sonar_model != sonar_model:
            raise ValueError("all EchoData objects must have the same sonar_model value")
        filepath = ed.source_file or ed.converted_raw_path
        filename = "internal-memory" if filepath is None else Path(str(filepath)).name
        if filepath is not None and filename in echodata_filenames:
            raise ValueError("EchoData objects have conflicting filenames")
        echodata_filenames.append(filename)
    return sonar_model, echodata_filenames


def _check_channel_selection_form(channel_selection=None):
    """channel_selection must be None, a list of str, or a dict whose keys
    are beam-group paths and values lists of str (reference: combine.py:102)."""
    if channel_selection is None:
        return
    if isinstance(channel_selection, list):
        if not all(isinstance(c, str) for c in channel_selection):
            raise TypeError("Each element of channel_selection must be a string!")
    elif isinstance(channel_selection, dict):
        for key, val in channel_selection.items():
            if not (isinstance(key, str) and key.startswith("Sonar/Beam_group")):
                raise TypeError(
                    "Each key of channel_selection can only be a beam group path of "
                    "the form Sonar/Beam_group!"
                )
            if not isinstance(val, list) or not all(isinstance(c, str) for c in val):
                raise TypeError("Each value of channel_selection must be a list of strings!")
    else:
        raise TypeError("channel_selection must be a list or a dict!")


def _create_channel_selection_dict(sonar_model, has_chan_dim, user_channel_selection=None):
    """Per-group channel selection (reference: combine.py:298-380): a list
    applies everywhere; a per-beam-group dict applies as-is on EK80-like
    beam groups while Sonar/Platform/Vendor_specific get the union."""
    if user_channel_selection is None:
        return {grp: None for grp in has_chan_dim}
    if isinstance(user_channel_selection, list):
        union = list(user_channel_selection)
    else:
        union = sorted(set().union(*user_channel_selection.values()))
    out = {}
    for grp, has_chan in has_chan_dim.items():
        if not has_chan:
            out[grp] = None
        elif (
            not isinstance(user_channel_selection, list)
            and sonar_model in ("EK80", "ES80", "EA640")
            and grp not in ("Sonar", "Platform", "Vendor_specific")
        ):
            out[grp] = sorted(user_channel_selection[grp])
        else:
            out[grp] = sorted(union)
    return out


def _check_channel_consistency(all_chan_list, ed_group, channel_selection=None):
    """reference: combine.py:226-296."""
    if channel_selection is None:
        sorted_lists = [sorted(c) for c in all_chan_list]
        if sorted_lists.count(sorted_lists[0]) != len(sorted_lists):
            unique_channels = sorted(set().union(*map(set, all_chan_list)))
            raise RuntimeError(
                f"For the EchoData group {ed_group} the channels: {unique_channels} are "
                f"not found in all EchoData objects being combined. Select which "
                f"channels should be included in the combination using the keyword "
                f"argument channel_selection in combine_echodata."
            )
    else:
        wanted = set(channel_selection)
        if not all(wanted <= set(chans) for chans in all_chan_list):
            raise NotImplementedError(
                f"For the EchoData group {ed_group}, some EchoData objects do "
                f"not contain the selected channels. This type of combine is "
                f"not currently implemented."
            )


def _check_echodata_channels(echodata_list, user_channel_selection=None):
    """reference: combine.py:383-458."""
    first = echodata_list[0]
    has_chan_dim = {grp: "channel" in first[grp].dims for grp in first.group_paths}
    channel_selection = _create_channel_selection_dict(
        first.sonar_model, has_chan_dim, user_channel_selection
    )
    for ed_group in first.group_paths:
        if "channel" in first[ed_group].dims:
            # tolerate inputs lacking this group (the reference's EchoData
            # returns None there and its combine crashes on it; our _combine
            # deliberately supports differing-group inputs, so the check
            # covers only the eds that carry the group)
            pairs = [
                (ed, list(ds.coords["channel"].values))
                for ed, ds in ((ed, ed.get(ed_group)) for ed in echodata_list)
                if ds is not None
            ]
            all_chan_list = [chans for _, chans in pairs]
            for ed, chans in pairs:
                if len(set(chans)) != len(chans):
                    src = ed["Provenance"]["source_filenames"].values
                    raise RuntimeError(
                        f"The EchoData objects produced by the following files "
                        f"have a channel dimension with repeating values, "
                        f"combine cannot be used: {list(np.atleast_1d(src))}"
                    )
            _check_channel_consistency(all_chan_list, ed_group, channel_selection[ed_group])
    return channel_selection


def _check_ascending_ds_times(ds_list, ed_group):
    """First time value of each dataset must not descend (reference:
    combine.py:458-508; within-file reversals pass through to qc)."""
    time_dims = set(ds_list[0].dims).intersection(POSSIBLE_TIME_DIMS)
    for time in time_dims:
        firsts = []
        for ds in ds_list:
            vals = np.atleast_1d(ds[time].values)
            firsts.append(vals[0] if len(vals) else np.datetime64("NaT"))
        firsts = np.array(firsts)
        if np.isnan(firsts).all():
            continue
        if (np.diff(firsts) < np.timedelta64(0, "ns")).any():
            raise RuntimeError(
                f"The coordinate {time} is not in ascending order for "
                f"group {ed_group}, combine cannot be used!"
            )


def _check_no_append_vendor_params(ds_list, ds_append_dims):
    """Non-appending Vendor_specific content must be identical across files
    (reference: combine.py:511-557)."""
    stripped = [
        ds.drop_dims(list(ds_append_dims)) if ds_append_dims else ds for ds in ds_list
    ]
    first = stripped[0]
    for other in stripped[1:]:
        if not first.identical(other):
            raise RuntimeError(
                "Non identical filter parameters in Vendor_specific group. "
                "Objects cannot be merged!"
            )
        first = other


def _merge_attributes(attributes):
    """First non-empty value per key wins (reference: combine.py:560-602)."""
    merged = {}
    for attribute in attributes:
        for key, value in attribute.items():
            if key not in merged or merged[key] == "":
                merged[key] = value
    return merged


def _capture_prov_attrs(attrs_dict, echodata_filenames):
    """Per-file attribute table (reference: combine.py:605-645): one variable
    per attribute name on the ``echodata_filename`` dim, var attr
    ``echodata_group`` naming the source group, missing entries "" and all
    values stringified."""
    n = len(echodata_filenames)
    ds = Dataset()
    ds.coords[ED_FILENAME] = DataArray(
        np.array([str(f) for f in echodata_filenames], dtype=object),
        (ED_FILENAME,),
        name=ED_FILENAME,
    )
    for group, attributes in attrs_dict.items():
        keys = list(dict.fromkeys(k for attrs in attributes for k in attrs))
        for key in keys:
            if key in ds.data_vars:
                continue  # first group wins on a name collision (xr.merge)
            col = np.array(
                [
                    ""
                    if (key not in attributes[i] or _is_missing(attributes[i][key]))
                    else str(attributes[i][key])
                    for i in range(n)
                ],
                dtype=object,
            )
            ds.data_vars[key] = DataArray(
                col, (ED_FILENAME,), attrs={ED_GROUP: group}, name=key
            )
    return ds


def _is_missing(v):
    return v is None or (isinstance(v, float) and np.isnan(v))


def _get_prov_attrs(ds, is_combined=True):
    """Invert _capture_prov_attrs when re-combining an already-combined store
    (reference: combine.py:648-688)."""
    if not is_combined:
        return None
    attrs_dict = {}
    for name, var in ds.data_vars.items():
        group = var.attrs.get(ED_GROUP)
        if group is None:
            continue
        vals = np.atleast_1d(var.values)
        attrs_dict.setdefault(group, [])
        for i, v in enumerate(vals):
            while len(attrs_dict[group]) <= i:
                attrs_dict[group].append({})
            attrs_dict[group][i][name] = v
    return attrs_dict


def _concat_append_dims(ds_list, ds_append_dims):
    """Per append dim: concat the variables carrying it; everything else from
    the first dataset (the reference's per-dim xr.concat(coords="minimal",
    data_vars="minimal") + assign loop, combine.py:804-823)."""
    first = ds_list[0]
    out = Dataset()
    for k, coord in first.coords.items():
        cdims = [d for d in ds_append_dims if d in coord.dims]
        if cdims:
            ax = coord.dims.index(cdims[0])
            vals = np.concatenate(
                [np.asarray(ds.coords[k].values) for ds in ds_list if k in ds.coords],
                axis=ax,
            )
            out.coords[k] = DataArray(vals, coord.dims, attrs=coord.attrs, name=k)
        else:
            out.coords[k] = coord
    # union of data_vars in first-seen order: a variable present in only
    # some files still combines, with NaN fill for the files lacking it
    # (xarray concat's fill_value semantics — e.g. angle vars when one file
    # recorded power-only pings)
    names = list(first.data_vars)
    for ds in ds_list[1:]:
        for name in ds.data_vars:
            if name not in names:
                names.append(name)
    for name in names:
        havers = [ds for ds in ds_list if name in ds.data_vars]
        var = havers[0][name]
        vdims = [d for d in ds_append_dims if d in var.dims]
        if vdims:
            ax = var.dims.index(vdims[0])
            pieces = []
            filled = False
            for ds in ds_list:
                if name in ds.data_vars:
                    pieces.append(np.asarray(ds.data_vars[name].values))
                else:
                    shape = tuple(
                        ds.sizes.get(d, var.sizes[d]) for d in var.dims
                    )
                    dt = var.values.dtype
                    if dt.kind in "mM":
                        pieces.append(np.full(shape, np.array("NaT", dtype=dt), dtype=dt))
                    else:
                        pieces.append(
                            np.full(shape, np.nan, dtype=dt if dt.kind in "fc" else "f8")
                        )
                    filled = True
            if filled and var.values.dtype.kind in "iub":
                pieces = [p.astype("f8") for p in pieces]  # xarray promotes
            # pad non-concat axes (e.g. range_sample) to the widest file
            tgt = [max(p.shape[i] for p in pieces) for i in range(pieces[0].ndim)]
            padded = []
            for p in pieces:
                pad = [
                    (0, tgt[i] - p.shape[i]) if i != ax else (0, 0) for i in range(p.ndim)
                ]
                if any(hi for _, hi in pad):
                    fillv = np.nan if p.dtype.kind in "fc" else 0
                    p = np.pad(p, pad, constant_values=fillv)
                padded.append(p)
            vals = np.concatenate(padded, axis=ax)
            out.data_vars[name] = DataArray(vals, var.dims, attrs=var.attrs, name=name)
        else:
            out.data_vars[name] = var
    # widen range_sample-like coords if padding grew them
    for k, coord in list(out.coords.items()):
        n_used = None
        for var in out.data_vars.values():
            if k in var.dims and k not in ds_append_dims:
                n_used = max(n_used or 0, var.sizes[k])
        if n_used is not None and coord.ndim == 1 and len(coord.values) < n_used:
            if np.issubdtype(coord.dtype, np.integer):
                out.coords[k] = DataArray(np.arange(n_used), (k,), attrs=coord.attrs, name=k)
    return out


def _combine(sonar_model, eds, echodata_filenames, ed_group_chan_sel):
    """Combine per group; returns {group_path: Dataset}
    (reference: combine.py:691-857)."""
    all_group_paths = list(dict.fromkeys(g for ed in eds for g in ed.group_paths))
    attrs_dict = {}

    # re-combine support: pull true per-file attr tables out of combined inputs
    combined_mapping = []
    for idx, ed in enumerate(eds):
        prov = ed["Provenance"]
        is_combined = bool(prov.attrs.get("is_combined", False))
        combined_mapping.append(
            {
                "is_combined": is_combined,
                "attrs_dict": _get_prov_attrs(prov, is_combined),
                ED_FILENAME: (
                    [str(s) for s in np.atleast_1d(prov[ED_FILENAME].values)]
                    if is_combined
                    else [echodata_filenames[idx]]
                ),
            }
        )
    any_combined = any(d["is_combined"] for d in combined_mapping)
    if any_combined:
        echodata_filenames = [f for d in combined_mapping for f in d[ED_FILENAME]]

    tree_dict = {}
    for ed_group in all_group_paths:
        # attr-table rows stay aligned with echodata_filenames: one row per
        # INPUT (empty when the input lacks the group), while only the
        # present datasets concatenate
        per_ed = [ed.get(ed_group) for ed in eds]
        ds_list = [ds for ds in per_ed if ds is not None]
        if not ds_list:
            continue
        sel = ed_group_chan_sel.get(ed_group)
        if sel is not None:
            ds_list = [ds.sel(channel=sel) for ds in ds_list]

        if not any_combined:
            ds_attrs = [dict(ds.attrs) if ds is not None else {} for ds in per_ed]
        else:
            ds_attrs = []
            for idx, ds in enumerate(per_ed):
                ed_attrs_dict = combined_mapping[idx]["attrs_dict"]
                if ed_attrs_dict is not None:
                    rows = ed_attrs_dict.get(ed_group)
                    if rows is None:
                        rows = [{}] * len(combined_mapping[idx][ED_FILENAME])
                    ds_attrs += rows
                else:
                    ds_attrs += [dict(ds.attrs) if ds is not None else {}]
        attrs_dict[ed_group] = ds_attrs

        _check_ascending_ds_times(ds_list, ed_group)
        ds_append_dims = set(ds_list[0].dims).intersection(APPEND_DIMS)
        if ed_group == "Vendor_specific":
            _check_no_append_vendor_params(ds_list, ds_append_dims)

        if not ds_append_dims:
            # shallow copy: variables shared, but attrs live on the copy so
            # the merged-attr assignment below cannot mutate the input
            # EchoData (the reference's to_dataset() view isolates the same
            # way)
            combined_ds = ds_list[0].copy()
        else:
            combined_ds = _concat_append_dims(ds_list, ds_append_dims)

        group_attrs = _merge_attributes(ds_attrs)
        combined_ds.attrs = group_attrs
        if ed_group == "Provenance":
            combined_ds.attrs.update(
                {
                    "is_combined": True,
                    "conversion_software_name": group_attrs.get(
                        "conversion_software_name", ""
                    ),
                    "conversion_software_version": group_attrs.get(
                        "conversion_software_version", ""
                    ),
                    "conversion_time": group_attrs.get("conversion_time", ""),
                }
            )
            combined_ds.attrs.update(echopype_prov_attrs(process_type="combination"))
        tree_dict[ed_group] = combined_ds

    prov_table = _capture_prov_attrs(attrs_dict, echodata_filenames)
    prov_ds = tree_dict["Provenance"]
    if any_combined and ED_FILENAME in prov_ds.dims:
        prov_ds = prov_ds.drop_dims([ED_FILENAME])
    for k, v in prov_table.coords.items():
        prov_ds.coords[k] = v
    for k, v in prov_table.data_vars.items():
        prov_ds.data_vars[k] = v
    # filenames coord becomes a plain running index (reference: combine.py:852)
    if FILENAMES in prov_ds.coords:
        n = len(prov_ds.coords[FILENAMES].values)
        attrs = prov_ds.coords[FILENAMES].attrs
        prov_ds.coords[FILENAMES] = DataArray(
            np.arange(n), (FILENAMES,), attrs=attrs, name=FILENAMES
        )
    tree_dict["Provenance"] = prov_ds
    return tree_dict


def combine_echodata(echodata_list=None, channel_selection=None) -> EchoData:
    """Combine multiple EchoData objects into one (reference: combine.py:860)."""
    if echodata_list is None:
        import warnings

        warnings.warn("No EchoData objects were provided, returning an empty EchoData object.")
        return EchoData()

    sonar_model, echodata_filenames = check_eds(echodata_list)
    _check_channel_selection_form(channel_selection)
    ed_group_chan_sel = _check_echodata_channels(echodata_list, channel_selection)
    tree_dict = _combine(sonar_model, echodata_list, echodata_filenames, ed_group_chan_sel)

    out = EchoData(
        tree=tree_dict,
        source_file=echodata_list[0].source_file,
        sonar_model=sonar_model,
    )
    return out


def check_zarr_path(zarr_path, storage_options: dict = None, overwrite: bool = False) -> str:
    """Validate a combine output zarr path (reference: combine.py check_zarr_path)."""
    from ..utils.io import validate_output_path

    if zarr_path is not None:
        if not isinstance(zarr_path, (str, Path)):
            raise TypeError(
                "The provided zarr_path input must be of type string or pathlib.Path!"
            )
        if Path(str(zarr_path)).suffix != ".zarr":
            raise ValueError("The provided zarr_path input must have a '.zarr' suffix!")
    return validate_output_path(
        source_file="combined_echodata.zarr",
        engine="zarr",
        output_storage_options=storage_options or {},
        save_path=zarr_path,
    )
