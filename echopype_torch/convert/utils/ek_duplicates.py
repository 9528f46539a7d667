"""Duplicate-ping payload check.

Capability parity: echopype/convert/utils/ek_duplicates.py — warn when
datagrams sharing a ping_time carry non-identical data (the set_groups
pipeline then keeps the first and drops the rest).
"""

import numpy as np


def check_unique_ping_time_duplicates(ds_data, logger) -> None:
    """Warn if duplicate-ping_time slices differ in any data variable."""
    pt = np.asarray(ds_data.coords["ping_time"].values)
    order = np.argsort(pt, kind="stable")
    pt_sorted = pt[order]
    uniq, starts, counts = np.unique(pt_sorted, return_index=True, return_counts=True)
    for u, s, c in zip(uniq, starts, counts):
        if c < 2:
            continue
        idx = order[s : s + c]
        # warn once per differing VARIABLE (reference warns per variable and
        # keeps scanning the rest, so the operator sees the full list)
        for var in ds_data.data_vars:
            da = ds_data[var]
            if "ping_time" not in da.dims:
                continue
            ref = da.isel(ping_time=int(idx[0]))
            for j in idx[1:]:
                other = da.isel(ping_time=int(j))
                same = np.array_equal(
                    np.asarray(ref.values), np.asarray(other.values)
                ) or (
                    np.issubdtype(np.asarray(ref.values).dtype, np.floating)
                    and np.array_equal(
                        np.asarray(ref.values), np.asarray(other.values), equal_nan=True
                    )
                )
                if not same:
                    logger.warning(
                        f"Duplicate slices in variable '{var}' corresponding to "
                        f"'ping_time' {u} differ in data. All duplicate "
                        "'ping_time' entries will be removed, which will result "
                        "in data loss."
                    )
                    break
