"""Padded-shape computation for raw ping data.

Capability parity: echopype/convert/utils/ek_swap.py:6-93.  The columnar
decoder (convert/simrad/decode.py) emits padded arrays directly, so this is
kept as the reference-named helper surface: given per-channel lists of
ragged ping arrays, compute the rectangular (n_ping, max_sample[, 2]) shape
each data type will occupy.
"""

from __future__ import annotations

import numpy as np

__all__ = ["calc_final_shapes"]


def _max_shape_of(shapes):
    """Elementwise max over shape tuples; None when empty."""
    shapes = [s for s in shapes if s is not None]
    if not shapes:
        return None
    ndim = max(len(s) for s in shapes)
    out = [0] * ndim
    for s in shapes:
        for i, n in enumerate(s):
            out[i] = max(out[i], n)
    return tuple(out)


def _get_datagram_max_shape(datagram_dict):
    """(n_pings, per-dim max) across all channels of one data type."""
    per_channel = []
    for arr_list in datagram_dict.values():
        if not arr_list:
            continue
        m = _max_shape_of([np.asarray(a).shape for a in arr_list if a is not None])
        if m is not None:
            per_channel.append((len(arr_list),) + m)
    return _max_shape_of(per_channel)


def calc_final_shapes(data_types, ping_data_dict):
    """Final rectangular shape per data type (max across channels);
    'angle' gains a trailing 2-axis, absent types map to None."""
    datagram_max_shapes = {}
    for data_type in data_types:
        max_shape = _get_datagram_max_shape(ping_data_dict.get(data_type, {}))
        if max_shape:
            if data_type == "angle":
                max_shape = max_shape[:2]
            datagram_max_shapes[data_type] = max_shape
    data_type_shapes = {}
    for data_type in data_types:
        n_channels = len(ping_data_dict.get(data_type, {}))
        max_shape = datagram_max_shapes.get(data_type, None)
        if n_channels == 0 or max_shape is None:
            data_type_shapes[data_type] = None
        elif data_type == "angle":
            data_type_shapes[data_type] = datagram_max_shapes[data_type] + (2,)
        else:
            data_type_shapes[data_type] = datagram_max_shapes[data_type]
    return data_type_shapes
