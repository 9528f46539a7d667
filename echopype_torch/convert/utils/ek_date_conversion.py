"""NT (FILETIME) <-> unix time conversion.

Capability parity: echopype/convert/utils/ek_date_conversion.py:17-170.
The columnar decoder uses the vectorized ``convert/simrad/framing.py``
equivalents; these scalar functions keep the reference's helper API.
"""

import datetime

UTC = datetime.timezone.utc
UTC_NT_EPOCH = datetime.datetime(1601, 1, 1, 0, 0, 0, tzinfo=UTC)
UTC_UNIX_EPOCH = datetime.datetime(1970, 1, 1, 0, 0, 0, tzinfo=UTC)
EPOCH_DELTA_SECONDS = (UTC_UNIX_EPOCH - UTC_NT_EPOCH).total_seconds()

__all__ = ["nt_to_unix", "unix_to_nt", "unix_to_datetime", "datetime_to_unix"]


def nt_to_unix(nt_timestamp_tuple, return_datetime=True):
    """(lowDateTime, highDateTime) 100ns-ticks-since-1601 -> unix time.

    Integer microsecond arithmetic so unix_to_nt round-trips exactly
    (float 1e-7-tick math loses ~1 us at 2020-era magnitudes).
    """
    low, high = nt_timestamp_tuple
    nt_ticks = (high << 32) + low
    unix_us = nt_ticks // 10 - int(EPOCH_DELTA_SECONDS) * 10**6
    if return_datetime:
        return UTC_UNIX_EPOCH + datetime.timedelta(microseconds=unix_us)
    return unix_us / 1e6


def unix_to_nt(unix_timestamp):
    """Unix time (float or datetime) -> (lowDateTime, highDateTime).

    Integer tick arithmetic: at ~1.3e17 ticks a float64 product exceeds
    2**53 and drifts by ~10 ticks (~1 us), breaking the exact
    nt->unix->nt round-trip that nt_to_unix's integer path provides.
    """
    if isinstance(unix_timestamp, datetime.datetime):
        if unix_timestamp.tzinfo is None:
            unix_timestamp = unix_timestamp.replace(tzinfo=UTC)
        delta = unix_timestamp - UTC_UNIX_EPOCH
        unix_us = (delta.days * 86400 + delta.seconds) * 10**6 + delta.microseconds
    else:
        unix_seconds = float(unix_timestamp)
        whole = int(unix_seconds)
        frac = unix_seconds - whole
        unix_us = whole * 10**6 + int(round(frac * 1e6))
    nt_ticks = (unix_us + int(EPOCH_DELTA_SECONDS) * 10**6) * 10
    return (nt_ticks & 0xFFFFFFFF, nt_ticks >> 32)


def unix_to_datetime(unix_timestamp):
    """Seconds since 1970 (or datetime passthrough) -> aware datetime."""
    if isinstance(unix_timestamp, datetime.datetime):
        if unix_timestamp.tzinfo is None:
            return unix_timestamp.replace(tzinfo=UTC)
        return unix_timestamp
    return datetime.datetime.fromtimestamp(float(unix_timestamp), tz=UTC)


def datetime_to_unix(datetime_obj):
    """Aware (or naive-as-UTC) datetime -> seconds since 1970."""
    if datetime_obj.tzinfo is None:
        datetime_obj = datetime_obj.replace(tzinfo=UTC)
    return datetime_obj.timestamp()
