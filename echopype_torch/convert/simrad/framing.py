"""Simrad .raw datagram framing: one scan pass -> columnar index.

Format (behavioral contract from echopype/convert/utils/ek_raw_io.py:133-234):
every datagram is framed as::

    int32 size | char[4] type | uint32 low_date | uint32 high_date | payload | int32 size

Timestamps are 64-bit counts of 100ns ticks since the NT epoch (1601-01-01),
split little-end-first (ek_date_conversion.py:26-55).

TPU-native redesign: instead of a per-datagram Python object loop, the file is
read (or mmapped) once and a single cheap scan builds a **columnar index**
(numpy arrays of offsets/sizes/types/timestamps).  All subsequent decoding is
vectorized gathers over that index — the decode cost scales with numpy
bandwidth, not Python interpreter throughput, and the output lands directly in
padded device-ready arrays.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

# seconds between 1601-01-01 and 1970-01-01
_NT_UNIX_DELTA_S = 11644473600

__all__ = ["scan_datagrams", "DatagramIndex", "nt_to_datetime64", "CorruptDatagramError"]


class CorruptDatagramError(ValueError):
    pass


def nt_to_datetime64(low: np.ndarray, high: np.ndarray) -> np.ndarray:
    """Vectorized NT (100ns since 1601) -> numpy datetime64[ns].

    Reproduces the reference's conversion BIT-EXACTLY: nt_to_unix computes
    ``ticks * 1.0e-7`` in float64 then builds a datetime via
    ``timedelta(seconds=...)`` (ek_date_conversion.py:50-53), which (a)
    quantizes to whole microseconds and (b) carries the float64 rounding of
    that multiply — up to ~2 us at 2020-era dates (f64 ulp at 1.3e10 s is
    3.8e-6 s).  Sub-us tick digits must quantize identically or ping/sidecar
    times drift from the reference's (found by the sidecars soak on fuzzed
    timestamp bytes; the f64 wobble inside the us digit was found by the
    ek80sg platform leg on MRU datagrams at +100 ms offsets)."""
    ticks = (np.asarray(high, dtype="u8") << np.uint64(32)) + np.asarray(low, dtype="u8")
    return _ticks_to_datetime64(ticks)


def _ticks_to_datetime64(ticks: np.ndarray) -> np.ndarray:
    """NT ticks (u8/i8 100ns units) -> datetime64[ns] via the reference's
    lossy float64 seconds path (see nt_to_datetime64).  Validated exact
    against ek_date_conversion.nt_to_unix on 4000 random 1990-2040 ticks."""
    sec = ticks.astype("f8") * 1.0e-7  # the reference's f64 multiply
    isec = np.floor(sec)
    # exact: the f64 fractional part carries <= ~18 significant bits here
    frac = sec - isec
    # timedelta(seconds=...) rounds the leftover to nearest us (ties even)
    us = (isec.astype("i8") - np.int64(_NT_UNIX_DELTA_S)) * np.int64(1_000_000)
    us += np.rint(frac * 1e6).astype("i8")
    return (us * np.int64(1000)).astype("datetime64[ns]")


@dataclass
class DatagramIndex:
    """Columnar index over all datagrams in a buffer.

    ``body_offset`` points at the 4-char type (start of the datagram body, the
    region covered by ``size``); payload-specific fields live at
    ``body_offset + 12``.
    """

    buf: bytes
    body_offset: np.ndarray  # int64 [n]
    size: np.ndarray  # int32 [n] (body size incl. 12-byte type+date header)
    dgram_type: np.ndarray  # 'U4' [n], e.g. "RAW0"
    timestamp: np.ndarray  # datetime64[ns] [n]

    def __len__(self):
        return len(self.body_offset)

    def select(self, dgram_type: str):
        """Row indices of a given datagram type, in file order."""
        return np.nonzero(self.dgram_type == dgram_type)[0]

    def type_starts_with(self, prefix: str):
        return np.nonzero(np.char.startswith(self.dgram_type, prefix))[0]


def scan_datagrams(buf: bytes, resync: bool = True, use_native: bool = True) -> DatagramIndex:
    """One pass over ``buf``, returning the columnar datagram index.

    On a framing mismatch (leading size != trailing size) the scanner resyncs
    by searching for the next plausible datagram header, mirroring the
    reference's bad-byte recovery (ek_raw_io.py:473-486).

    Uses the C++ scanner (native/ingest.cpp) when available; the pure-Python
    walk below is the fallback and the behavioral reference.
    """
    if use_native:
        try:
            from ...native import scan_datagrams_native

            result = scan_datagrams_native(buf, resync=resync)
        except ValueError:
            raise CorruptDatagramError("bad framing (native scanner)") from None
        except Exception:  # noqa: BLE001 - any native issue falls back to Python
            result = None
        if result is not None:
            offsets, sizes, type_codes, ts_ns = result
            dgram_type = type_codes.view("S4").astype("U4")
            # the native scanner returns exact tick-resolution ns; route them
            # through the same reference-exact f64 us path as nt_to_datetime64
            delta_ticks = np.int64(_NT_UNIX_DELTA_S) * np.int64(10_000_000)
            ticks = ts_ns.astype("i8") // np.int64(100) + delta_ticks
            return DatagramIndex(
                buf=buf,
                body_offset=offsets,
                size=sizes,
                dgram_type=dgram_type,
                timestamp=_ticks_to_datetime64(ticks),
            )
    n = len(buf)
    offsets, sizes = [], []
    pos = 0
    unpack_i4 = struct.Struct("<l").unpack_from
    while pos + 4 <= n:
        (size,) = unpack_i4(buf, pos)
        body = pos + 4
        end = body + size
        ok = 12 <= size <= n and end + 4 <= n + 4
        if ok and end + 4 <= n:
            (trailer,) = unpack_i4(buf, end)
            ok = trailer == size
        elif ok:
            ok = end == n  # final datagram may lack trailer in truncated files
        if not ok:
            if not resync:
                raise CorruptDatagramError(f"bad framing at byte {pos}")
            nxt = _find_next_datagram(buf, pos + 1)
            if nxt is None:
                break
            pos = nxt
            continue
        offsets.append(body)
        sizes.append(size)
        pos = end + 4
    offsets = np.asarray(offsets, dtype="i8")
    sizes = np.asarray(sizes, dtype="i4")
    # vectorized type + timestamp decode across all datagrams
    u8 = np.frombuffer(buf, dtype="u1")
    if len(offsets):
        hdr = u8[offsets[:, None] + np.arange(12)]
        dgram_type = hdr[:, :4].copy().view("S4").ravel().astype("U4")
        low = hdr[:, 4:8].copy().view("<u4").ravel()
        high = hdr[:, 8:12].copy().view("<u4").ravel()
        ts = nt_to_datetime64(low, high)
    else:
        dgram_type = np.empty(0, dtype="U4")
        ts = np.empty(0, dtype="datetime64[ns]")
    return DatagramIndex(buf=buf, body_offset=offsets, size=sizes, dgram_type=dgram_type, timestamp=ts)


_KNOWN_TYPES = [b"RAW", b"CON", b"NME", b"XML", b"TAG", b"BOT", b"DEP", b"MRU", b"FIL", b"IDX"]


def _find_next_datagram(buf: bytes, start: int):
    """Search for the next plausible datagram header from ``start``."""
    n = len(buf)
    best = None
    for t in _KNOWN_TYPES:
        i = buf.find(t, start)
        while i != -1:
            if i >= 4:
                (size,) = struct.unpack_from("<l", buf, i - 4)
                end = i + size
                if 12 <= size and end + 4 <= n:
                    (trailer,) = struct.unpack_from("<l", buf, end)
                    if trailer == size:
                        if best is None or i - 4 < best:
                            best = i - 4
                        break
            i = buf.find(t, i + 1)
    return best


@dataclass
class ExtentScan:
    """Header-only survey extent of one EK60/ES70 .raw file (see
    ``scan_ek_extent``): everything the survey streamer's global bin grid
    needs, without reading sample payloads."""

    times: np.ndarray  # datetime64[ns], unique sorted RAW0 timestamps
    n_channels: int
    max_count: int
    max_interval: float  # seconds
    max_sound_velocity: float  # m/s (as recorded by the instrument)


def scan_ek_extent(path) -> ExtentScan:
    """Seek-scan a local EK60/ES70 ``.raw`` file reading ONLY frame headers
    plus the 84-byte RAW0 fixed header — ~100 bytes per datagram instead of
    the whole file.

    This is the "pass 0" of the single-pass survey streamer
    (parallel/survey.py): the unique RAW0 timestamps equal the decoded beam
    ``ping_time`` union exactly (set_groups_ek60 unions per-channel RAW0
    times), so global ping bins can be fixed before any file is decoded, and
    ``max_count``/``max_interval``/``max_sound_velocity`` bound the range
    grid.  Raises :class:`CorruptDatagramError` on any framing irregularity —
    the caller falls back to the eager two-pass path, whose full scan has
    bad-byte resync.
    """
    from .decode import RAW0_HEADER

    off_interval = RAW0_HEADER.fields["sample_interval"][1]
    off_velocity = RAW0_HEADER.fields["sound_velocity"][1]
    off_count = RAW0_HEADER.fields["count"][1]
    unpack_i4 = struct.Struct("<l").unpack_from
    unpack_f4 = struct.Struct("<f").unpack_from
    unpack_2u4 = struct.Struct("<II").unpack_from

    lows, highs = [], []
    channels = set()
    max_count, max_interval, max_velocity = 0, 0.0, 0.0
    import os

    fsize = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while pos + 4 <= fsize:
            head = f.read(100)
            if len(head) < 4:
                raise CorruptDatagramError(f"truncated frame header at {pos}")
            (size,) = unpack_i4(head, 0)
            end = pos + 4 + size
            if size < 12 or end + 4 > fsize:
                raise CorruptDatagramError(f"bad framing at byte {pos}")
            if head[4:8] == b"RAW0":
                if len(head) < 4 + 84:
                    raise CorruptDatagramError(f"short RAW0 at byte {pos}")
                low, high = unpack_2u4(head, 8)
                lows.append(low)
                highs.append(high)
                # RAW0_HEADER starts at the body (type field): offsets are
                # relative to head[4]
                body = 4
                channels.add(head[body + 12] | (head[body + 13] << 8))
                max_interval = max(max_interval, unpack_f4(head, body + off_interval)[0])
                max_velocity = max(max_velocity, unpack_f4(head, body + off_velocity)[0])
                (count,) = unpack_i4(head, body + off_count)
                max_count = max(max_count, count)
            pos = end + 4
            f.seek(pos)
    times = nt_to_datetime64(np.asarray(lows, dtype="u4"), np.asarray(highs, dtype="u4"))
    return ExtentScan(
        times=np.unique(times),
        n_channels=len(channels),
        max_count=int(max_count),
        max_interval=float(max_interval),
        max_sound_velocity=float(max_velocity),
    )
