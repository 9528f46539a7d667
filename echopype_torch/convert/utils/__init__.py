"""convert.utils: reference-named helper modules (ek date math, dedup checks).

The heavy lifting (datagram framing, columnar decode) lives in
``convert/simrad``; these modules keep the reference's public helper surface
(echopype/convert/utils/) importable for migrating callers.
"""

from . import ek_date_conversion, ek_duplicates, ek_swap  # noqa: F401
