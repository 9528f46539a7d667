from .framing import DatagramIndex, nt_to_datetime64, scan_datagrams

__all__ = ["scan_datagrams", "DatagramIndex", "nt_to_datetime64"]
