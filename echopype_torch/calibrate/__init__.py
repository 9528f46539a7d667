from .api import compute_Sv, compute_TS

__all__ = ["compute_Sv", "compute_TS"]
