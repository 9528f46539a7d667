from .api import compute_MVBS, compute_MVBS_index_binning, compute_NASC

__all__ = ["compute_MVBS", "compute_MVBS_index_binning", "compute_NASC"]
