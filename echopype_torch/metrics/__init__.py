from .summary_statistics import abundance, aggregation, center_of_mass, dispersion, evenness

__all__ = ["abundance", "center_of_mass", "dispersion", "evenness", "aggregation"]
