from .fielding import transient_noise_fielding
from .matecho import transient_noise_matecho

__all__ = ["transient_noise_fielding", "transient_noise_matecho"]
