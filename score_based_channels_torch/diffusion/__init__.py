"""sigma-schedules and the annealed-Langevin posterior sampler."""

from .sampling import annealed_langevin_posterior_c2
from .sigmas import (
    get_sigmas, sigmas_from_config, song_step_size, subsample_schedule,
)

__all__ = ["annealed_langevin_posterior_c2", "get_sigmas",
           "sigmas_from_config", "song_step_size", "subsample_schedule"]
