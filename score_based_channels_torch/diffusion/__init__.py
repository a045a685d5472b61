"""sigma-schedules and the annealed-Langevin samplers."""

from .sampling import (
    PosteriorRunner, annealed_langevin_inpainting,
    annealed_langevin_interpolation, annealed_langevin_posterior,
    annealed_langevin_posterior_c2, annealed_langevin_unconditional,
)
from .sigmas import (
    get_sigmas, sigmas_from_config, song_step_size, subsample_schedule,
)

__all__ = ["PosteriorRunner", "annealed_langevin_inpainting",
           "annealed_langevin_interpolation", "annealed_langevin_posterior",
           "annealed_langevin_posterior_c2",
           "annealed_langevin_unconditional", "get_sigmas",
           "sigmas_from_config", "song_step_size", "subsample_schedule"]
