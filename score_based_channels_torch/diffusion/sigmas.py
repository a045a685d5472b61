"""Noise (sigma) schedules, the counterpart of
the JAX package's diffusion/sigmas.py (get_sigmas:13,
sigmas_from_config:33, subsample_schedule:40, song_step_size:61)."""

from __future__ import annotations

import numpy as np
import torch


def get_sigmas(sigma_begin: float, sigma_end: float, num: int,
               dist: str = "geometric") -> torch.Tensor:
    """sigma-schedule as a float32 CPU tensor.

    'geometric': exp(linspace(log s0, log sN)); 'uniform': linspace(s0, sN)
    (ncsnv2/models/__init__.py:4-17). Computed in float64 with numpy, then
    rounded once, as the JAX package does.
    """
    if dist == "geometric":
        s = np.exp(np.linspace(np.log(sigma_begin), np.log(sigma_end), num))
    elif dist == "uniform":
        s = np.linspace(sigma_begin, sigma_end, num)
    else:
        raise NotImplementedError(f"sigma distribution {dist!r} not supported")
    return torch.from_numpy(s.astype(np.float32))


def sigmas_from_config(model_cfg) -> torch.Tensor:
    return get_sigmas(model_cfg.sigma_begin, model_cfg.sigma_end,
                      model_cfg.num_classes, model_cfg.sigma_dist)


def subsample_schedule(sigmas: torch.Tensor, stride: int):
    """Keep every `stride`-th sigma-level (always keeping sigma_end).

    Returns (sub_sigmas, alpha_scale): the Langevin step alpha_step scales
    by the stride to cover the same ground.
    """
    if stride <= 1:
        return sigmas, 1.0
    sub = sigmas[::stride]
    if float(sub[-1]) != float(sigmas[-1]):
        sub = torch.cat([sub, sigmas[-1:]])
    return sub, float(stride)


def song_step_size(sigma_end: float, num_classes: int, sigma_rate: float,
                   candidates: np.ndarray | None = None) -> float:
    """The Langevin step whose [Song '20] mixing criterion is closest to 1
    (train_score.py:104-115): scan a logspace of candidate steps. Pure
    numpy, a copy of the JAX package's rule."""
    if candidates is None:
        candidates = np.logspace(-13, -8, 1000)
    gamma = 1.0 / sigma_rate
    se2 = sigma_end**2
    eps = candidates
    contraction = (1.0 - eps / se2) ** (2 * num_classes)
    tail = 2 * eps / (se2 - se2 * (1.0 - eps / se2) ** 2)
    criterion = contraction * (gamma**2 - tail) + tail
    return float(candidates[int(np.argmin(np.abs(criterion - 1.0)))])
