"""Exponential moving average of the parameters, the counterpart of the
JAX package's diffusion/ema.py:17-32 (reference ncsnv2/models/ema.py:16-21):
shadow <- mu shadow + (1 - mu) p, mu = 0.999.

The shadow is a copy of the model (`copy.deepcopy` keeps each conv
weight's kernel layout), so validation and sampling run it as they run
the model.
"""

from __future__ import annotations

import copy

import torch
from torch import nn


def ema_init(model: nn.Module) -> nn.Module:
    """A distinct copy of the model whose parameters take no gradient."""
    shadow = copy.deepcopy(model)
    shadow.requires_grad_(False)
    return shadow


@torch.no_grad()
def ema_update(shadow: nn.Module, model: nn.Module, mu: float = 0.999) -> None:
    """shadow <- mu shadow + (1 - mu) p, in place, parameter by parameter."""
    s = list(shadow.parameters())
    torch._foreach_mul_(s, mu)
    torch._foreach_add_(s, [p.detach() for p in model.parameters()],
                        alpha=1.0 - mu)
