"""Training of the score network: annealed denoising score matching with
Adam and an exponential moving average of the parameters, as plain
float32 PyTorch.

Source: utcsilab/score-based-channels train_score.py:34-67, 145-216 and
ncsnv2/losses/dsm.py:6-33: for a batch x, a noise level sigma_l drawn
per row, x~ = x + sigma_l z, the loss mean over rows of
sigma_l^2 / 2 ||s(x~, sigma_l) - (-z / sigma_l)||^2; Adam (lr 1e-4,
eps 1e-3), then ema <- 0.999 ema + 0.001 params. The validation loss is
the same loss of the EMA network on the validation set.

The draws are the port's, made again from the same seeds: a step's rows
from the epoch's permutation (a CPU generator), its levels and then its
noise from a generator on the device.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .common import Adam
from .ncsnv2 import NCSNv2Deepest


def dsm_loss(P: Dict[str, torch.Tensor], x: torch.Tensor,
             sigmas: torch.Tensor, gen: torch.Generator, ngf: int = 32,
             anneal_power: float = 2.0, half: bool = False) -> torch.Tensor:
    """The loss of batch x, levels then noise drawn from gen. `half` takes
    the mean over the first half of the rows only (a fault the comparison
    must catch)."""
    b = x.shape[0]
    labels = torch.randint(0, sigmas.shape[0], (b,), generator=gen,
                           device=x.device)
    noise = torch.randn(x.shape, generator=gen, device=x.device)
    used = sigmas[labels].view(b, 1, 1, 1)
    if half:
        b //= 2
        x, noise, used = x[:b], noise[:b], used[:b]
    noise = noise * used
    target = -noise / used ** 2
    scores = NCSNv2Deepest(P, ngf)(x + noise, used.view(-1))
    diff = (scores - target).reshape(b, -1)
    return (0.5 * diff.pow(2).sum(-1) * used.view(-1) ** anneal_power).mean()


def train_steps(P0: Dict[str, torch.Tensor], xs: List[torch.Tensor],
                gens: List[torch.Generator], sigmas: torch.Tensor,
                lr: float, eps: float, ema_rate: float, ngf: int = 32,
                half: bool = False):
    """Steps from P0 (not changed) on batches xs -> (losses, first
    gradient, parameters after the steps, EMA after the steps)."""
    P = {k: v.detach().clone().requires_grad_(True) for k, v in P0.items()}
    ema = {k: v.detach().clone() for k, v in P0.items()}
    opt = Adam(P, lr, 0.9, 0.999, eps)
    out, g1 = [], None
    for x, gen in zip(xs, gens):
        loss = dsm_loss(P, x, sigmas, gen, ngf, half=half)
        grads = dict(zip(P, torch.autograd.grad(loss, list(P.values()))))
        if g1 is None:
            g1 = {k: v.detach().clone() for k, v in grads.items()}
        opt.step(P, grads)
        with torch.no_grad():
            for k in ema:
                ema[k].mul_(ema_rate).add_(P[k].detach(), alpha=1 - ema_rate)
        out.append(float(loss.detach()))
    return out, g1, {k: v.detach() for k, v in P.items()}, ema
