"""`dsm.py`'s training steps with each batch taken in blocks of rows, for
batches whose activations and gradients would not fit the card at once
(NCSNv2-Deepest at its published FFHQ widths saves ~4 GB a 256x256x3
image in float32).

Source: ermongroup/ncsnv2 losses/dsm.py:6-33 and runners/ncsn_runner.py
(Song and Ermon, arXiv:2006.09011): for a batch x, a level sigma_l drawn
per row, x~ = x + sigma_l z, the loss the mean over rows of
sigma_l^2 / 2 ||s(x~, sigma_l) + z / sigma_l||^2; Adam, then the EMA.

The network's instance norms are per sample, so the rows of a batch do
not meet before the loss's mean: the loss is the sum over blocks of each
block's rows' terms over the batch's rows, and its gradient the sum of
the blocks' gradients. The levels and noise of the whole batch are drawn
first, in `dsm.dsm_loss`'s order (levels, then noise, from the step's
generator), and cut into the blocks.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .common import Adam
from .ncsnv2 import NCSNv2Deepest


def draws(x: torch.Tensor, sigmas: torch.Tensor, gen: torch.Generator):
    """(levels' sigmas (b,), unit noise like x): `dsm.dsm_loss`'s draws."""
    b = x.shape[0]
    labels = torch.randint(0, sigmas.shape[0], (b,), generator=gen,
                           device=x.device)
    noise = torch.randn(x.shape, generator=gen, device=x.device)
    return sigmas[labels], noise


def block_loss(P: Dict[str, torch.Tensor], x: torch.Tensor,
               used: torch.Tensor, z: torch.Tensor, rows: int, ngf: int,
               anneal_power: float = 2.0) -> torch.Tensor:
    """The block's rows' share of the loss of a batch of `rows` rows."""
    b = x.shape[0]
    s = used.view(b, 1, 1, 1)
    noise = z * s
    target = -noise / s ** 2
    scores = NCSNv2Deepest(P, ngf)(x + noise, used)
    diff = (scores - target).reshape(b, -1)
    return (0.5 * diff.pow(2).sum(-1) * used ** anneal_power).sum() / rows


def loss_and_grad(P: Dict[str, torch.Tensor], x: torch.Tensor,
                  sigmas: torch.Tensor, gen: torch.Generator, ngf: int,
                  block: int, half: bool = False,
                  grad: bool = True):
    """(loss, gradients by name or None) of batch x, in blocks of `block`
    rows. `half` takes the mean over the first half of the rows only (a
    fault the comparison must catch)."""
    used, z = draws(x, sigmas, gen)
    rows = x.shape[0] // 2 if half else x.shape[0]
    names = list(P)
    total = 0.0
    grads: Optional[List[torch.Tensor]] = None
    for r0 in range(0, rows, block):
        sl = slice(r0, min(r0 + block, rows))
        with torch.set_grad_enabled(grad):
            loss = block_loss(P, x[sl], used[sl], z[sl], rows, ngf)
        if grad:
            g = torch.autograd.grad(loss, [P[k] for k in names])
            grads = list(g) if grads is None else [
                a + b for a, b in zip(grads, g)]
        total = total + loss.detach()
    return total, (dict(zip(names, grads)) if grad else None)


def train_steps(P0: Dict[str, torch.Tensor], xs: List[torch.Tensor],
                gens: List[torch.Generator], sigmas: torch.Tensor,
                lr: float, beta1: float, beta2: float, eps: float,
                ema_rate: float, ngf: int, block: int, half: bool = False):
    """Steps from P0 (not changed) on batches xs -> (losses, first
    gradient, parameters after the steps, EMA after the steps), as
    `dsm.train_steps` with its Adam's betas given."""
    P = {k: v.detach().clone().requires_grad_(True) for k, v in P0.items()}
    ema = {k: v.detach().clone() for k, v in P0.items()}
    opt = Adam(P, lr, beta1, beta2, eps)
    out, g1 = [], None
    for x, gen in zip(xs, gens):
        loss, grads = loss_and_grad(P, x, sigmas, gen, ngf, block, half)
        if g1 is None:
            g1 = {k: v.detach().clone() for k, v in grads.items()}
        opt.step(P, grads)
        del grads
        with torch.no_grad():
            for k in ema:
                ema[k].mul_(ema_rate).add_(P[k].detach(), alpha=1 - ema_rate)
        out.append(float(loss))
    return out, g1, {k: v.detach() for k, v in P.items()}, ema
