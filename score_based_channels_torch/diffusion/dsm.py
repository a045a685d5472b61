"""Annealed denoising score-matching loss, the counterpart of the JAX
package's diffusion/dsm.py:23-54 (reference ncsnv2/losses/dsm.py:6-33):
a random sigma-level per sample, x~ = x + sigma z, the score net regressed
onto -z / sigma^2, each sample's 1/2 ||.||^2 weighted by
sigma^anneal_power.

The draws come from an explicit `torch.Generator` on the batch's device;
`labels` and `noise` (the unit normal z) may be given instead, so a test
can feed both packages the same draws. `rows` keeps a slice of the
batch after the draws (a data-parallel rank's share), so a row's draws do
not depend on the number of ranks.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def anneal_dsm_loss(
    score_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    samples: torch.Tensor,
    sigmas: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    labels: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    anneal_power: float = 2.0,
    rows: Optional[slice] = None,
) -> torch.Tensor:
    """Mean annealed DSM loss over the batch, a 0-dim tensor.

    score_fn(x, used_sigmas) -> score, with x (B, H, W, 2) NHWC and
    used_sigmas (B,); the network divides by sigma itself
    (ncsnv2.py:295-298). Labels are drawn before the noise. With `rows`,
    labels and noise are drawn (or given) for the whole batch and the loss
    is the mean over samples[rows].
    """
    b = samples.shape[0]
    if labels is None:
        labels = torch.randint(0, sigmas.shape[0], (b,), generator=generator,
                               device=samples.device)
    used = sigmas[labels.to(sigmas.device)]
    bcast = used.reshape((b,) + (1,) * (samples.dim() - 1))
    if noise is None:
        noise = torch.randn(samples.shape, generator=generator,
                            device=samples.device, dtype=samples.dtype)
    if rows is not None:
        samples, labels, noise = samples[rows], labels[rows], noise[rows]
        used, bcast = used[rows], bcast[rows]
        b = samples.shape[0]
    noise = noise * bcast
    target = -noise / bcast**2
    scores = score_fn(samples + noise, used)
    diff = (scores - target).reshape(b, -1)
    return (0.5 * diff.pow(2).sum(dim=-1) * used**anneal_power).mean()
