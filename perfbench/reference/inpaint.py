"""Annealed Langevin inpainting, the NCSNv2 image sampler, as plain float32
PyTorch.

Source: Song & Ermon, "Improved Techniques for Training Score-Based
Generative Models" (NeurIPS 2020), code ermongroup/ncsnv2,
models/__init__.py `anneal_Langevin_dynamics_inpainting` and `get_sigmas`
(configs/ffhq.yml: sigmas geometric from 348 to 0.01 over 2311 levels,
3 steps a level, step_lr 9e-7). At every level i and inner step:
  step = step_lr (sigma_i / sigma_end)^2
  x[known] <- refer[known] + sigma_i n1          (the known region)
  x <- x + step s(x, sigma_i) + sqrt(2 step) z

Departures from the published code, none of which changes the function:
- images are (B, H, W, C) real tensors (the published code's are
  (B, C, H, W)); the known region is a mask broadcast over them (the
  published code knows the left half of the columns);
- n1 is drawn for the whole image and z after it, from one generator on
  the run's device, in the benchmark program's order, so both draw the
  same numbers; the published code draws n1 for the known half only;
- `stride` keeps every stride-th level and the last, with step_lr scaled
  by the stride (the benchmark's cut of the schedule);
- `rows`, if given, runs only those rows of the batch; the draws are made
  for the whole batch and cut to them, so each row sees its own draws.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def sigmas(begin: float, end: float, num: int, stride: int = 1):
    """(levels, step_lr scale): the published geometric schedule
    exp(linspace(log begin, log end, num)) in float64, rounded once to
    float32; every stride-th level and the last, the scale the stride."""
    s = torch.from_numpy(np.exp(np.linspace(np.log(begin), np.log(end),
                                            num)).astype(np.float32))
    if stride <= 1:
        return s, 1.0
    sub = s[::stride]
    if float(sub[-1]) != float(s[-1]):
        sub = torch.cat([sub, s[-1:]])
    return sub, float(stride)


@torch.no_grad()
def inpaint(net: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
            x_init: torch.Tensor, refer: torch.Tensor, mask: torch.Tensor,
            levels: torch.Tensor, step_lr: float, steps_each: int,
            gen: torch.Generator,
            rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The final images (B, H, W, C) (or those of `rows`), float32, from
    x_init; `net(x, sigma)` gives the score; `mask` is 1.0 where `refer`
    is known."""
    dev = x_init.device
    pick = (lambda t: t) if rows is None else (
        lambda t: t.index_select(0, rows.to(dev)))
    shape_x, shape_r = x_init.shape, refer.shape
    x = pick(x_init.to(dev, torch.float32))
    refer = pick(refer.to(dev, torch.float32))
    mask = mask.to(dev, torch.float32)
    levels = levels.to(dev, torch.float32)
    sigma_end = levels[-1]
    for sigma in levels:
        step = step_lr * (sigma / sigma_end) ** 2
        amp = torch.sqrt(2.0 * step)
        for _ in range(steps_each):
            n1 = pick(torch.randn(shape_r, generator=gen, device=dev))
            z = pick(torch.randn(shape_x, generator=gen, device=dev))
            x = mask * (refer + sigma * n1) + (1.0 - mask) * x
            x = x + step * net(x, sigma) + amp * z
    return x
