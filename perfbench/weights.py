"""Random weights made from the seed on the run's device, in a few large
draws, and handed the same to the program and to the reference.

Each parameter is drawn as the published code initialises it: a conv's
weight and bias uniform within 1/sqrt(fan_in) (PyTorch's default; a
transposed conv's (I, O, k, k) weight takes I k k as its fan-in), a
norm's scales normal with mean 1 and std 0.02, its shift 0. The draws are
two calls on one generator (uniform for every conv leaf, normal for every
scale), cut into the leaves in `specs` order.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from .reference.common import derive_seed

Spec = Tuple[str, tuple, str]


def make_weights(specs: List[Spec], seed: int, device,
                 served: Optional[torch.dtype] = None
                 ) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on `device`. With `served` (say bfloat16),
    every value is rounded to that type first, so a program that casts its
    copy to it holds exactly these values."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(derive_seed(seed, 101))
    n_u = sum(math.prod(s) for _, s, kind in specs
              if kind in ("conv", "tconv"))
    n_n = sum(math.prod(s) for _, s, kind in specs if kind == "one")
    u = torch.rand(n_u, generator=gen, device=dev) * 2.0 - 1.0
    g = torch.randn(n_n, generator=gen, device=dev) * 0.02 + 1.0
    out, iu, ig = {}, 0, 0
    fan = {}
    for name, shape, kind in specs:  # a bias takes its weight's fan-in
        if kind == "conv" and name.endswith(".weight"):
            fan[name[:-len(".weight")]] = math.prod(shape[1:])
        elif kind == "tconv":
            fan[name[:-len(".weight")]] = shape[0] * math.prod(shape[2:])
    for name, shape, kind in specs:
        n = math.prod(shape)
        if kind in ("conv", "tconv"):
            stem = name.rsplit(".", 1)[0]
            t = u[iu:iu + n].view(shape) / math.sqrt(fan[stem])
            iu += n
        elif kind == "one":
            t = g[ig:ig + n].view(shape)
            ig += n
        else:
            t = torch.zeros(shape, device=dev)
        out[name] = t.to(served).float() if served is not None else t
    return out
