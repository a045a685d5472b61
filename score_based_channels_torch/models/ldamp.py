"""Learned-DAMP unrolled estimator, the counterpart of the JAX package's
models/ldamp.py:28-78 (reference aux_models.py:62-190).

AMP iteration with learned denoisers, in c2 NHWC:
  r   = h + P^H z / lambda_max                          (aux_models.py:137)
  h   = D_k(r)                       FlippedNormUnet, 10 unshared denoisers
  div = (1/eps) mean[d . (D_k(r + eps d) - D_k(r))]     Monte-Carlo divergence,
        eps = max(1e-3 max|r|, 1e-5), under no_grad (the JAX stop_gradient)
  z   = y - P h + z div                                 Onsager correction

Each denoiser's convs run `conv2d_taps` on the card (models/unet.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .. import cplx
from .unet import NormUnet


class LDAMP(nn.Module):
    def __init__(self, max_unrolls: int = 10, shared_nets: bool = False,
                 chans: int = 16, num_pools: int = 3,
                 safety_min: float = 1e-5):
        super().__init__()
        self.max_unrolls, self.shared_nets = max_unrolls, shared_nets
        self.safety_min = safety_min
        for i in range(1 if shared_nets else max_unrolls):
            self.add_module(f"denoiser_{i}", NormUnet(
                chans=chans, num_pools=num_pools, residual=True))

    def init_parameters(self, generator: torch.Generator) -> None:
        for m in self.children():
            m.init_parameters(generator)

    def forward(self, Y_herm: torch.Tensor, P_herm: torch.Tensor,
                eig1: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                num_unrolls: Optional[int] = None,
                directions: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        """Y_herm (B, Np, Nr, 2), P_herm (B, Np, Nt, 2) in c2, eig1 (B,)
        -> the channel estimate h (B, Nt, Nr, 2). The divergence
        directions d are drawn from `generator` (on the state's device),
        one per unroll, or taken from `directions`."""
        n_unroll = num_unrolls or self.max_unrolls
        if directions is None and (generator is None or
                                   generator.device.type != Y_herm.device.type):
            raise ValueError("pass a torch.Generator on the inputs' device, "
                             "or directions")
        B, Nt, Nr = Y_herm.shape[0], P_herm.shape[-2], Y_herm.shape[-2]
        h = torch.zeros((B, Nt, Nr, 2), dtype=torch.float32,
                        device=Y_herm.device)
        z = Y_herm
        Ph = cplx.conj_transpose(P_herm)
        inv_eig = (1.0 / eig1)[:, None, None]
        for k in range(n_unroll):
            net = getattr(self, f"denoiser_{0 if self.shared_nets else k}")
            r = h + cplx.scale(cplx.matmul(Ph, z), inv_eig)
            h = net(r)
            with torch.no_grad():
                r_sg, h_sg = r.detach(), h.detach()
                d = (directions[k].to(r.device) if directions is not None
                     else torch.randn(r.shape, generator=generator,
                                      device=r.device))
                eps = torch.clamp_min(
                    torch.sqrt(cplx.abs2(r_sg)).amax(dim=(-1, -2)) * 1e-3,
                    self.safety_min)
                h_pert = net(r_sg + eps[:, None, None, None] * d)
                div = (1.0 / eps) * (d * (h_pert - h_sg)).mean(dim=(1, 2, 3))
            z = Y_herm - cplx.matmul(P_herm, h) + z * div[:, None, None, None]
        return h
