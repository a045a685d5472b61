"""LDAMP, the paper's learned comparator, and its training step, as plain
float32 PyTorch over a dict of named parameters.

Source: utcsilab/score-based-channels aux_models.py:62-190 (LDAMP with
unshared FlippedNormUnet denoisers, Monte-Carlo divergence), aux_unet.py
(the fastMRI U-Net: ConvBlock = 2 x [3x3 conv, no bias -> instance norm
-> LeakyReLU 0.2], 2x2 mean-pool down, 2x2 stride-2 transposed conv up,
1x1 output conv; NormUnet's two-group normalisation and pad to 16),
train_ldamp.py:38-120 (batch 128, Adam 1e-3 with a x0.1 staircase, the
MSE of the unnormalised Hermitian channel) and loaders.py:52-106 (a
batch: rows without replacement, QPSK pilots, Y = H P + noise).

One unroll k, in the channel's (B, Nt, Nr, 2) real pairs:
  r = h + P^H z / lambda_max;  h = D_k(r)
  div = mean[d . (D_k(r + eps d) - D_k(r))] / eps,  eps = max(1e-3 max|r|, 1e-5)
        (no gradient through the probe)
  z = y - P h + z div
Departures from the published code: the largest eigenvalue of P P^H is
the true one (the published code takes numpy's first, unsorted one), as
the port computes it; dropout is absent (probability 0 in the recipe);
a batch's draws come from the seeded generators that the port uses
(`batch`), the probes' directions from one generator on the device.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .common import Adam, c2_conj_t, c2_matmul, qpsk

Params = Dict[str, torch.Tensor]


def param_specs(unrolls: int = 10, chans: int = 16, pools: int = 3,
                in_chans: int = 2) -> List[Tuple[str, tuple, str]]:
    specs = []
    for i in range(unrolls):
        p = f"denoiser_{i}.unet."

        def block(name, a, b):
            specs.append((f"{p}{name}.conv_0.weight", (b, a, 3, 3), "conv"))
            specs.append((f"{p}{name}.conv_1.weight", (b, b, 3, 3), "conv"))

        ch = chans
        block("down_0", in_chans, ch)
        for k in range(1, pools):
            block(f"down_{k}", ch, 2 * ch)
            ch *= 2
        block("bottleneck", ch, 2 * ch)
        for k in range(pools):
            specs.append((f"{p}up_t_{k}.tconv.weight", (2 * ch, ch, 2, 2),
                          "tconv"))
            block(f"up_c_{k}", 2 * ch, ch)
            if k < pools - 1:
                ch //= 2
        specs.append((f"{p}final_conv.weight", (in_chans, ch, 1, 1), "conv"))
        specs.append((f"{p}final_conv.bias", (in_chans,), "conv"))
    return specs


def _norm_act(x):
    return F.leaky_relu(F.instance_norm(x, eps=1e-5), 0.2)


def unet(P: Params, p: str, x: torch.Tensor, pools: int = 3) -> torch.Tensor:
    def block(name, t):
        t = _norm_act(F.conv2d(t, P[f"{p}{name}.conv_0.weight"], padding=1))
        return _norm_act(F.conv2d(t, P[f"{p}{name}.conv_1.weight"],
                                  padding=1))

    stack, out = [], x
    for k in range(pools):
        out = block(f"down_{k}", out)
        stack.append(out)
        out = F.avg_pool2d(out, 2)
    out = block("bottleneck", out)
    for k in range(pools):
        skip = stack.pop()
        out = _norm_act(F.conv_transpose2d(out, P[f"{p}up_t_{k}.tconv.weight"],
                                           stride=2))
        ph, pw = skip.shape[-2] - out.shape[-2], skip.shape[-1] - out.shape[-1]
        if ph or pw:
            out = F.pad(out, (0, pw, 0, ph), mode="reflect")
        out = block(f"up_c_{k}", torch.cat([out, skip], dim=1))
    return F.conv2d(out, P[f"{p}final_conv.weight"], P[f"{p}final_conv.bias"])


def flipped_norm_unet(P: Params, p: str, x: torch.Tensor) -> torch.Tensor:
    """x - U(x) with the two-group normalisation around the U-Net; x and
    the result (B, H, W, 2)."""
    xc = x.permute(0, 3, 1, 2)
    b, c, h, w = xc.shape
    g = xc.reshape(b, 2, -1)
    mean = g.mean(dim=2).repeat_interleave(c // 2, 1).view(b, c, 1, 1)
    std = g.std(dim=2).repeat_interleave(c // 2, 1).view(b, c, 1, 1)
    n = (xc - mean) / std
    hm, wm = ((h - 1) | 15) + 1, ((w - 1) | 15) + 1
    hp = (math.floor((hm - h) / 2), math.ceil((hm - h) / 2))
    wp = (math.floor((wm - w) / 2), math.ceil((wm - w) / 2))
    n = F.pad(n, (wp[0], wp[1], hp[0], hp[1]))
    n = unet(P, p, n)[:, :, hp[0]:hm - hp[1], wp[0]:wm - wp[1]]
    return (xc - (n * std + mean)).permute(0, 2, 3, 1)


def ldamp(P: Params, batch: Dict[str, torch.Tensor], gen: torch.Generator,
          unrolls: int = 10) -> torch.Tensor:
    """The estimate h (B, Nt, Nr, 2) of a batch, probes drawn from gen."""
    Y, Pm, eig1 = batch["Y_herm"], batch["P_herm"], batch["eig1"]
    h = torch.zeros(Y.shape[0], Pm.shape[-2], Y.shape[-2], 2,
                    device=Y.device)
    z = Y
    Ph = c2_conj_t(Pm)
    inv = (1.0 / eig1).view(-1, 1, 1, 1)
    for k in range(unrolls):
        p = f"denoiser_{k}.unet."
        r = h + c2_matmul(Ph, z) * inv
        h = flipped_norm_unet(P, p, r)
        with torch.no_grad():
            rs, hs = r.detach(), h.detach()
            d = torch.randn(r.shape, generator=gen, device=r.device)
            eps = torch.clamp_min(
                torch.sqrt(rs[..., 0] ** 2 + rs[..., 1] ** 2).amax(
                    dim=(-1, -2)) * 1e-3, 1e-5)
            hp = flipped_norm_unet(P, p, rs + eps.view(-1, 1, 1, 1) * d)
            div = (1.0 / eps) * (d * (hp - hs)).mean(dim=(1, 2, 3))
        z = Y - c2_matmul(Pm, h) + z * div.view(-1, 1, 1, 1)
    return h


def losses(h: torch.Tensor, H: torch.Tensor) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """(the mean squared error of the estimates, their mean NMSE)."""
    err = ((h - H) ** 2).sum(dim=(-1, -2, -3))
    return err.mean(), (err / (H ** 2).sum(dim=(-1, -2, -3))).mean()


def batch(channels: np.ndarray, gen: torch.Generator, size: int,
          num_pilots: int, noise_amp: float) -> Dict[str, torch.Tensor]:
    """A training batch, drawn from a CPU generator as the port's data set
    draws it: rows (randperm), pilots, measurement noise."""
    n = channels.shape[0]
    idx = torch.randperm(n, generator=gen)[:size]
    H = torch.from_numpy(channels)[idx]                       # (B, Nr, Nt)
    Pc = torch.view_as_complex(qpsk(gen, size, channels.shape[-1],
                                    num_pilots))              # (B, Nt, Np)
    Y = H @ Pc
    if noise_amp > 0:
        Y = Y + noise_amp * torch.view_as_complex(
            torch.randn(Y.shape + (2,), generator=gen))
    herm = lambda t: t.transpose(-1, -2).conj().resolve_conj()  # noqa: E731
    eig1 = torch.linalg.eigvalsh(Pc @ herm(Pc))[..., -1].float()
    c2 = lambda t: torch.view_as_real(t.contiguous())  # noqa: E731
    return {"Y_herm": c2(herm(Y)), "P_herm": c2(herm(Pc)),
            "H_herm_cplx": c2(herm(H)), "eig1": eig1}


def train_steps(P0: Params, batches, dir_gens, lr, adam_eps: float = 1e-8,
                unrolls: int = 10, half: bool = False, keep=()):
    """Steps of LDAMP training from parameters P0 (not changed): each the
    estimate of its batch, the MSE, its gradient, an Adam update at the
    rate `lr(t)` of step t -> (losses [(mse, nmse)], first gradient,
    {n: parameters after n steps} for each n in `keep` and after the
    last step). `half` takes the loss over the first half of each batch
    only (a fault the comparison must catch)."""
    P = {k: v.detach().clone().requires_grad_(True) for k, v in P0.items()}
    opt = Adam(P, lr, 0.9, 0.999, adam_eps)
    out, g1, snaps = [], None, {}
    for b, gen in zip(batches, dir_gens):
        h = ldamp(P, b, gen, unrolls)
        H = b["H_herm_cplx"]
        if half:
            h, H = h[: h.shape[0] // 2], H[: H.shape[0] // 2]
        mse, nmse = losses(h, H)
        grads = dict(zip(P, torch.autograd.grad(mse, list(P.values()))))
        if g1 is None:
            g1 = {k: v.detach().clone() for k, v in grads.items()}
        opt.step(P, grads)
        out.append((float(mse.detach()), float(nmse.detach())))
        if len(out) in keep:
            snaps[len(out)] = {k: v.detach().clone() for k, v in P.items()}
    snaps[len(out)] = {k: v.detach() for k, v in P.items()}
    return out, g1, snaps
