"""DCGAN critic and generator of the WGAN baseline, the counterpart of the
JAX package's models/dcgan.py:43-119 (reference aux_gan.py):

  DCGAN_D  4x4/s2 strided-conv pyramid down to (4, 16), then a valid conv
           over the remaining map to a scalar; the critic's output is the
           BATCH MEAN (aux_gan.py:56)
  DCGAN_G  dense z -> (Nr/4, Nt/4, ngf), 2 x [nearest 2x upsample -> 5x5
           conv -> BN -> ReLU], n_extra_layers x [3x3 conv (no bias) -> BN
           -> ReLU], 5x5 conv to 2 channels

Images are NHWC (B, Nr, Nt, 2): the non-Hermitian channel view the WGAN
trains on. The JAX package builds these from its framework's Conv, Dense and
BatchNorm (not its layers.Conv2d), so the port uses library layers:
nn.Conv2d, nn.Linear, and `layers.BatchNorm2d` with the JAX package's update rule.
Init (train_wgan.py:78-84): conv kernels and the dense kernel N(0, 0.02^2),
their biases 0; BN scale N(1, 0.02^2), bias 0.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm2d


def _bn(features: int) -> BatchNorm2d:
    return BatchNorm2d(features, momentum=0.9, eps=1e-5, scale_std=0.02)


def _init(module: nn.Module, generator: torch.Generator) -> None:
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator) * 0.02)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm2d):
                m.init_parameters(generator)


class DCGAN_D(nn.Module):
    """WGAN critic; returns the batch-mean scalar."""

    def __init__(self, isize: Tuple[int, int] = (16, 64), nc: int = 2,
                 ndf: int = 64, n_extra_layers: int = 0):
        super().__init__()
        if min(isize) % 16:
            raise ValueError("isize has to be a multiple of 16")
        conv = lambda i, o, k, s, p: nn.Conv2d(i, o, k, s, p, bias=False)
        self.initial_conv = conv(nc, ndf, 4, 2, 1)
        self.n_extra = n_extra_layers
        for t in range(n_extra_layers):
            self.add_module(f"extra_conv_{t}", conv(ndf, ndf, 3, 1, 1))
            self.add_module(f"extra_bn_{t}", _bn(ndf))
        csize, cndf, p = min(isize) // 2, ndf, 0
        hw = [s // 2 for s in isize]
        while csize > 4:
            self.add_module(f"pyramid_conv_{p}", conv(cndf, 2 * cndf, 4, 2, 1))
            self.add_module(f"pyramid_bn_{p}", _bn(2 * cndf))
            cndf, csize, p = 2 * cndf, csize // 2, p + 1
            hw = [s // 2 for s in hw]
        self.n_pyramid = p
        self.final_conv = nn.Conv2d(cndf, 1, tuple(hw), bias=False)

    def init_parameters(self, generator: torch.Generator) -> None:
        _init(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.initial_conv(x.permute(0, 3, 1, 2)), 0.2)
        for t in range(self.n_extra):
            h = getattr(self, f"extra_conv_{t}")(h)
            h = F.leaky_relu(getattr(self, f"extra_bn_{t}")(h), 0.2)
        for p in range(self.n_pyramid):
            h = getattr(self, f"pyramid_conv_{p}")(h)
            h = F.leaky_relu(getattr(self, f"pyramid_bn_{p}")(h), 0.2)
        return self.final_conv(h).mean()


class DCGAN_G(nn.Module):
    """Generator z (B, nz) -> channels (B, Nr, Nt, nc)."""

    def __init__(self, isize: Tuple[int, int] = (16, 64), nz: int = 60,
                 nc: int = 2, ngf: int = 128, n_extra_layers: int = 0):
        super().__init__()
        self.isize, self.ngf, self.n_extra = isize, ngf, n_extra_layers
        nr, nt = isize
        self.dense_input = nn.Linear(nz, ngf * nr * nt // 16)
        for i in (1, 2):
            self.add_module(f"conv_{i}", nn.Conv2d(ngf, ngf, 5, padding=2))
            self.add_module(f"bn_{i}", _bn(ngf))
        for t in range(n_extra_layers):
            self.add_module(f"extra_conv_{t}",
                            nn.Conv2d(ngf, ngf, 3, padding=1, bias=False))
            self.add_module(f"extra_bn_{t}", _bn(ngf))
        self.conv_out = nn.Conv2d(ngf, nc, 5, padding=2)

    def init_parameters(self, generator: torch.Generator) -> None:
        _init(self, generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        nr, nt = self.isize
        hidden = self.dense_input(z.reshape(z.shape[0], -1))
        # the dense output is (nr/4, nt/4, ngf) NHWC in the JAX package
        h = hidden.view(-1, nr // 4, nt // 4, self.ngf).permute(0, 3, 1, 2)
        for i in (1, 2):
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = getattr(self, f"conv_{i}")(h)
            h = F.relu(getattr(self, f"bn_{i}")(h))
        for t in range(self.n_extra):
            h = getattr(self, f"extra_conv_{t}")(h)
            h = F.relu(getattr(self, f"extra_bn_{t}")(h))
        return self.conv_out(h).permute(0, 2, 3, 1)
