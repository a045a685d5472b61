"""fastMRI-style U-Nets, the counterpart of the JAX package's
models/unet.py:29-170 (reference aux_unet.py):

  Unet            avg-pool down, transpose-conv up; ConvBlock =
                  2 x [3x3 conv (no bias) -> InstanceNorm -> LeakyReLU(0.2)]
  NormUnet        2-group normalisation and a pad to multiples of 16
                  around the U-Net (aux_unet.py:9-113)
  FlippedNormUnet the same, residual: x - f(x), LDAMP's denoiser

Public tensors are NHWC (B, H, W, C), the JAX package's layout; inside,
NCHW views in channels-last memory. The 3x3 convs and the 1x1
`final_conv` are `layers.Conv2d`, as the JAX package uses its
`layers.Conv2d` there: on the card they run the `conv2d_taps` kernel (and
its dgrad in training). The 2x2 stride-2 transposed conv
(`nn.ConvTranspose2d`), the affine-free instance norm (`F.instance_norm`,
eps 1e-5, biased variance) and the 2x2 mean pool are library calls, as
the JAX package computes them outside Pallas.

The transposed conv's weight is torch's (I, O, 2, 2); the JAX package's
ConvTranspose (transpose_kernel=False) applies its (2, 2, I, O)
kernel unflipped, so `convert.py` flips it spatially on the way across.
Dropout is not ported: the JAX models run with drop_prob 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, mean_pool_2x2

_CL = torch.channels_last


def _norm_act(x: torch.Tensor) -> torch.Tensor:
    """InstanceNorm2d(affine=False, eps 1e-5) -> LeakyReLU(0.2), kept in
    channels-last memory for the next conv."""
    return F.leaky_relu(F.instance_norm(x, eps=1e-5),
                        0.2).contiguous(memory_format=_CL)


class ConvBlock(nn.Module):
    """2 x [3x3 conv (no bias) -> IN -> LeakyReLU(0.2)] (unet.py:38)."""

    def __init__(self, in_chans: int, out_chans: int):
        super().__init__()
        self.conv_0 = Conv2d(in_chans, out_chans, 3, bias=False)
        self.conv_1 = Conv2d(out_chans, out_chans, 3, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _norm_act(self.conv_1(_norm_act(self.conv_0(x))))


class TransposeConvBlock(nn.Module):
    """ConvTranspose(2x2, stride 2, no bias) -> IN -> LeakyReLU(0.2)
    (unet.py:55); weight (I, O, 2, 2), init U(+-1/sqrt(4 I))."""

    def __init__(self, in_chans: int, out_chans: int):
        super().__init__()
        self.tconv = nn.ConvTranspose2d(in_chans, out_chans, 2, stride=2,
                                        bias=False)

    def init_parameters(self, generator: torch.Generator) -> None:
        w = self.tconv.weight
        bound = 1.0 / math.sqrt(w.shape[0] * 4)
        with torch.no_grad():
            w.copy_(torch.empty(w.shape).uniform_(-bound, bound,
                                                  generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _norm_act(self.tconv(x))


class Unet(nn.Module):
    """U-Net (unet.py:72), NCHW channels-last in and out."""

    def __init__(self, in_chans: int = 2, out_chans: int = 2,
                 chans: int = 16, num_pool_layers: int = 3):
        super().__init__()
        self.num_pool_layers = num_pool_layers
        ch = chans
        self.down_0 = ConvBlock(in_chans, ch)
        for i in range(1, num_pool_layers):
            self.add_module(f"down_{i}", ConvBlock(ch, 2 * ch))
            ch *= 2
        self.bottleneck = ConvBlock(ch, 2 * ch)
        for i in range(num_pool_layers):
            self.add_module(f"up_t_{i}", TransposeConvBlock(2 * ch, ch))
            self.add_module(f"up_c_{i}", ConvBlock(2 * ch, ch))
            if i < num_pool_layers - 1:
                ch //= 2
        self.final_conv = Conv2d(ch, out_chans, 1)

    def init_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, (Conv2d, TransposeConvBlock)):
                m.init_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stack = []
        out = x
        for i in range(self.num_pool_layers):
            out = getattr(self, f"down_{i}")(out)
            stack.append(out)
            out = mean_pool_2x2(out)
        out = self.bottleneck(out)
        for i in range(self.num_pool_layers):
            skip = stack.pop()
            out = getattr(self, f"up_t_{i}")(out)
            # reflect-pad right/bottom on an odd-size mismatch (unet.py:100-105)
            pad_h = skip.shape[-2] - out.shape[-2]
            pad_w = skip.shape[-1] - out.shape[-1]
            if pad_h or pad_w:
                out = F.pad(out, (0, pad_w, 0, pad_h), mode="reflect")
            out = torch.cat([out, skip], dim=1).contiguous(memory_format=_CL)
            out = getattr(self, f"up_c_{i}")(out)
        return self.final_conv(out)


def _group_norm_2(x: torch.Tensor):
    """The NormUnet 2-group statistics (unet.py:115-134) of NCHW x: the
    first and second half of the channels, unbiased std."""
    b, c, h, w = x.shape
    xt = x.reshape(b, 2, (c // 2) * h * w)
    mean = xt.mean(dim=2)
    std = xt.std(dim=2)  # unbiased, as torch.std in the reference
    mean = mean.repeat_interleave(c // 2, dim=1).view(b, c, 1, 1)
    std = std.repeat_interleave(c // 2, dim=1).view(b, c, 1, 1)
    return (x - mean) / std, mean, std


def _pad16(x: torch.Tensor):
    """Pad H, W to multiples of 16 (unet.py:137-145); returns the padded
    tensor and the (h0, h1, w0, w1) window of the original."""
    h, w = x.shape[-2:]
    hm, wm = ((h - 1) | 15) + 1, ((w - 1) | 15) + 1
    hp = (math.floor((hm - h) / 2), math.ceil((hm - h) / 2))
    wp = (math.floor((wm - w) / 2), math.ceil((wm - w) / 2))
    x = F.pad(x, (wp[0], wp[1], hp[0], hp[1]))
    return x, (hp[0], hm - hp[1], wp[0], wm - wp[1])


class NormUnet(nn.Module):
    """Normalise -> pad -> U-Net -> unpad -> unnormalise (unet.py:148);
    residual=True is the FlippedNormUnet (x - f(x)). x is NHWC."""

    def __init__(self, chans: int = 16, num_pools: int = 3,
                 in_chans: int = 2, out_chans: int = 2,
                 residual: bool = False):
        super().__init__()
        self.residual = residual
        self.unet = Unet(in_chans, out_chans, chans, num_pools)

    def init_parameters(self, generator: torch.Generator) -> None:
        self.unet.init_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xc = x.permute(0, 3, 1, 2)
        n, mean, std = _group_norm_2(xc)
        n, (h0, h1, w0, w1) = _pad16(n)
        n = self.unet(n.contiguous(memory_format=_CL))
        n = n[:, :, h0:h1, w0:w1] * std + mean
        out = xc - n if self.residual else n
        return out.permute(0, 2, 3, 1)


def FlippedNormUnet(chans: int = 16, num_pools: int = 3, **kw) -> NormUnet:
    """The residual denoiser (unet.py:166, aux_unet.py:115-219)."""
    return NormUnet(chans=chans, num_pools=num_pools, residual=True, **kw)
