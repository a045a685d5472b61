"""Plain CNN denoisers, the counterpart of the JAX package's
models/cnn.py:26-55 (reference aux_models.py:10-59):

  DnCNN  head conv+ReLU, (nb-2) x [conv+BN+ReLU], tail conv; residual
         output x - n (an alternative LDAMP backbone)
  SRCNN  9x9 -> 5x5 -> 5x5 convs (unused by the reference pipeline)

x is NHWC, as in the JAX package. DnCNN's 3x3 convs are `layers.Conv2d`
(`conv2d_taps` on the card) and its BatchNorm follows the JAX package's rule
(momentum 0.9 on the old value, eps 1e-4; `layers.BatchNorm2d`). SRCNN's
9x9 and 5x5 convs are library convs (`nn.Conv2d`): `conv2d_taps` takes
k = 1 or 3.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm2d, Conv2d

_CL = torch.channels_last


class DnCNN(nn.Module):
    def __init__(self, in_chans: int = 2, out_chans: int = 2,
                 hidden: int = 64, num_layers: int = 17,
                 kernel_size: int = 3, batch_norm: bool = True):
        super().__init__()
        self.batch_norm, self.n_body = batch_norm, num_layers - 2
        self.head = Conv2d(in_chans, hidden, kernel_size)
        for i in range(self.n_body):
            self.add_module(f"body_{i}", Conv2d(hidden, hidden, kernel_size,
                                                bias=not batch_norm))
            if batch_norm:
                self.add_module(f"bn_{i}", BatchNorm2d(hidden, eps=1e-4))
        self.tail = Conv2d(hidden, out_chans, kernel_size)

    def init_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, (Conv2d, BatchNorm2d)):
                m.init_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C); BatchNorm in train mode uses and updates the
        batch statistics, in eval mode the running ones."""
        xc = x.permute(0, 3, 1, 2)
        h = self.head(xc.contiguous(memory_format=_CL))
        h = F.relu(h)
        for i in range(self.n_body):
            h = getattr(self, f"body_{i}")(h)
            if self.batch_norm:
                h = getattr(self, f"bn_{i}")(h)
            h = F.relu(h).contiguous(memory_format=_CL)
        n = self.tail(h)
        return (xc - n).permute(0, 2, 3, 1)


def _library_conv(in_ch: int, out_ch: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, k, padding=k // 2)


class SRCNN(nn.Module):
    def __init__(self, in_chans: int = 2, out_chans: int = 2):
        super().__init__()
        self.conv1 = _library_conv(in_chans, 64, 9)
        self.conv2 = _library_conv(64, 32, 5)
        self.conv3 = _library_conv(32, out_chans, 5)

    def init_parameters(self, generator: torch.Generator) -> None:
        """U(+-1/sqrt(fan_in)) for every weight and bias (the JAX
        package's Conv2d init)."""
        with torch.no_grad():
            for conv in (self.conv1, self.conv2, self.conv3):
                bound = 1.0 / math.sqrt(conv.weight[0].numel())
                for p in (conv.weight, conv.bias):
                    p.copy_(torch.empty(p.shape).uniform_(
                        -bound, bound, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)
        h = F.relu(self.conv1(h))
        h = F.relu(self.conv2(h))
        return self.conv3(h).permute(0, 2, 3, 1)
