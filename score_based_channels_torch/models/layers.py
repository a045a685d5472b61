"""RefineNet building blocks in PyTorch, the counterpart of
the JAX package's models/layers.py:49-496.

Tensors are NCHW in torch.channels_last memory, which is the JAX package's
NHWC layout; every conv, InstanceNorm++, 5x5 max pool and 2x2 mean pool goes
through the kernel wrappers of `..kernels`, which launch the Hopper kernels
on the card and run their plain versions on the CPU (the pools keep the
library's under autograd). Module and parameter names follow the reference
state dict (`res1.0.conv1.weight`, RCU's `{i}_{j}_conv`), so a converted JAX
parameter tree loads with strict=True.

Activations and norms come from the config (`get_act`, `get_normalization`,
the JAX package's layers.py:35,222). With ELU, the default, every norm
followed by the activation takes `elu=True`, and in an RCU the first conv
of a stage pair takes the ELU that follows it as its epilogue, so the
kernels apply it. Any other activation runs as one torch op after a
kernel launched with `elu=False`. InstanceNorm, VarianceNorm and None are
plain torch ops here, as they are outside Pallas in the JAX package.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import conv as conv_kernel
from ..kernels import instance_norm as norm_kernel
from ..kernels import max_pool as pool_kernel
from ..kernels import mean_pool as mean_pool_kernel

Act = Callable[[torch.Tensor], torch.Tensor]


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def get_act(nonlinearity: str) -> Act:
    """Activation factory (layers.py:35; reference layers.py:11-23): elu,
    relu, lrelu (slope 0.2), swish = x sigmoid(x). ELU is F.elu itself, so
    the blocks can tell it apart and fuse it into the kernels."""
    name = nonlinearity.lower()
    acts = {"elu": F.elu, "relu": F.relu, "lrelu": _lrelu, "swish": _swish}
    if name not in acts:
        raise NotImplementedError("activation function does not exist!")
    return acts[name]


def act_after(fn: Callable[..., torch.Tensor], x: torch.Tensor,
              act: Act) -> torch.Tensor:
    """act(fn(x)) for a conv or norm `fn` that takes `elu=`: ELU is fused
    into its kernel, any other activation follows as a torch op."""
    if act is F.elu:
        return fn(x, elu=True)
    return act(fn(x))


class Conv2d(nn.Module):
    """Stride-1 k x k conv, padding d*(k//2), torch's default init
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias. Dead dilated
    taps are pruned (layers.py:86-97) by the kernel and its plain version.

    The (O, I, k, k) weight is stored in the kernel's layout, (k, k, I, O)
    in memory (`conv.kernel_layout`), which load_state_dict, .to() and
    deepcopy keep, so the kernel reads the parameter itself.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 dilation: int = 1, bias: bool = True):
        super().__init__()
        self.dilation = dilation
        self.weight = nn.Parameter(conv_kernel.kernel_layout(
            torch.empty(out_ch, in_ch, kernel_size, kernel_size)))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def init_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        with torch.no_grad():
            for p in (self.weight, self.bias):
                if p is not None:
                    # drawn in (O, I, k, k) order, whatever the memory layout
                    draw = torch.empty(p.shape, dtype=p.dtype, device=p.device)
                    p.copy_(draw.uniform_(-bound, bound, generator=generator))

    def forward(self, x: torch.Tensor, elu: bool = False) -> torch.Tensor:
        return conv_kernel.conv2d(x, self.weight, self.bias, self.dilation,
                                  elu)


class InstanceNorm2dPlus(nn.Module):
    """InstanceNorm++ (reference normalization.py:150-176); alpha, gamma ~
    N(1, 0.02^2), beta = 0. Statistics in f32 whatever the parameter and
    activation dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(features))
        self.gamma = nn.Parameter(torch.ones(features))
        self.beta = nn.Parameter(torch.zeros(features))

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for p in (self.alpha, self.gamma):
                p.normal_(1.0, 0.02, generator=generator)
            self.beta.zero_()

    def forward(self, x: torch.Tensor, elu: bool = False) -> torch.Tensor:
        return norm_kernel.instance_norm_plus(x, self.alpha, self.gamma,
                                              self.beta, elu=elu)


def _affine_out(h: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                shift: Optional[torch.Tensor], elu: bool) -> torch.Tensor:
    """scale h (+ shift) per channel in f32, then ELU, in x's dtype."""
    view = (1, -1, 1, 1)
    out = h * scale.float().view(view)
    if shift is not None:
        out = out + shift.float().view(view)
    out = out.to(x.dtype)
    return F.elu(out) if elu else out


class InstanceNorm2d(nn.Module):
    """Instance norm with affine parameters (layers.py:166; torch's
    InstanceNorm2d(affine=True)): biased per-sample variance, eps 1e-5,
    gamma = 1, beta = 0. A plain torch op; statistics in f32."""

    def __init__(self, features: int, bias: bool = True):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(features))
        self.beta = nn.Parameter(torch.zeros(features)) if bias else None

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.gamma.fill_(1.0)
            if self.beta is not None:
                self.beta.zero_()

    def forward(self, x: torch.Tensor, elu: bool = False) -> torch.Tensor:
        xs = x.float()
        var, mu = torch.var_mean(xs, dim=(2, 3), correction=0, keepdim=True)
        h = (xs - mu) / torch.sqrt(var + 1e-5)
        return _affine_out(h, x, self.gamma, self.beta, elu)


class VarianceNorm2d(nn.Module):
    """Variance-only norm (layers.py:188; reference normalization.py:
    107-121): h = x / sqrt(unbiased per-sample variance + 1e-5), times
    alpha ~ N(1, 0.02^2); no shift unless `bias`. A plain torch op."""

    def __init__(self, features: int, bias: bool = False):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(features))
        self.beta = nn.Parameter(torch.zeros(features)) if bias else None

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.alpha.normal_(1.0, 0.02, generator=generator)
            if self.beta is not None:
                self.beta.zero_()

    def forward(self, x: torch.Tensor, elu: bool = False) -> torch.Tensor:
        xs = x.float()
        var = torch.var(xs, dim=(2, 3), correction=1, keepdim=True)
        h = xs / torch.sqrt(var + 1e-5)
        return _affine_out(h, x, self.alpha, self.beta, elu)


class NoneNorm2d(nn.Module):
    """Identity (layers.py:211; reference normalization.py:142-147)."""

    def __init__(self, features: int, bias: bool = True):
        super().__init__()

    def forward(self, x: torch.Tensor, elu: bool = False) -> torch.Tensor:
        return F.elu(x) if elu else x


_NORMS = {"InstanceNorm++": InstanceNorm2dPlus, "InstanceNorm": InstanceNorm2d,
          "VarianceNorm": VarianceNorm2d, "None": NoneNorm2d}


def get_normalization(name: str) -> Callable[..., nn.Module]:
    """Norm factory of the unconditional path (layers.py:222; reference
    normalization.py:8-33)."""
    if name not in _NORMS:
        raise NotImplementedError(f"normalization {name!r} not implemented")
    return _NORMS[name]


# -----------------------------------------------------------------------------
# pooling / resampling
# -----------------------------------------------------------------------------


def max_pool_5x5(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel=5, stride=1, padding=2) (layers.py:240): the kernel
    on a card tensor that autograd does not need, the library's pool on one
    it does, the plain version on the CPU (`kernels.max_pool`)."""
    return pool_kernel.max_pool_5x5(x)


def avg_pool_5x5(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(kernel=5, stride=1, padding=2), count_include_pad=True
    (layers.py:245)."""
    return F.avg_pool2d(x, 5, stride=1, padding=2, count_include_pad=True)


def mean_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """4-phase 2x mean-downsample (layers.py:254); needs even H, W. The
    kernel on a card tensor that autograd does not need, the library's pool
    on one it does, the plain version on the CPU (`kernels.mean_pool`)."""
    return mean_pool_kernel.mean_pool_2x2(x)


def resize_bilinear_align_corners(x: torch.Tensor,
                                  out_hw: Tuple[int, int]) -> torch.Tensor:
    """F.interpolate(bilinear, align_corners=True) (layers.py:281)."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=True)


class ConvMeanPool(nn.Module):
    """conv (stride 1) -> 2x2 mean downsample (layers.py:303)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mean_pool_2x2(self.conv(x))


class MeanPoolConv(nn.Module):
    """2x2 mean downsample -> conv (layers.py:317)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 bias: bool = True):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel_size, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(mean_pool_2x2(x))


class UpsampleConv(nn.Module):
    """2x nearest upsample (the reference's 4 copies + PixelShuffle(2)) ->
    conv (layers.py:330)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 bias: bool = True):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel_size, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return self.conv(up.contiguous(memory_format=torch.channels_last))


# -----------------------------------------------------------------------------
# RefineNet blocks
# -----------------------------------------------------------------------------


class CRPBlock(nn.Module):
    """Chained residual pooling (layers.py:352): the activation, then
    n_stages of pool (5x5 max, or mean with maxpool=False) -> conv (no
    bias), each added to the running sum."""

    def __init__(self, features: int, n_stages: int = 2, act: Act = F.elu,
                 maxpool: bool = True):
        super().__init__()
        self.act, self.maxpool = act, maxpool
        self.convs = nn.ModuleList(
            [Conv2d(features, features, 3, bias=False) for _ in range(n_stages)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pool = max_pool_5x5 if self.maxpool else avg_pool_5x5
        x = self.act(x)
        path = x
        for conv in self.convs:
            path = conv(pool(path))
            x = path + x
        return x


class RCUBlock(nn.Module):
    """Residual conv units (layers.py:372), parameters named `{i}_{j}_conv`.
    Each stage is the activation -> conv (no bias); an ELU opening a stage
    that follows a conv is that conv's fused epilogue."""

    def __init__(self, features: int, n_blocks: int, n_stages: int,
                 act: Act = F.elu):
        super().__init__()
        self.n_blocks, self.n_stages, self.act = n_blocks, n_stages, act
        for i in range(n_blocks):
            for j in range(n_stages):
                self.add_module(f"{i + 1}_{j + 1}_conv",
                                Conv2d(features, features, 3, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_blocks):
            residual = x
            x = self.act(x)
            for j in range(self.n_stages):
                conv = getattr(self, f"{i + 1}_{j + 1}_conv")
                x = (act_after(conv, x, self.act) if j + 1 < self.n_stages
                     else conv(x))
            x = x + residual
        return x


class MSFBlock(nn.Module):
    """Multi-scale fusion: conv each input, resize, sum (layers.py:396)."""

    def __init__(self, in_planes: Sequence[int], features: int):
        super().__init__()
        self.convs = nn.ModuleList(
            [Conv2d(c, features, 3, bias=True) for c in in_planes])

    def forward(self, xs: Sequence[torch.Tensor],
                out_hw: Tuple[int, int]) -> torch.Tensor:
        total = None
        for conv, x in zip(self.convs, xs):
            h = resize_bilinear_align_corners(conv(x), out_hw)
            total = h if total is None else total + h
        return total


class RefineBlock(nn.Module):
    """RCU adapters -> MSF -> CRP -> output RCUs (layers.py:411)."""

    def __init__(self, in_planes: Sequence[int], features: int,
                 end: bool = False, act: Act = F.elu, maxpool: bool = True):
        super().__init__()
        self.adapt_convs = nn.ModuleList(
            [RCUBlock(c, n_blocks=2, n_stages=2, act=act) for c in in_planes])
        self.msf = MSFBlock(in_planes, features) if len(in_planes) > 1 else None
        self.crp = CRPBlock(features, n_stages=2, act=act, maxpool=maxpool)
        self.output_convs = RCUBlock(features, n_blocks=3 if end else 1,
                                     n_stages=2, act=act)

    def forward(self, xs: Sequence[torch.Tensor],
                out_hw: Tuple[int, int]) -> torch.Tensor:
        hs: List[torch.Tensor] = [rcu(x) for rcu, x in zip(self.adapt_convs, xs)]
        h = self.msf(hs, out_hw) if self.msf is not None else hs[0]
        return self.output_convs(self.crp(h))


class ResidualBlock(nn.Module):
    """Pre-norm residual block (layers.py:439). resample='down' without
    dilation halves H and W through ConvMeanPool; with dilation the size is
    kept and every conv is dilated (the reference's res4/res5)."""

    def __init__(self, input_dim: int, output_dim: int,
                 resample: Optional[str] = None,
                 dilation: Optional[int] = None, act: Act = F.elu,
                 normalization: Callable[..., nn.Module] = InstanceNorm2dPlus):
        super().__init__()
        if resample not in (None, "down"):
            raise ValueError("invalid resample value")
        self.act = act
        d = dilation or 1
        mid = input_dim if resample == "down" else output_dim
        self.normalize1 = normalization(input_dim)
        self.conv1 = Conv2d(input_dim, mid, 3, dilation=d)
        self.normalize2 = normalization(mid)
        if resample == "down" and dilation is None:
            self.conv2 = ConvMeanPool(mid, output_dim, 3)
        else:
            self.conv2 = Conv2d(mid, output_dim, 3, dilation=d)

        if output_dim == input_dim and resample is None:
            self.shortcut = None
        elif resample == "down" and dilation is None:
            self.shortcut = ConvMeanPool(input_dim, output_dim, 1)
        elif dilation is not None:
            self.shortcut = Conv2d(input_dim, output_dim, 3, dilation=d)
        else:
            self.shortcut = Conv2d(input_dim, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = act_after(self.normalize1, x, self.act)
        h = self.conv1(h)
        h = act_after(self.normalize2, h, self.act)
        h = self.conv2(h)
        shortcut = x if self.shortcut is None else self.shortcut(x)
        return shortcut + h


class BatchNorm2d(nn.Module):
    """BatchNorm over (N, H, W) with the rule of the JAX package's
    BatchNorm (its DnCNN and DCGAN use it), which torch's BatchNorm2d
    does not follow:

      train: mean = E[x], var = max(E[x^2] - mean^2, 0) (biased, the
             JAX package's fast variance);
             y = (x - mean) rsqrt(var + eps) scale + bias;
             running <- momentum running + (1 - momentum) batch, with the
             BIASED batch variance (torch stores the unbiased one and
             weighs the new value by its momentum);
      eval:  the running mean and var.

    Parameters `scale`, `bias` and buffers `mean`, `var` carry the JAX
    package's names, so `convert.jax_variables_to_state_dict` maps a
    `params` + `batch_stats` pair onto them. Init: scale ~ N(1, scale_std^2) (1 when
    scale_std is 0), bias 0, mean 0, var 1.
    """

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, scale_std: float = 0.0):
        super().__init__()
        self.momentum, self.eps, self.scale_std = momentum, eps, scale_std
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            if self.scale_std:
                self.scale.normal_(1.0, self.scale_std, generator=generator)
            else:
                self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        view = (1, -1, 1, 1)
        if self.training:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean.view(view)) * mul.view(view) + self.bias.view(view)
