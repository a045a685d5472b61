"""NCSNv2 score networks in PyTorch (NCSNv2, NCSNv2Deeper and
NCSNv2Deepest), the counterpart of the JAX package's models/ncsnv2.py.

The forward takes x (B, Nt, Nr, 2), the JAX package's NHWC layout, and
views it as an NCHW tensor in channels_last memory (no copy); it returns
the score (B, Nt, Nr, 2) in float32 divided by sigma, whatever the
network's dtype (the f32 tail of ncsnv2.py:44-55).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from .._device import resolve_device
from ..config import ModelConfig
from .layers import (
    Conv2d, InstanceNorm2d, InstanceNorm2dPlus, RefineBlock, ResidualBlock,
    VarianceNorm2d, act_after, get_act, get_normalization,
)


def _apply_sigma_scaling(out: torch.Tensor, used_sigmas) -> torch.Tensor:
    """out / sigma in f32, sigma scalar or (B,) (ncsnv2.py:44-55)."""
    out = out.float()
    s = torch.as_tensor(used_sigmas, dtype=torch.float32, device=out.device)
    if s.dim() == 0:
        return out / s
    return out / s.reshape((out.shape[0],) + (1,) * (out.dim() - 1))


class _RefineNet(nn.Module):
    """The NCSNv2 family (reference ncsnv2.py): begin conv, residual stages,
    refine stages that walk back up the stages (refine k takes stage
    [-1-k] and refine k-1's output), InstanceNorm++ + the activation, end
    conv. The activation and the residual blocks' norm come from
    `config.nonlinearity` and `config.normalization` (JAX ncsnv2.py:77-78);
    the final norm is InstanceNorm++ whatever the config, as there.

    `stages`: (name, [(in, out, resample, dilation), ...]) in order;
    `refines`: (name, in_planes, features), the last one with end=True.
    """

    def __init__(self, config: ModelConfig, channels: int, stages, refines):
        super().__init__()
        act = get_act(config.nonlinearity)
        norm = get_normalization(config.normalization)
        if config.input_transform not in ("affine_2x_minus_1", "identity"):
            raise ValueError(config.input_transform)
        self.config, self.act = config, act
        ngf = config.ngf
        self.begin_conv = Conv2d(channels, ngf, 3)
        self.stage_names = [name for name, _ in stages]
        for name, blocks in stages:
            self.add_module(name, nn.ModuleList(
                [ResidualBlock(i, o, r, d, act, norm)
                 for i, o, r, d in blocks]))
        self.refine_names = [name for name, _, _ in refines]
        for k, (name, planes, features) in enumerate(refines):
            self.add_module(name, RefineBlock(
                planes, features, end=k == len(refines) - 1, act=act))
        self.normalizer = InstanceNorm2dPlus(ngf)
        self.end_conv = Conv2d(ngf, channels, 3)

    def init_parameters(self, generator: torch.Generator) -> None:
        """Reference-style random init, drawn from `generator`."""
        for m in self.modules():
            if isinstance(m, (Conv2d, InstanceNorm2dPlus, InstanceNorm2d,
                              VarianceNorm2d)):
                m.init_parameters(generator)

    def forward(self, x: torch.Tensor, used_sigmas) -> torch.Tensor:
        h = x.contiguous().permute(0, 3, 1, 2)  # NHWC == NCHW channels_last
        if self.config.input_transform == "affine_2x_minus_1":
            h = 2.0 * h - 1.0
        out = self.begin_conv(h)
        layers = []
        for name in self.stage_names:
            for block in getattr(self, name):
                out = block(out)
            layers.append(out)
        ref = None
        for k, name in enumerate(self.refine_names):
            skip = layers[-1 - k]
            ref = getattr(self, name)([skip] if ref is None else [skip, ref],
                                      tuple(skip.shape[-2:]))
        out = act_after(self.normalizer, ref, self.act)
        out = self.end_conv(out)
        return _apply_sigma_scaling(out.permute(0, 2, 3, 1), used_sigmas)


def _pair(i, o, resample=None, dilation=None):
    """A stage of two residual blocks: i -> o (resampled), then o -> o."""
    return [(i, o, resample, dilation), (o, o, None, dilation)]


class NCSNv2Deepest(_RefineNet):
    """The channel-estimation score network (reference ncsnv2.py:198-300,
    JAX ncsnv2.py:44-118): 6 residual stages, 6 refine stages; 5,890,082
    parameters at ngf=32."""

    def __init__(self, config: ModelConfig, channels: int = 2):
        n = config.ngf
        super().__init__(config, channels, [
            ("res1", _pair(n, n)), ("res2", _pair(n, 2 * n, "down")),
            ("res3", _pair(2 * n, 2 * n, "down")),
            ("res31", _pair(2 * n, 2 * n, "down")),
            ("res4", _pair(2 * n, 4 * n, "down", 2)),
            ("res5", _pair(4 * n, 4 * n, "down", 4))], [
            ("refine1", [4 * n], 4 * n),
            ("refine2", [4 * n, 4 * n], 2 * n),
            ("refine31", [2 * n, 2 * n], 2 * n),
            ("refine3", [2 * n, 2 * n], 2 * n),
            ("refine4", [2 * n, 2 * n], n),
            ("refine5", [n, n], n)])


class NCSNv2Deeper(_RefineNet):
    """5-stage variant (reference ncsnv2.py:104-195, JAX ncsnv2.py:121-165)."""

    def __init__(self, config: ModelConfig, channels: int = 2):
        n = config.ngf
        super().__init__(config, channels, [
            ("res1", _pair(n, n)), ("res2", _pair(n, 2 * n, "down")),
            ("res3", _pair(2 * n, 2 * n, "down")),
            ("res4", _pair(2 * n, 4 * n, "down", 2)),
            ("res5", _pair(4 * n, 4 * n, "down", 4))], [
            ("refine1", [4 * n], 4 * n),
            ("refine2", [4 * n, 4 * n], 2 * n),
            ("refine3", [2 * n, 2 * n], 2 * n),
            ("refine4", [2 * n, 2 * n], n),
            ("refine5", [n, n], n)])


class NCSNv2(_RefineNet):
    """4-stage variant (reference ncsnv2.py:11-101, JAX ncsnv2.py:168-215)."""

    def __init__(self, config: ModelConfig, channels: int = 2):
        n = config.ngf
        super().__init__(config, channels, [
            ("res1", _pair(n, n)), ("res2", _pair(n, 2 * n, "down")),
            ("res3", _pair(2 * n, 2 * n, "down", 2)),
            ("res4", _pair(2 * n, 2 * n, "down", 4))], [
            ("refine1", [2 * n], 2 * n),
            ("refine2", [2 * n, 2 * n], 2 * n),
            ("refine3", [2 * n, 2 * n], n),
            ("refine4", [n, n], n)])


_ARCHS = {"ncsnv2": NCSNv2, "ncsnv2_deeper": NCSNv2Deeper,
          "ncsnv2_deepest": NCSNv2Deepest}


def make_score_model(model_cfg: ModelConfig, channels: int = 2,
                     device: Optional[Union[str, torch.device]] = None,
                     generator: Optional[torch.Generator] = None) -> nn.Module:
    """Build the configured score network on `device` (None: the card),
    with random parameters drawn from `generator` (a CPU generator; seed 0
    when None). Load trained weights with `load_state_dict`."""
    if model_cfg.arch not in _ARCHS:
        raise ValueError(f"unknown arch {model_cfg.arch!r}")
    dev = resolve_device(device)
    model = _ARCHS[model_cfg.arch](model_cfg, channels)
    model.init_parameters(generator if generator is not None
                          else torch.Generator().manual_seed(0))
    return model.to(dev)
