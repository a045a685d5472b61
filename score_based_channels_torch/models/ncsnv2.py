"""NCSNv2-Deepest score network in PyTorch, the counterpart of
the JAX package's models/ncsnv2.py:44-118,218.

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
from .layers import Conv2d, InstanceNorm2dPlus, RefineBlock, ResidualBlock


def _apply_sigma_scaling(out: torch.Tensor, used_sigmas) -> torch.Tensor:
    """out / sigma in f32, sigma scalar or (B,) (ncsnv2.py:44-55)."""
    out = out.float()
    s = torch.as_tensor(used_sigmas, dtype=torch.float32, device=out.device)
    if s.dim() == 0:
        return out / s
    return out / s.reshape((out.shape[0],) + (1,) * (out.dim() - 1))


class NCSNv2Deepest(nn.Module):
    """The channel-estimation score network (reference ncsnv2.py:198-300):
    6 residual stages, 6 refine stages; 5,890,082 parameters at ngf=32."""

    def __init__(self, config: ModelConfig, channels: int = 2):
        super().__init__()
        if config.nonlinearity.lower() != "elu":
            raise NotImplementedError("the port's blocks fuse ELU; "
                                      f"nonlinearity {config.nonlinearity!r}")
        if config.normalization != "InstanceNorm++":
            raise NotImplementedError(
                f"normalization {config.normalization!r} is not ported")
        if config.input_transform not in ("affine_2x_minus_1", "identity"):
            raise ValueError(config.input_transform)
        self.config = config
        ngf = config.ngf
        self.begin_conv = Conv2d(channels, ngf, 3)
        self.res1 = nn.ModuleList([ResidualBlock(ngf, ngf),
                                   ResidualBlock(ngf, ngf)])
        self.res2 = nn.ModuleList([ResidualBlock(ngf, 2 * ngf, "down"),
                                   ResidualBlock(2 * ngf, 2 * ngf)])
        self.res3 = nn.ModuleList([ResidualBlock(2 * ngf, 2 * ngf, "down"),
                                   ResidualBlock(2 * ngf, 2 * ngf)])
        self.res31 = nn.ModuleList([ResidualBlock(2 * ngf, 2 * ngf, "down"),
                                    ResidualBlock(2 * ngf, 2 * ngf)])
        self.res4 = nn.ModuleList([
            ResidualBlock(2 * ngf, 4 * ngf, "down", dilation=2),
            ResidualBlock(4 * ngf, 4 * ngf, dilation=2)])
        self.res5 = nn.ModuleList([
            ResidualBlock(4 * ngf, 4 * ngf, "down", dilation=4),
            ResidualBlock(4 * ngf, 4 * ngf, dilation=4)])
        self.refine1 = RefineBlock([4 * ngf], 4 * ngf)
        self.refine2 = RefineBlock([4 * ngf, 4 * ngf], 2 * ngf)
        self.refine31 = RefineBlock([2 * ngf, 2 * ngf], 2 * ngf)
        self.refine3 = RefineBlock([2 * ngf, 2 * ngf], 2 * ngf)
        self.refine4 = RefineBlock([2 * ngf, 2 * ngf], ngf)
        self.refine5 = RefineBlock([ngf, ngf], ngf, end=True)
        self.normalizer = InstanceNorm2dPlus(ngf)
        self.end_conv = Conv2d(ngf, channels, 3)

    def init_parameters(self, generator: torch.Generator) -> None:
        """Reference-style random init, drawn from `generator`."""
        for m in self.modules():
            if isinstance(m, (Conv2d, InstanceNorm2dPlus)):
                m.init_parameters(generator)

    def forward(self, x: torch.Tensor, used_sigmas) -> torch.Tensor:
        h = x.contiguous().permute(0, 3, 1, 2)  # NHWC == NCHW channels_last
        if self.config.input_transform == "affine_2x_minus_1":
            h = 2.0 * h - 1.0
        out = self.begin_conv(h)

        def stage(blocks, t):
            for block in blocks:
                t = block(t)
            return t

        layer1 = stage(self.res1, out)
        layer2 = stage(self.res2, layer1)
        layer3 = stage(self.res3, layer2)
        layer31 = stage(self.res31, layer3)
        layer4 = stage(self.res4, layer31)
        layer5 = stage(self.res5, layer4)

        hw = lambda t: tuple(t.shape[-2:])
        ref1 = self.refine1([layer5], hw(layer5))
        ref2 = self.refine2([layer4, ref1], hw(layer4))
        ref31 = self.refine31([layer31, ref2], hw(layer31))
        ref3 = self.refine3([layer3, ref31], hw(layer3))
        ref4 = self.refine4([layer2, ref3], hw(layer2))
        out = self.refine5([layer1, ref4], hw(layer1))

        out = self.normalizer(out, elu=True)
        out = self.end_conv(out)
        return _apply_sigma_scaling(out.permute(0, 2, 3, 1), used_sigmas)


def make_score_model(model_cfg: ModelConfig, channels: int = 2,
                     device: Optional[Union[str, torch.device]] = None,
                     generator: Optional[torch.Generator] = None) -> nn.Module:
    """Build the configured score network on `device` (None: the card),
    with random parameters drawn from `generator` (a CPU generator; seed 0
    when None). Load trained weights with `load_state_dict`."""
    dev = resolve_device(device)
    if model_cfg.arch in ("ncsnv2", "ncsnv2_deeper"):
        raise NotImplementedError(
            f"arch {model_cfg.arch!r} is not ported yet (ROADMAP: other score "
            "models); the port has ncsnv2_deepest")
    if model_cfg.arch != "ncsnv2_deepest":
        raise ValueError(f"unknown arch {model_cfg.arch!r}")
    model = NCSNv2Deepest(model_cfg, channels)
    model.init_parameters(generator if generator is not None
                          else torch.Generator().manual_seed(0))
    return model.to(dev)
