"""NCSNv2-Deepest, the score network of the paper, as plain float32
PyTorch over a dict of named parameters.

Source: Arvinte & Tamir, "MIMO Channel Estimation Using Score-Based
Generative Models" (IEEE TWC 2023), code utcsilab/score-based-channels,
ncsnv2/models/ncsnv2.py:198-300 (NCSNv2Deepest), layers.py (RefineNet
blocks) and normalization.py:150-176 (InstanceNorm++), as train_score.py
configures it: ngf 32, ELU, InstanceNorm++, 2 input channels, the input
mapped to 2x - 1, the output divided by sigma.

Departures from the published code, none of which changes the function:
- the input and output are (B, Nt, Nr, 2) real pairs and the network
  works on the NCHW view of that layout (the paper's code feeds
  (B, 2, Nt, Nr)); the parameters carry the names of that code's state
  dict;
- a dilated 3x3 conv whose outer taps reach past the whole image computes
  them on zero padding here, as the published code does;
- no conditional norms (the paper's configuration has none).

`quant` is applied to every conv's input and weight: the identity for
the reference, `common.fp8` for the control of a bfloat16 cell.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from .common import identity

Params = Dict[str, torch.Tensor]

# (name, [(in, out, resample, dilation), ...]) in units of ngf
STAGES = [
    ("res1", [(1, 1, None, None), (1, 1, None, None)]),
    ("res2", [(1, 2, "down", None), (2, 2, None, None)]),
    ("res3", [(2, 2, "down", None), (2, 2, None, None)]),
    ("res31", [(2, 2, "down", None), (2, 2, None, None)]),
    ("res4", [(2, 4, "down", 2), (4, 4, None, 2)]),
    ("res5", [(4, 4, "down", 4), (4, 4, None, 4)]),
]
# (name, input planes, features) in units of ngf; the last one ends
REFINES = [
    ("refine1", [4], 4), ("refine2", [4, 4], 2), ("refine31", [2, 2], 2),
    ("refine3", [2, 2], 2), ("refine4", [2, 2], 1), ("refine5", [1, 1], 1),
]


def param_specs(ngf: int = 32,
                channels: int = 2) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter, in the published state
    dict's order. init: "conv" (uniform within 1/sqrt(fan_in)), "one"
    (normal, mean 1, std 0.02), "zero"."""
    specs: List[Tuple[str, tuple, str]] = []

    def conv(name, i, o, k=3, bias=True):
        specs.append((name + ".weight", (o, i, k, k), "conv"))
        if bias:
            specs.append((name + ".bias", (o,), "conv"))

    def norm(name, c):
        specs.extend([(name + ".alpha", (c,), "one"),
                      (name + ".gamma", (c,), "one"),
                      (name + ".beta", (c,), "zero")])

    def rcu(name, c, n_blocks):
        for i in range(n_blocks):
            for j in range(2):
                conv(f"{name}.{i + 1}_{j + 1}_conv", c, c, bias=False)

    conv("begin_conv", channels, ngf)
    for name, blocks in STAGES:
        for b, (i, o, resample, dil) in enumerate(blocks):
            i, o = i * ngf, o * ngf
            p = f"{name}.{b}"
            mid = i if resample == "down" else o
            norm(p + ".normalize1", i)
            conv(p + ".conv1", i, mid)
            norm(p + ".normalize2", mid)
            if resample == "down" and dil is None:
                conv(p + ".conv2.conv", mid, o)
            else:
                conv(p + ".conv2", mid, o)
            if o == i and resample is None:
                pass
            elif resample == "down" and dil is None:
                conv(p + ".shortcut.conv", i, o, k=1)
            elif dil is not None:
                conv(p + ".shortcut", i, o)
            else:
                conv(p + ".shortcut", i, o, k=1)
    for k, (name, planes, feats) in enumerate(REFINES):
        end = k == len(REFINES) - 1
        for a, c in enumerate(planes):
            rcu(f"{name}.adapt_convs.{a}", c * ngf, 2)
        if len(planes) > 1:
            for a, c in enumerate(planes):
                conv(f"{name}.msf.convs.{a}", c * ngf, feats * ngf)
        for s in range(2):
            conv(f"{name}.crp.convs.{s}", feats * ngf, feats * ngf,
                 bias=False)
        rcu(f"{name}.output_convs", feats * ngf, 3 if end else 1)
    norm("normalizer", ngf)
    conv("end_conv", ngf, channels)
    return specs


class NCSNv2Deepest:
    """forward(x (B, Nt, Nr, 2), sigma 0-d or (B,)) -> score (B, Nt, Nr, 2),
    the network's output divided by sigma. Parameters: the dict `P`
    (names of `param_specs`, conv weights (O, I, k, k))."""

    def __init__(self, P: Params, ngf: int = 32,
                 quant: Callable[[torch.Tensor], torch.Tensor] = identity):
        self.P, self.ngf, self.q = P, ngf, quant

    def conv(self, name: str, x: torch.Tensor, d: int = 1) -> torch.Tensor:
        w = self.P[name + ".weight"]
        return F.conv2d(self.q(x), self.q(w), self.P.get(name + ".bias"),
                        padding=d * (w.shape[-1] // 2), dilation=d)

    def norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """InstanceNorm++ (normalization.py:150-176), then ELU."""
        a, g, b = (self.P[f"{name}.{k}"].view(1, -1, 1, 1)
                   for k in ("alpha", "gamma", "beta"))
        means = x.mean(dim=(2, 3))
        m = means.mean(dim=-1, keepdim=True)
        v = means.var(dim=-1, keepdim=True, unbiased=True)
        means_hat = (means - m) / torch.sqrt(v + 1e-5)
        mu = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
        h = (x - mu) / torch.sqrt(var + 1e-5) + means_hat[..., None, None] * a
        return F.elu(g * h + b)

    def residual(self, p: str, x, i, o, resample, dil):
        d = dil or 1
        h = self.conv(p + ".conv1", self.norm(p + ".normalize1", x), d)
        h = self.norm(p + ".normalize2", h)
        if resample == "down" and dil is None:
            h = F.avg_pool2d(self.conv(p + ".conv2.conv", h), 2)
            sc = F.avg_pool2d(self.conv(p + ".shortcut.conv", x), 2)
        else:
            h = self.conv(p + ".conv2", h, d)
            sc = x if (o == i and resample is None) else self.conv(
                p + ".shortcut", x, d)
        return sc + h

    def rcu(self, name: str, x, n_blocks: int):
        for i in range(n_blocks):
            r = x
            x = F.elu(self.conv(f"{name}.{i + 1}_1_conv", F.elu(x)))
            x = self.conv(f"{name}.{i + 1}_2_conv", x) + r
        return x

    def refine(self, k: int, xs, hw):
        name, planes, _ = REFINES[k]
        end = k == len(REFINES) - 1
        hs = [self.rcu(f"{name}.adapt_convs.{a}", x, 2)
              for a, x in enumerate(xs)]
        if len(hs) > 1:
            h = 0
            for a, t in enumerate(hs):
                t = self.conv(f"{name}.msf.convs.{a}", t)
                if tuple(t.shape[-2:]) != tuple(hw):
                    t = F.interpolate(t, size=tuple(hw), mode="bilinear",
                                      align_corners=True)
                h = h + t
        else:
            h = hs[0]
        h = F.elu(h)  # chained residual pooling
        path = h
        for s in range(2):
            path = self.conv(f"{name}.crp.convs.{s}",
                             F.max_pool2d(path, 5, stride=1, padding=2))
            h = path + h
        return self.rcu(f"{name}.output_convs", h, 3 if end else 1)

    def __call__(self, x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        n = self.ngf
        h = 2.0 * x.permute(0, 3, 1, 2) - 1.0
        out = self.conv("begin_conv", h)
        layers = []
        for name, blocks in STAGES:
            for b, (i, o, resample, dil) in enumerate(blocks):
                out = self.residual(f"{name}.{b}", out, i * n, o * n,
                                    resample, dil)
            layers.append(out)
        ref = None
        for k in range(len(REFINES)):
            skip = layers[-1 - k]
            ref = self.refine(k, [skip] if ref is None else [skip, ref],
                              skip.shape[-2:])
        out = self.conv("end_conv", self.norm("normalizer", ref))
        out = out.permute(0, 2, 3, 1)
        s = torch.as_tensor(sigma, dtype=out.dtype, device=out.device)
        return out / (s if s.dim() == 0 else s.view(-1, 1, 1, 1))
