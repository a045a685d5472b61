"""NCSNv2-Deepest forward as a function of the parameter dictionary, with a
swappable 8x2 deep segment.

The counterpart of the JAX package's kernels/fused_forward.py. The module
forward (models/ncsnv2.py) stays the source of truth; this module
re-expresses the same forward directly on the port's state dict
(`model.state_dict()`, or `models.convert.jax_params_to_state_dict`'s
output), so that the 8x2 deep segment (res31.1 -> res4 -> res5 -> refine1
-> refine2 -> refine31 -> refine3's pre-resize path) is a closure that a
caller can replace (`segment=`, default `deep_segment_plain`).

Every conv and InstanceNorm++ goes through the same kernel wrappers, with
the same fused ELUs, as models/layers.py, so on the card one forward
launches `conv2d_taps` 113 times and `instance_norm_plus` 25 times, and on
the CPU it runs the same plain ops as the module forward. `act` threads
the activation through every block, the deep segment's included, as the
module does (`models.layers.get_act`; ELU by default, fused into the
kernels; any other runs after them as a torch op). The norm is
InstanceNorm++, as in the JAX function.

`prepare_params` nests the flat state dict, moves it to a device and
dtype, and lays out every conv weight in `conv.kernel_layout`, which the
card's conv kernel requires and the converter's contiguous (O, I, k, k)
output lacks. `fused_forward` calls it once per forward; it copies nothing
that is already right, and a caller can pass its result instead, to pay
for a layout or cast once.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.layers import (
    Act,
    act_after,
    max_pool_5x5,
    mean_pool_2x2,
    resize_bilinear_align_corners,
)
from ..models.ncsnv2 import _apply_sigma_scaling
from . import conv as conv_kernel
from . import instance_norm as norm_kernel

Params = Dict[str, object]


def prepare_params(state: Mapping, device: Optional[torch.device] = None,
                   dtype: Optional[torch.dtype] = None) -> Params:
    """{'res1.0.conv1.weight': t, ...} -> {'res1': {'0': {'conv1':
    {'weight': t}}}, ...} on `device` in `dtype`, 4-D weights in
    kernel_layout. A nested dictionary is taken as already prepared."""
    if not any("." in k for k in state):
        return state  # type: ignore[return-value]
    out: Params = {}
    for key, t in state.items():
        t = t.to(device=device, dtype=dtype)
        if t.dim() == 4 and not conv_kernel.has_kernel_layout(t):
            t = conv_kernel.kernel_layout(t)
        *path, leaf = key.split(".")
        node = out
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = t
    return out


# -----------------------------------------------------------------------------
# building blocks on parameter subtrees (NCHW, channels_last)
# -----------------------------------------------------------------------------


def conv2d_p(p: Params, x: torch.Tensor, dilation: int = 1,
             elu: bool = False) -> torch.Tensor:
    """Conv2d from a {'weight', ['bias']} subtree; the wrapper prunes dead
    dilated taps as models/layers.py Conv2d does."""
    return conv_kernel.conv2d(x, p["weight"], p.get("bias"), dilation, elu)


def instance_norm_pp_p(p: Params, x: torch.Tensor,
                       elu: bool = False) -> torch.Tensor:
    """InstanceNorm++ from {'alpha', 'gamma', 'beta'}."""
    return norm_kernel.instance_norm_plus(x, p["alpha"], p["gamma"],
                                          p["beta"], elu)


def residual_block_p(p: Params, x: torch.Tensor,
                     resample: Optional[str] = None,
                     dilation: Optional[int] = None,
                     act: Act = F.elu) -> torch.Tensor:
    """ResidualBlock from its subtree (models/layers.py ResidualBlock)."""
    d = dilation or 1
    h = act_after(functools.partial(instance_norm_pp_p, p["normalize1"]), x,
                  act)
    h = conv2d_p(p["conv1"], h, d)
    h = act_after(functools.partial(instance_norm_pp_p, p["normalize2"]), h,
                  act)
    if resample == "down" and dilation is None:
        h = mean_pool_2x2(conv2d_p(p["conv2"]["conv"], h))
        shortcut = mean_pool_2x2(conv2d_p(p["shortcut"]["conv"], x))
    else:
        h = conv2d_p(p["conv2"], h, d)
        shortcut = x if "shortcut" not in p else conv2d_p(p["shortcut"], x, d)
    return shortcut + h


def rcu_p(p: Params, x: torch.Tensor, n_blocks: int,
          n_stages: int = 2, act: Act = F.elu) -> torch.Tensor:
    """RCU: act -> conv stages, an ELU after a stage's conv fused into it."""
    for i in range(n_blocks):
        residual = x
        x = act(x)
        for j in range(n_stages):
            conv = functools.partial(conv2d_p, p[f"{i + 1}_{j + 1}_conv"])
            x = act_after(conv, x, act) if j + 1 < n_stages else conv(x)
        x = x + residual
    return x


def crp_p(p: Params, x: torch.Tensor, n_stages: int = 2,
          act: Act = F.elu) -> torch.Tensor:
    x = act(x)
    path = x
    for i in range(n_stages):
        path = conv2d_p(p["convs"][str(i)], max_pool_5x5(path))
        x = path + x
    return x


def refine_block_p(p: Params, xs, out_hw: Tuple[int, int],
                   end: bool = False, act: Act = F.elu) -> torch.Tensor:
    hs = [rcu_p(p["adapt_convs"][str(i)], x, n_blocks=2, act=act)
          for i, x in enumerate(xs)]
    if len(xs) > 1:
        total = None
        for i, h in enumerate(hs):
            h = resize_bilinear_align_corners(
                conv2d_p(p["msf"]["convs"][str(i)], h), out_hw)
            total = h if total is None else total + h
        h = total
    else:
        h = hs[0]
    h = crp_p(p["crp"], h, act=act)
    return rcu_p(p["output_convs"], h, n_blocks=3 if end else 1, act=act)


# -----------------------------------------------------------------------------
# the 8x2 deep segment
# -----------------------------------------------------------------------------


def deep_segment_plain(params: Params, x: torch.Tensor,
                       act: Act = F.elu) -> torch.Tensor:
    """res31.1 -> res4 -> res5 -> refine1 -> refine2 -> refine31 ->
    refine3's pre-resize path: x (B, 64, 8, 2) -> the MSF path-1
    contribution (B, 64, 8, 2), before its resize to 16x4."""
    layer31 = residual_block_p(params["res31"]["1"], x, act=act)
    layer4 = residual_block_p(params["res4"]["0"], layer31, "down", 2, act)
    layer4 = residual_block_p(params["res4"]["1"], layer4, dilation=2, act=act)
    layer5 = residual_block_p(params["res5"]["0"], layer4, "down", 4, act)
    layer5 = residual_block_p(params["res5"]["1"], layer5, dilation=4, act=act)
    hw = tuple(x.shape[-2:])
    ref1 = refine_block_p(params["refine1"], [layer5], hw, act=act)
    ref2 = refine_block_p(params["refine2"], [layer4, ref1], hw, act=act)
    ref31 = refine_block_p(params["refine31"], [layer31, ref2], hw, act=act)
    p3 = params["refine3"]
    h = rcu_p(p3["adapt_convs"]["1"], ref31, n_blocks=2, act=act)
    return conv2d_p(p3["msf"]["convs"]["1"], h)


# -----------------------------------------------------------------------------
# full forward
# -----------------------------------------------------------------------------


def fused_forward(
    state: Mapping,
    x: torch.Tensor,
    used_sigmas,
    segment: Optional[Callable[[Params, torch.Tensor], torch.Tensor]] = None,
    act: Act = F.elu,
) -> torch.Tensor:
    """NCSNv2Deepest.forward on the parameter dictionary.

    x (B, Nt, Nr, 2) in the network's dtype (the weights are cast to it);
    returns the f32 score (B, Nt, Nr, 2) divided by sigma. segment: the 8x2
    deep segment (default `deep_segment_plain` with `act`). act: the
    activation (`models.layers.get_act`)."""
    segment = segment or functools.partial(deep_segment_plain, act=act)
    params = prepare_params(state, x.device, x.dtype)
    h = 2.0 * x.permute(0, 3, 1, 2) - 1.0  # NHWC memory == NCHW channels_last
    out = conv2d_p(params["begin_conv"], h)

    def stage(name, t, *blocks):
        for i, kw in enumerate(blocks):
            t = residual_block_p(params[name][str(i)], t, act=act, **kw)
        return t

    layer1 = stage("res1", out, {}, {})
    layer2 = stage("res2", layer1, {"resample": "down"}, {})
    layer3 = stage("res3", layer2, {"resample": "down"}, {})
    layer31_in = stage("res31", layer3, {"resample": "down"})

    msf1 = segment(params, layer31_in)  # (B, 64, 8, 2)

    # refine3 at 16x4: path 0's adapter and MSF conv; path 1 arrives
    # pre-resize from the segment
    hw3 = tuple(layer3.shape[-2:])
    p3 = params["refine3"]
    h0 = rcu_p(p3["adapt_convs"]["0"], layer3, n_blocks=2, act=act)
    h0 = conv2d_p(p3["msf"]["convs"]["0"], h0)
    h1 = resize_bilinear_align_corners(msf1, hw3)
    h = crp_p(p3["crp"], h0 + h1, act=act)
    ref3 = rcu_p(p3["output_convs"], h, n_blocks=1, act=act)

    ref4 = refine_block_p(params["refine4"], [layer2, ref3],
                          tuple(layer2.shape[-2:]), act=act)
    out = refine_block_p(params["refine5"], [layer1, ref4],
                         tuple(layer1.shape[-2:]), end=True, act=act)

    out = act_after(functools.partial(instance_norm_pp_p,
                                      params["normalizer"]), out, act)
    out = conv2d_p(params["end_conv"], out)
    return _apply_sigma_scaling(out.permute(0, 2, 3, 1), used_sigmas)
