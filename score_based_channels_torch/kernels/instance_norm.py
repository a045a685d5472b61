"""InstanceNorm++ with an optional fused ELU (csrc/instance_norm_plus.cu) and
its plain PyTorch version.

Replaces the JAX package's kernels/instance_norm.py::
instance_norm_plus_pallas. Per sample: per-channel spatial mean and biased
variance; mean and UNBIASED variance of the channel means;
gamma*((x - mu)/sqrt(var + 1e-5) + alpha*m_hat) + beta; optional ELU.
Statistics in f32; input, output and alpha/gamma/beta in the activation
dtype.

Bound on an H100: bytes, one read and one write of the activation (~335 MB
for the 25 norms of one forward at batch 256 in bf16, ~0.1 ms at
3.35 TB/s). Design notes are in the source.

`instance_norm_plus` dispatches on the tensor's device: a CPU tensor goes
to `instance_norm_plus_plain`; a CUDA tensor launches the kernel or raises.
Both count their calls in COUNTS.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

COUNTS = {"launches": 0, "plain": 0}

MAX_CHANNELS = 128  # must match csrc/instance_norm_plus.cu


def instance_norm_plus_plain(x: torch.Tensor, alpha: torch.Tensor,
                             gamma: torch.Tensor, beta: torch.Tensor,
                             elu: bool = False) -> torch.Tensor:
    """The formula of the JAX package's models/layers.py:141-163 on
    NCHW x, in f32, returned in x's dtype."""
    COUNTS["plain"] += 1
    xs = x.float()
    view = (1, -1, 1, 1)
    means = xs.mean(dim=(2, 3))                               # (B, C)
    m = means.mean(dim=-1, keepdim=True)
    v = means.var(dim=-1, keepdim=True, unbiased=True)
    means_hat = (means - m) / torch.sqrt(v + 1e-5)
    mu = xs.mean(dim=(2, 3), keepdim=True)
    var = xs.var(dim=(2, 3), keepdim=True, unbiased=False)
    h = (xs - mu) / torch.sqrt(var + 1e-5)
    h = h + means_hat[:, :, None, None] * alpha.float().view(view)
    out = gamma.float().view(view) * h + beta.float().view(view)
    if elu:
        out = F.elu(out)
    return out.to(x.dtype)


def _check_cuda(x: torch.Tensor, *params: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"instance_norm_plus takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 4 or not 2 <= x.shape[1] <= MAX_CHANNELS:
        raise ValueError(f"instance_norm_plus takes (B, 2..{MAX_CHANNELS}, H, "
                         f"W), got {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("instance_norm_plus takes channels-last contiguous x")
    C = x.shape[1]
    for p in params:
        if (p.shape != (C,) or p.device != x.device or p.dtype != x.dtype
                or not p.is_contiguous()):
            raise ValueError("instance_norm_plus: alpha/gamma/beta must be "
                             f"contiguous ({C},) {x.dtype} on {x.device}")


def instance_norm_plus(x: torch.Tensor, alpha: torch.Tensor,
                       gamma: torch.Tensor, beta: torch.Tensor,
                       elu: bool = False) -> torch.Tensor:
    """InstanceNorm++ of NCHW x (channels-last on the card)."""
    if x.device.type == "cpu":
        return instance_norm_plus_plain(x, alpha, gamma, beta, elu)
    if x.device.type != "cuda":
        raise RuntimeError(f"instance_norm_plus: no kernel for {x.device}")
    _check_cuda(x, alpha, gamma, beta)
    B, C, H, W = x.shape
    out = torch.empty_like(x, memory_format=torch.channels_last)
    from . import _build

    rc = _build.library().sbc_instance_norm_plus(
        x.data_ptr(), alpha.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        out.data_ptr(), B, H * W, C, int(elu),
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("instance_norm_plus", rc)
    COUNTS["launches"] += 1
    return out
