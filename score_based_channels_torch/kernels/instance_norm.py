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
3.35 TB/s). The kernel reads each activation byte once and writes each
output byte once: a large sample comes into shared memory by up to four
1-D bulk copies and leaves the same way, a small one by 16-byte loads into
registers and 16-byte stores. `plan` sizes the launch (threads, cluster,
shared bytes, copy form). Design notes are in the source.

Two-pass route (csrc/instance_norm_wide.cu, `two_pass_plan`): a sample of
more than 128 channels (up to 512, a multiple of 8), or one larger than
8 blocks' shared memory (NCSNv2-Deepest at its published FFHQ widths:
256x256x128 bf16 is 16.8 MB), is spread over many blocks: per-tile f32
partial statistics, combined in a fixed order into each channel's scale
and shift, then one fused normalise (+ ELU) pass. `launch_plan` picks it
where `plan`'s one-pass kernel cannot take the sample; every shape `plan`
takes keeps that plan.

`instance_norm_plus` dispatches on the tensor's device: a CPU tensor goes
to `instance_norm_plus_plain`; a CUDA tensor launches the kernel or raises.
Both count their calls in COUNTS; TWO_PASS_COUNTS counts the launches of
the two-pass route among them.

Gradients (training): on a CUDA tensor with grad enabled and an input that
requires grad, the launch goes through `_NormFunction`, whose backward is
`instance_norm_plus_backward`, the closed form in torch ops (the JAX
package trains through the jnp formula, with no backward kernel). Under
no_grad it launches directly. GRAD_COUNTS counts Functions and backwards.
"""

from __future__ import annotations

import dataclasses
import functools
from math import gcd

import torch
import torch.nn.functional as F

COUNTS = {"launches": 0, "plain": 0}
TWO_PASS_COUNTS = {"launches": 0}
GRAD_COUNTS = {"functions": 0, "backward": 0}

# must match csrc/instance_norm_plus.cu
MAX_CHANNELS = 128
MAX_THREADS = 512      # a block of the shared-memory route
MAX_REG_THREADS = 128  # a block of the register route
REG_VECS = 8           # 8-channel vectors a thread may hold on that route
REG_TARGET = 2         # ... and aims to hold (more threads, shorter chains)
MAX_CLUSTER = 8        # blocks of one sample (the portable cluster size)
MAX_CHUNKS = 4         # bulk copies in flight a block
MAX_SMEM = 232_448     # an H100 block's shared memory
VEC_PER_THREAD = 8     # the pixel vectors a thread aims to hold
CHUNK_BYTES = 16384    # a bulk copy's size, up to MAX_CHUNKS a block
COPIES = ("element", "bulk", "vector")  # the kernel's copy codes 0, 1, 2

# two-pass route: must match csrc/instance_norm_wide.cu
WIDE_MAX_CHANNELS = 512
STATS_THREADS = 256    # most threads of a statistics block
STATS_VECS = 8         # pixel vectors a statistics thread holds


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of the kernel: a block of `threads` threads a sample or,
    when `cluster` > 1, a cluster of `cluster` blocks a sample, each
    holding `pixels_per_block` of its pixels; each thread takes `vec`
    channels (8, or 1 when C is not a multiple of 8). `copy`: "bulk" (the
    sample comes into shared memory by `chunks` 1-D bulk copies and leaves
    the same way; needs a sample's bytes a multiple of 16), "vector" (small
    samples: 16-byte loads into registers and 16-byte stores, at most
    REG_VECS vectors a thread) or "element" (element loads and stores
    through shared memory)."""

    threads: int
    cluster: int
    pixels_per_block: int
    vec: int
    copy: str
    chunks: int
    smem: int
    blocks: int


def _pow2_at_least(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def smem_bytes(ts: int, hwc: int, C: int, vec: int, es: int,
               registers: bool = False) -> int:
    """Shared bytes of a block (csrc/instance_norm_plus.cu, Layout): the
    sample's pixels (none on the register route), ts / max(cvp, 32)
    reduction slots of C floats, five C-float arrays, alpha, gamma and
    beta in f32, and the mbarriers, 16-byte aligned."""
    r16 = lambda v: -(-v // 16) * 16
    cvp = _pow2_at_least(C // vec)
    ns = ts // max(cvp, 32)
    data = 0 if registers else r16(hwc * C * es)
    return r16(data + ns * C * 4 + 5 * C * 4 + 3 * C * 4) + 8 * MAX_CHUNKS


def _vector_plan(B, HW, C, es):
    """The register route's plan, or None where a sample needs more than
    REG_VECS vectors a thread of MAX_REG_THREADS."""
    cvp = _pow2_at_least(C // 8)
    ts = max(min(_pow2_at_least(-(-HW * C // 8 // REG_TARGET)),
                 MAX_REG_THREADS), 32, cvp)
    if -(-HW // (ts // cvp)) > REG_VECS:
        return None
    return Plan(ts, 1, HW, 8, "vector", 1,
                smem_bytes(ts, HW, C, 8, es, registers=True), B)


@functools.lru_cache(maxsize=None)
def plan(B: int, H: int, W: int, C: int, dtype: torch.dtype) -> Plan:
    """The launch of one (B, C, H, W) norm; raises on a shape the kernel
    does not take. A sample of at most REG_VECS x MAX_REG_THREADS
    8-channel vectors takes the register route; a larger one goes through
    shared memory, by bulk copies where its bytes are whole 16-byte
    pieces, in one block or the smallest cluster whose blocks fit."""
    if not 2 <= C <= MAX_CHANNELS:
        raise ValueError(f"instance_norm_plus takes 2..{MAX_CHANNELS} "
                         f"channels, got {C}")
    _check_dtype(dtype)
    p = _one_pass(B, H, W, C, dtype)
    if p is None:
        raise ValueError(f"instance_norm_plus: a {H}x{W}x{C} {dtype} sample "
                         f"does not fit {MAX_CLUSTER} blocks' shared memory")
    return p


def _check_dtype(dtype: torch.dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"instance_norm_plus takes float32 or bfloat16, got "
                        f"{dtype}")


def _one_pass(B: int, H: int, W: int, C: int, dtype: torch.dtype):
    """`plan`'s search, or None where no cluster's blocks fit."""
    HW, es = H * W, (2 if dtype == torch.bfloat16 else 4)
    vec = 8 if C % 8 == 0 else 1
    whole16 = HW * C * es % 16 == 0
    if vec == 8 and whole16:
        p = _vector_plan(B, HW, C, es)
        if p is not None:
            return p
    form = "bulk" if whole16 else "element"
    cvp = _pow2_at_least(C // vec)
    unit = 16 // gcd(16, C * es)  # pixels of a 16-byte multiple
    for cs in (1, 2, 4, MAX_CLUSTER):
        hwc = HW if cs == 1 else -(-(-(-HW // cs)) // unit) * unit
        if cs > 1 and (cs - 1) * hwc >= HW:
            continue  # a block would hold no pixel
        ts = _pow2_at_least(-(-hwc * (C // vec) // VEC_PER_THREAD))
        ts = max(min(ts, MAX_THREADS), 32, cvp)
        nch = 1
        if vec == 8 and form == "bulk":
            nch = min(MAX_CHUNKS, max(1, hwc * C * es // CHUNK_BYTES))
        smem = smem_bytes(ts, hwc, C, vec, es)
        if smem <= MAX_SMEM:
            return Plan(ts, cs, hwc, vec, form, nch, smem, B * cs)
    return None


@dataclasses.dataclass(frozen=True)
class TwoPassPlan:
    """One launch of the two-pass route: statistics blocks of `rows` pixel
    rows x C / 8 threads, each thread STATS_VECS pixels of 8 channels, so
    `tile_pixels` a block and `tiles` blocks a sample; the workspace holds
    `part_floats` tile partials (B, tiles, 2, C) and `stat_floats`
    per-channel statistics (B, 3, C)."""

    rows: int
    threads: int
    tile_pixels: int
    tiles: int
    part_floats: int
    stat_floats: int


@functools.lru_cache(maxsize=None)
def two_pass_plan(B: int, H: int, W: int, C: int,
                  dtype: torch.dtype) -> TwoPassPlan:
    """The two-pass route's launch of one (B, C, H, W) norm; raises on a
    shape it does not take (C a multiple of 8, at most WIDE_MAX_CHANNELS)."""
    if not 8 <= C <= WIDE_MAX_CHANNELS or C % 8:
        raise ValueError(f"instance_norm_plus: the two-pass route takes "
                         f"8..{WIDE_MAX_CHANNELS} channels, a multiple of 8, "
                         f"got {C}")
    _check_dtype(dtype)
    rows = STATS_THREADS // (C // 8)
    tp = rows * STATS_VECS
    tiles = -(-H * W // tp)
    return TwoPassPlan(rows, rows * C // 8, tp, tiles, B * tiles * 2 * C,
                       B * 3 * C)


@functools.lru_cache(maxsize=None)
def launch_plan(B: int, H: int, W: int, C: int, dtype: torch.dtype):
    """The launch of one norm: `plan` where its one-pass kernel takes the
    sample, else `two_pass_plan`."""
    _check_dtype(dtype)
    if 2 <= C <= MAX_CHANNELS:
        p = _one_pass(B, H, W, C, dtype)
        if p is not None:
            return p
    return two_pass_plan(B, H, W, C, dtype)


def instance_norm_plus_plain(x: torch.Tensor, alpha: torch.Tensor,
                             gamma: torch.Tensor, beta: torch.Tensor,
                             elu: bool = False) -> torch.Tensor:
    """The formula of the JAX package's models/layers.py:141-163 on
    NCHW x, in f32 (f64 for f64 x), returned in x's dtype."""
    COUNTS["plain"] += 1
    acc = torch.promote_types(x.dtype, torch.float32)
    xs = x.to(acc)
    view = (1, -1, 1, 1)
    means = xs.mean(dim=(2, 3))                               # (B, C)
    m = means.mean(dim=-1, keepdim=True)
    v = means.var(dim=-1, keepdim=True, unbiased=True)
    means_hat = (means - m) / torch.sqrt(v + 1e-5)
    mu = xs.mean(dim=(2, 3), keepdim=True)
    var = xs.var(dim=(2, 3), keepdim=True, unbiased=False)
    h = (xs - mu) / torch.sqrt(var + 1e-5)
    h = h + means_hat[:, :, None, None] * alpha.to(acc).view(view)
    out = gamma.to(acc).view(view) * h + beta.to(acc).view(view)
    if elu:
        out = F.elu(out)
    return out.to(x.dtype)


def _check_cuda(x: torch.Tensor, *params: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"instance_norm_plus takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 4 or not 2 <= x.shape[1] <= WIDE_MAX_CHANNELS:
        raise ValueError(f"instance_norm_plus takes (B, 2..{WIDE_MAX_CHANNELS}"
                         f", H, W), got {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("instance_norm_plus takes channels-last contiguous x")
    C = x.shape[1]
    for p in params:
        if (p.shape != (C,) or p.device != x.device or p.dtype != x.dtype
                or not p.is_contiguous()):
            raise ValueError("instance_norm_plus: alpha/gamma/beta must be "
                             f"contiguous ({C},) {x.dtype} on {x.device}")


def _launch(x: torch.Tensor, alpha: torch.Tensor, gamma: torch.Tensor,
            beta: torch.Tensor, elu: bool, p: Plan) -> torch.Tensor:
    """The kernel on checked card tensors, launched as `p` says."""
    from . import _build

    B, C, H, W = x.shape
    out = torch.empty_like(x, memory_format=torch.channels_last)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if isinstance(p, TwoPassPlan):
        ws = torch.empty(p.part_floats + p.stat_floats, dtype=torch.float32,
                         device=x.device)
        rc = _build.library().sbc_instance_norm_plus_two_pass(
            x.data_ptr(), alpha.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), out.data_ptr(), ws.data_ptr(),
            ws[p.part_floats:].data_ptr(), B, H * W, C, int(elu),
            int(x.dtype == torch.bfloat16), p.rows, p.tiles, stream)
        _build.check("instance_norm_plus", rc)
        COUNTS["launches"] += 1
        TWO_PASS_COUNTS["launches"] += 1
        return out
    rc = _build.library().sbc_instance_norm_plus(
        x.data_ptr(), alpha.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        out.data_ptr(), B, H * W, C, int(elu),
        int(x.dtype == torch.bfloat16), p.threads, p.cluster,
        p.pixels_per_block, p.vec, COPIES.index(p.copy), p.chunks, p.smem,
        stream)
    _build.check("instance_norm_plus", rc)
    COUNTS["launches"] += 1
    return out


def instance_norm_plus_backward(x: torch.Tensor, alpha: torch.Tensor,
                                gamma: torch.Tensor, beta: torch.Tensor,
                                out: torch.Tensor, grad: torch.Tensor,
                                elu: bool = False):
    """(dx, dalpha, dgamma, dbeta) of `instance_norm_plus` from grad_out, in
    closed form, torch ops in f32 (f64 for f64 x); `out` is the forward's
    output (read only with elu). With h the instance-normed x (biased
    variance, per sample and channel, n pixels), mh the channel means
    normalised across channels (UNBIASED variance, C channels) and gy the
    gradient at the affine output:
      dbeta = sum gy;  dgamma = sum gy (h + alpha mh);  dalpha = sum gamma mh gy
      dx = rstd (dh - mean dh - h mean(dh h)) + dmu / n,  dh = gamma gy
      dmu = rr (dmh - mean_c dmh - mh sum_c(dmh mh) / (C - 1)),
      dmh = gamma alpha sum_pixels gy
    where rstd and rr are the reciprocal roots of the two variances + 1e-5.
    """
    acc = torch.promote_types(x.dtype, torch.float32)
    xs, g = x.to(acc), grad.to(acc)
    if elu:  # d elu(y) = 1 where out > 0, else exp(y) = out + 1
        o = out.to(acc)
        g = g * torch.where(o > 0, 1.0, o + 1.0)
    B, C, H, W = x.shape
    n = H * W
    a, gm = alpha.to(acc), gamma.to(acc)
    mu = xs.mean(dim=(2, 3), keepdim=True)
    rstd = torch.rsqrt(xs.var(dim=(2, 3), keepdim=True, unbiased=False)
                       + 1e-5)
    h = (xs - mu) * rstd
    means = mu[:, :, 0, 0]                                          # (B, C)
    rr = torch.rsqrt(means.var(dim=-1, keepdim=True, unbiased=True) + 1e-5)
    mh = (means - means.mean(dim=-1, keepdim=True)) * rr
    gsum = g.sum(dim=(2, 3))                                        # (B, C)
    ghsum = (g * h).sum(dim=(2, 3))
    dbeta = gsum.sum(0)
    dgamma = (ghsum + a * mh * gsum).sum(0)
    dalpha = (gm * mh * gsum).sum(0)
    # instance-norm term: mean dh = gamma gsum / n, mean(dh h) = gamma ghsum / n
    dh_mean = (gm * gsum / n)[:, :, None, None]
    dhh_mean = (gm * ghsum / n)[:, :, None, None]
    dx = rstd * (g * gm.view(1, -1, 1, 1) - dh_mean - h * dhh_mean)
    # the cross-channel means_hat term, through each channel's mean
    dmh = gm * a * gsum
    dmu = rr * (dmh - dmh.mean(dim=-1, keepdim=True)
                - mh * (dmh * mh).sum(dim=-1, keepdim=True) / (C - 1))
    dx = dx + (dmu / n)[:, :, None, None]
    return (dx.to(x.dtype), dalpha.to(alpha.dtype), dgamma.to(gamma.dtype),
            dbeta.to(beta.dtype))


class _NormFunction(torch.autograd.Function):
    """The kernel launch with `instance_norm_plus_backward` as its
    gradient."""

    @staticmethod
    def forward(ctx, x, alpha, gamma, beta, elu, p):
        out = _launch(x, alpha, gamma, beta, elu, p)
        ctx.save_for_backward(x, alpha, gamma, beta, out)
        ctx.elu = elu
        return out

    @staticmethod
    def backward(ctx, grad):
        GRAD_COUNTS["backward"] += 1
        x, alpha, gamma, beta, out = ctx.saved_tensors
        return (*instance_norm_plus_backward(x, alpha, gamma, beta, out, grad,
                                             ctx.elu), None, None)


def instance_norm_plus(x: torch.Tensor, alpha: torch.Tensor,
                       gamma: torch.Tensor, beta: torch.Tensor,
                       elu: bool = False) -> torch.Tensor:
    """InstanceNorm++ of NCHW x (channels-last on the card). With grad
    enabled and an input that requires grad, the launch goes through
    `_NormFunction`."""
    if x.device.type == "cpu":
        return instance_norm_plus_plain(x, alpha, gamma, beta, elu)
    if x.device.type != "cuda":
        raise RuntimeError(f"instance_norm_plus: no kernel for {x.device}")
    _check_cuda(x, alpha, gamma, beta)
    B, C, H, W = x.shape
    p = launch_plan(B, H, W, C, x.dtype)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, alpha, gamma, beta)):
        GRAD_COUNTS["functions"] += 1
        return _NormFunction.apply(x, alpha, gamma, beta, elu, p)
    return _launch(x, alpha, gamma, beta, elu, p)
