"""n chained (conv -> + bias -> ELU) steps in one launch
(csrc/conv_chain.cu) and its plain PyTorch version.

Replaces the JAX package's kernels/conv_probe.py::conv_chain: x (S = H*W,
B, C), ws (n, k, k, C, C), bs (n, C); each step is the conv of
`conv.conv2d` with C input and C output channels (dead dilated taps
skipped, f32 accumulation), + bias, ELU, and a rounding to x's dtype, as
conv_probe.py:194-197 does. The kernel keeps each block's samples in shared
memory across all n steps and streams the weights through it, on the bf16
tensor cores (mma.sync) when x is bf16 and C a multiple of 16, else on the
FP32 FMA units (`plan` picks the route). On the tensor-core route the
blocks run in thread-block clusters that share one weight stream: each
tap is fetched from L2 once a cluster and multicast to its blocks by 1-D
bulk copies. Design notes, the choice of samples per block and the bound
are in the source.

The bias is float32 (as the JAX harness passes it) or x's dtype.
`conv_chain` dispatches on the tensor's device: a CPU tensor goes to
`conv_chain_plain`; a CUDA tensor launches the kernel or raises. Both count
their calls in COUNTS.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import conv
from .conv_im2col import nchw_as_sbc, sbc_as_nchw

COUNTS = {"launches": 0, "plain": 0}

TM, TN, PF = 4, 4, 16      # FMA route; must match csrc/conv_chain.cu
STAGES = 4                 # MMA route: weight ring slots (kStages)
MAX_CHANNELS = 128
MAX_THREADS = 1024
MAX_SMEM = 227 * 1024      # dynamic shared memory a block can opt in to
BLOCKS = 128               # grid the plan aims at (132 SMs on an H100)
CLUSTER = 2                # MMA route: blocks sharing one weight stream,
                           # the fastest on an H100 at batch 256 (PERF.md)
CLUSTERS = (1, 2, 4, 8)    # ... up to the portable cluster size
FMA, MMA = 0, 1            # routes: FP32 FMA units, bf16 tensor cores


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: ceil(B / SB) blocks of `threads` threads, each holding
    SB samples in `smem` bytes of shared memory; on the MMA route in
    clusters of `cluster` blocks (the grid rounded up to a multiple of it),
    which share one weight stream."""

    route: int     # MMA for bf16 with C % 16 == 0, else FMA
    SB: int        # samples per block
    CK: int        # FMA route: input channels per streamed weight chunk
    threads: int
    smem: int      # dynamic shared bytes, the MMA route's mbarriers included
    cluster: int   # MMA route: CL, in CLUSTERS; 1 on the FMA route


def grid(B: int, p: Plan) -> int:
    """Blocks of a launch: ceil(B / SB), a multiple of the cluster."""
    blocks = -(-B // p.SB)
    return -(-blocks // p.cluster) * p.cluster


def plan(B: int, H: int, W: int, C: int,
         dtype: torch.dtype = torch.float32) -> Plan:
    """Launch plan; raises on a shape the kernel does not take.

    SB = B // 128 samples per block (at least 1): at batch 256 that is 2,
    128 blocks for the H100's 132 SMs; the plan lowers SB while the block
    does not fit. The MMA route's blocks run in clusters of CLUSTER, or of
    the largest power of two up to the number of blocks when that is
    fewer, each cluster reading the chain's weights once from L2."""
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"conv_chain takes 1..{MAX_CHANNELS} channels, got "
                         f"C={C}")
    S = H * W
    route = MMA if dtype == torch.bfloat16 and C % 16 == 0 else FMA

    def fit(sb):
        if route == MMA:  # warps of 16 pixels x 32 channels, bf16 buffers
            mpad = -(-(sb * S) // 16) * 16
            threads = mpad // 16 * -(-C // 32) * 32
            smem = 2 * (2 * (mpad + 1) + STAGES * C) * (C + 8) + 16 * STAGES
            blocks, cl = -(-B // sb), CLUSTER
            while cl > blocks:
                cl //= 2
            return Plan(route, sb, 0, threads, smem, cl)
        cp = -(-C // TN) * TN
        items = -(-(sb * S) // TM) * (cp // TN)  # 4 x 4 output tiles
        threads = -(-items // 32) * 32
        ck = min(C, PF * threads // cp)
        acts = 2 * C * (sb * S + 1)              # two buffers + zero rows
        smem = 4 * (-(-acts // 4) * 4 + ck * cp)
        return Plan(route, sb, ck, threads, smem, 1)

    p = fit(max(1, B // BLOCKS))
    while p.SB > 1 and (p.threads > MAX_THREADS or p.smem > MAX_SMEM):
        p = fit(p.SB - 1)
    if p.threads > MAX_THREADS or p.smem > MAX_SMEM or (
            p.route == FMA and p.CK < 1):
        raise ValueError(f"conv_chain: a {H}x{W} sample with C={C} does not "
                         "fit one block")
    return p


@functools.lru_cache(maxsize=None)
def _plan(B: int, H: int, W: int, C: int, dtype: torch.dtype) -> Plan:
    return plan(B, H, W, C, dtype)


@functools.lru_cache(maxsize=None)
def _taps(k: int, dilation: int, H: int, W: int) -> tuple:
    """The live taps as ctypes arrays (count, dy, dx, weight tap), made
    once a shape."""
    taps = conv.live_taps(k, dilation, H, W)
    arr = ctypes.c_int * len(taps)
    return (len(taps), arr(*[t[2] for t in taps]),
            arr(*[t[3] for t in taps]),
            arr(*[iy * k + ix for iy, ix, _, _ in taps]))


def max_clusters(p: Plan) -> int:
    """cudaOccupancyMaxActiveClusters of an MMA plan: the clusters of
    p.cluster blocks that the card holds at once."""
    from . import _build

    out = ctypes.c_int(0)
    _build.check("conv_chain", _build.library().sbc_conv_chain_max_clusters(
        p.threads, p.smem, p.cluster, ctypes.byref(out)))
    return out.value


def conv_chain_plain(x: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor,
                     H: int, W: int, dilation: int = 1) -> torch.Tensor:
    """n unrolled plain convs with ELU, rounding to x's dtype after each."""
    COUNTS["plain"] += 1
    y = sbc_as_nchw(x, H, W)
    for i in range(ws.shape[0]):
        y = conv.pruned_conv(y, ws[i].permute(3, 2, 0, 1), bs[i], dilation,
                             elu=True)
    return nchw_as_sbc(y)


def _check_cuda(x: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor,
                H: int, W: int) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv_chain takes float32 or bfloat16, got {x.dtype}")
    if ws.dtype != x.dtype or ws.device != x.device:
        raise TypeError(f"conv_chain: ws is {ws.dtype} on {ws.device}, x is "
                        f"{x.dtype} on {x.device}")
    if bs.dtype not in (torch.float32, x.dtype) or bs.device != x.device:
        raise TypeError(f"conv_chain: bs is {bs.dtype} on {bs.device}; it "
                        f"takes float32 or {x.dtype} on {x.device}")
    if x.dim() != 3 or x.shape[0] != H * W:
        raise ValueError(f"conv_chain takes x (H*W, B, C), got "
                         f"{tuple(x.shape)} for {H}x{W}")
    n, k, C = ws.shape[0], ws.shape[1], x.shape[2]
    if (ws.dim() != 5 or n < 1 or ws.shape[1:] != (k, k, C, C)
            or k not in (1, 3) or not ws.is_contiguous()):
        raise ValueError(f"conv_chain takes contiguous ws (n, k, k, C, C) with "
                         f"k 1 or 3 and C={C}, got {tuple(ws.shape)}")
    if bs.shape != (n, C) or not bs.is_contiguous():
        raise ValueError(f"conv_chain takes a contiguous bs ({n}, {C})")
    if x.stride(2) != 1 and C > 1:
        raise ValueError("conv_chain takes x with the channel innermost")


def _launch(x: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor, H: int,
            W: int, dilation: int, p: Plan) -> torch.Tensor:
    """The kernel on checked card tensors, launched as `p` says; a launch
    the card refuses (a cluster it cannot place) raises."""
    S, B, C = x.shape
    n, k = ws.shape[0], ws.shape[1]
    T, dy, dx, wi = _taps(k, dilation, H, W)
    out = torch.empty((S, B, C), dtype=x.dtype, device=x.device)
    xv, ov = sbc_as_nchw(x, H, W), sbc_as_nchw(out, H, W)
    if p.route == MMA and (
            any(t.data_ptr() % 16 for t in (x, ws))
            or any(xv.stride(i) % 8 for i in (0, 2, 3))):
        raise ValueError("conv_chain takes bf16 x and ws 16-byte aligned, "
                         "with strides of whole 8-channel groups")
    from . import _build

    rc = _build.library().sbc_conv_chain(
        x.data_ptr(), ws.data_ptr(), bs.data_ptr(), out.data_ptr(), n, B, H,
        W, C, k, xv.stride(0), xv.stride(2), xv.stride(3), ov.stride(0),
        ov.stride(2), ov.stride(3), T, dy, dx, wi, p.route, grid(B, p), p.SB,
        p.cluster, p.CK, p.threads, p.smem, int(x.dtype == torch.bfloat16),
        int(bs.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("conv_chain", rc)
    COUNTS["launches"] += 1
    return out


def conv_chain(x: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor,
               H: int, W: int, dilation: int = 1) -> torch.Tensor:
    """n x (conv -> + bias -> ELU) of x (H*W, B, C) -> (H*W, B, C)."""
    if x.device.type == "cpu":
        return conv_chain_plain(x, ws, bs, H, W, dilation)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv_chain: no kernel for device {x.device}")
    _check_cuda(x, ws, bs, H, W)
    S, B, C = x.shape
    return _launch(x, ws, bs, H, W, dilation, _plan(B, H, W, C, x.dtype))
