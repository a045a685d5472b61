"""k x k dilated conv over the live taps (csrc/conv2d_taps.cu) and its plain
PyTorch version.

Replaces the JAX package's kernels/conv_probe.py::conv_pertap: a
stride-1 conv with "same" zero padding, computed as a sum over the LIVE
taps only (a dilated tap whose offset reaches past the whole image only
ever multiplies padding; models/layers.py Conv2d prunes it), f32
accumulation, then optional bias and ELU and one rounding to the
activation dtype.

Bound on an H100: the larger of bytes and operations, per call. One
NCSNv2-Deepest forward at batch 256 is ~203 GFLOP of convs, >= 0.21 ms on
the bf16 tensor cores; its bf16 activations, read once and written once,
take >= 0.35 ms at 3.35 TB/s, so in bf16 the bytes bound it. bf16 runs on
the tensor cores (wgmma on a TMA-loaded halo tile, tile plan
`wgmma_plan`); float32 on the FP32 FMA units (tile plan `plan`), where the
operations take >= 3 ms (design notes in the source).

The kernel reads the weight in place: an (O, I, k, k) tensor laid out in
memory as (k, k, I, O), one (I, O) matrix per tap (`kernel_layout`), which
is how models/layers.py Conv2d stores its parameter. It reads the live
taps' matrices only, so no packed copy of the weight is kept that could go
stale when the parameter changes.

`conv2d` dispatches on the tensor's device: a CPU tensor goes to
`conv2d_plain`; a CUDA tensor launches the kernel or raises. Both count
their calls in COUNTS.

Gradients (training): on a CUDA tensor with grad enabled and an input that
requires grad, `conv2d` launches through `_Conv2dFunction`, whose backward
(`conv2d_backward`) takes the input gradient (dgrad) from this same kernel
on the flipped, channel-swapped weight (`transposed_weight`), and the
weight and bias gradients from `aten.convolution_backward` over the live
taps, as the JAX package leaves them to XLA (it has no backward kernel).
Under no_grad, or when nothing requires grad, it launches directly, so
the sampler's path pays nothing for it. GRAD_COUNTS counts the Functions
built and the dgrad convs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

COUNTS = {"launches": 0, "plain": 0}
GRAD_COUNTS = {"functions": 0, "dgrad": 0}

RP, RC, CK = 4, 4, 8       # must match csrc/conv2d_taps.cu
MAX_THREADS = 256
MAX_SMEM = 48 * 1024       # static limit, no opt-in attribute needed
MAX_CHANNELS = 128

# bf16 route (wgmma): must match csrc/conv2d_taps.cu, csrc/conv_sm90.cuh
WG_ROWS = 64               # output pixels of one consumer warpgroup
MAX_WG = 2
WGMMA_N = (8, 16, 32, 64, 128)  # the N of the kernels' wgmma instances
MAX_SMEM_OPTIN = 232_448   # dynamic shared memory a block may opt in to
MIN_BLOCKS = 128           # output channels are split down to 32 until
                           # there are this many (tile, channel tile) jobs
SMS = 132

def live_taps(k: int, dilation: int, H: int, W: int) -> List[Tuple[int, int, int, int]]:
    """(iy, ix, dy, dx) of the taps that can touch real data, row-major.

    A tap with d*|iy - k//2| >= H or d*|ix - k//2| >= W only multiplies
    padding zeros and is skipped (conv_probe.py::live_taps).
    """
    c = k // 2
    return [(iy, ix, (iy - c) * dilation, (ix - c) * dilation)
            for iy in range(k) if abs((iy - c) * dilation) < H
            for ix in range(k) if abs((ix - c) * dilation) < W]


def kernel_layout(weight: torch.Tensor) -> torch.Tensor:
    """The (O, I, k, k) weight laid out in memory as (k, k, I, O)."""
    return weight.permute(2, 3, 1, 0).contiguous().permute(3, 2, 0, 1)


def has_kernel_layout(weight: torch.Tensor) -> bool:
    O, I, k, _ = weight.shape
    return weight.stride() == (1, O, k * I * O, I * O)


class Plan(NamedTuple):
    SB: int        # samples per block
    TH: int        # output rows per block
    py: int        # staged halo rows
    px: int        # staged halo columns
    threads: int
    smem: int      # dynamic shared bytes; grid (ceil(H/TH), ceil(B/SB))


def plan(B: int, H: int, W: int, Cin: int, Cout: int, dy, dx) -> Plan:
    """Tile plan of one launch; raises on a shape the kernel does not take."""
    if not (1 <= Cin <= MAX_CHANNELS and 1 <= Cout <= MAX_CHANNELS):
        raise ValueError(f"conv2d_taps takes 1..{MAX_CHANNELS} channels, got "
                         f"Cin={Cin} Cout={Cout}")
    if not 1 <= len(dy) <= 9:
        raise ValueError(f"conv2d_taps takes 1..9 live taps, got {len(dy)}")
    ncg = -(-Cout // RC)
    py, px = max(abs(v) for v in dy), max(abs(v) for v in dx)

    def items(sb, th):
        return ncg * -(-(sb * th * W) // RP)

    def smem(sb, th):
        staged = sb * (th + 2 * py) * (W + 2 * px) * (CK + 1)
        return 4 * (-(-staged // 4) * 4 + len(dy) * CK * ncg * RC)

    if items(1, H) <= MAX_THREADS:
        TH = H
        SB = 1
        while (SB < B and items(SB + 1, H) <= MAX_THREADS
               and smem(SB + 1, H) <= MAX_SMEM):
            SB += 1
    else:
        SB, TH = 1, 0
        while TH < H and items(1, TH + 1) <= MAX_THREADS:
            TH += 1
        if TH == 0:
            raise ValueError(f"conv2d_taps: image width {W} too wide for "
                             f"Cout={Cout}")
    while smem(SB, TH) > MAX_SMEM and TH > 1:
        TH = -(-TH // 2)
    if smem(SB, TH) > MAX_SMEM:
        raise ValueError("conv2d_taps: tile does not fit in shared memory")
    threads = -(-items(SB, TH) // 32) * 32
    return Plan(SB, TH, py, px, threads, smem(SB, TH))


class WgmmaPlan(NamedTuple):
    SB: int        # samples per tile
    TH: int        # output rows per tile (all W columns)
    py: int        # halo rows
    px: int        # halo columns
    BM: int        # wgmma rows per tile: 64 per consumer warpgroup
    BN: int        # output channels per block (a wgmma N)
    KS: int        # 16-deep k-steps per input-channel chunk (1, 2 or 4)
    nchunks: int   # input-channel chunks of 16 * KS
    threads: int   # consumer warpgroups + one producer warp
    smem: int      # dynamic shared bytes
    tiles: Tuple[int, int, int]  # (row tiles, sample groups, channel tiles)


def tile_geometry(B: int, H: int, W: int) -> Tuple[int, int, int]:
    """(BM, SB, TH) of the bf16 conv kernels' output tiles: SB samples x
    TH whole rows x W (at most BM pixels); two warpgroups (BM = 128) once
    the tiles still number two per SM."""
    if W > MAX_WG * WG_ROWS:
        raise ValueError(f"conv: image width {W} is wider than a "
                         f"{MAX_WG * WG_ROWS}-pixel tile")
    BM = (MAX_WG * WG_ROWS
          if B * H * W >= MAX_WG * WG_ROWS * 2 * SMS or W > WG_ROWS
          else WG_ROWS)
    if H * W <= BM:
        return BM, min(B, BM // (H * W)), H
    return BM, 1, BM // W


def k_steps(Cin: int) -> int:
    """16-deep k-steps per chunk of input channels: chunks of 16, 32 or 64."""
    return 1 if Cin <= 16 else 2 if Cin <= 32 else 4


def split_n(Cout: int, jobs_per_tile: int, smem) -> int:
    """BN: the smallest wgmma N that holds Cout, halved down to 32 while
    there are fewer than MIN_BLOCKS (tile, channel tile) jobs, and further
    while the block's shared memory smem(BN) does not fit."""
    BN = next(n for n in WGMMA_N if n >= min(Cout, WGMMA_N[-1]))
    while BN > 32 and jobs_per_tile * -(-Cout // BN) < MIN_BLOCKS:
        BN //= 2
    while BN > 8 and smem(BN) > MAX_SMEM_OPTIN:
        BN //= 2
    if smem(BN) > MAX_SMEM_OPTIN:
        raise ValueError("conv: tile does not fit in shared memory")
    return BN


def wgmma_smem(SB: int, TR: int, TW: int, KS: int, BN: int, slices: int,
               BM: int) -> int:
    """Dynamic shared bytes of the bf16 kernel (csrc TapsLayout): two halo
    buffers of 1 KB multiples, every weight slice, the staging rows, the
    barriers, 1 KB of alignment."""
    hb = -(-(SB * TR * TW * 32 * KS) // 1024) * 1024
    bar_off = 2 * hb + slices * 32 * KS * BN + BM * (BN + 8) * 2
    return bar_off + (slices + 4) * 8 + 1024


def wgmma_plan(B: int, H: int, W: int, Cin: int, Cout: int, dy,
               dx) -> WgmmaPlan:
    """Tile plan of one bf16 launch; raises on a shape the kernel does not
    take. The kernel is persistent: it launches as many blocks per channel
    tile as the card holds (at most one per tile), each keeping its weight
    slices resident over several tiles."""
    if not (1 <= Cin <= MAX_CHANNELS and 1 <= Cout <= MAX_CHANNELS):
        raise ValueError(f"conv2d_taps takes 1..{MAX_CHANNELS} channels, got "
                         f"Cin={Cin} Cout={Cout}")
    if not 1 <= len(dy) <= 9:
        raise ValueError(f"conv2d_taps takes 1..9 live taps, got {len(dy)}")
    py, px = max(abs(v) for v in dy), max(abs(v) for v in dx)
    BM, SB, TH = tile_geometry(B, H, W)
    TR, TW = TH + 2 * py, W + 2 * px
    if TR > 256 or TW > 256:
        raise ValueError("conv2d_taps: the halo tile exceeds a TMA box")
    KS = k_steps(Cin)
    nchunks = -(-Cin // (16 * KS))
    slices = len(dy) * nchunks
    tiles = (-(-H // TH), -(-B // SB))
    smem = lambda bn: wgmma_smem(SB, TR, TW, KS, bn, slices, BM)
    BN = split_n(Cout, tiles[0] * tiles[1], smem)
    return WgmmaPlan(SB, TH, py, px, BM, BN, KS, nchunks,
                     BM // WG_ROWS * 128 + 32, smem(BN),
                     (*tiles, -(-Cout // BN)))


@functools.lru_cache(maxsize=None)
def _launch_args(B: int, H: int, W: int, Cin: int, Cout: int, k: int,
                 dilation: int, bf16: bool = False) -> tuple:
    """Plan (`wgmma_plan` for bf16, else `plan`) and ctypes tap arrays of
    one launch shape, made once."""
    taps = live_taps(k, dilation, H, W)
    dy, dx = [t[2] for t in taps], [t[3] for t in taps]
    T = len(taps)
    arr = ctypes.c_int * T
    p = (wgmma_plan if bf16 else plan)(B, H, W, Cin, Cout, dy, dx)
    return (p, T, arr(*dy), arr(*dx),
            arr(*[iy * k + ix for iy, ix, _, _ in taps]))


def conv2d_plain(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor], dilation: int = 1,
                 elu: bool = False) -> torch.Tensor:
    """The plain version of `conv2d`: `pruned_conv`, counted."""
    COUNTS["plain"] += 1
    return pruned_conv(x, weight, bias, dilation, elu)


def pruned_conv(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor], dilation: int = 1,
                elu: bool = False) -> torch.Tensor:
    """F.conv2d on the pruned weight with the pruned padding
    (the JAX package's models/layers.py:86-105), f32 accumulation (f64
    for f64 x), then bias, optional ELU, one rounding to x's dtype.
    The plain version of every conv kernel of the port; counts nothing."""
    # pruning is symmetric about the centre tap, so the padding stays so
    rows, cols, pad = _live_window(weight.shape[-1], dilation, *x.shape[-2:])
    w = weight[:, :, rows, cols]
    acc = torch.promote_types(x.dtype, torch.float32)
    y = F.conv2d(x.to(acc), w.to(acc), None, padding=pad, dilation=dilation)
    if bias is not None:
        y = y + bias.to(acc).view(1, -1, 1, 1)
    if elu:
        y = F.elu(y)
    return y.to(x.dtype)


def _check_cuda(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv2d_taps takes float32 or bfloat16, got {x.dtype}")
    if weight.dtype != x.dtype or weight.device != x.device:
        raise TypeError(f"conv2d_taps: weight is {weight.dtype} on "
                        f"{weight.device}, x is {x.dtype} on {x.device}")
    if bias is not None and (bias.dtype not in (torch.float32, x.dtype)
                             or bias.device != x.device):
        raise TypeError(f"conv2d_taps: bias is {bias.dtype} on {bias.device}; "
                        f"it takes float32 or {x.dtype} on {x.device}")
    if x.dim() != 4 or weight.dim() != 4 or x.shape[1] != weight.shape[1]:
        raise ValueError(f"conv2d_taps: x {tuple(x.shape)} does not match "
                         f"weight {tuple(weight.shape)}")
    if weight.shape[-1] != weight.shape[-2] or weight.shape[-1] not in (1, 3):
        raise ValueError("conv2d_taps takes square k=1 or k=3 weights")
    if not has_kernel_layout(weight):
        raise ValueError("conv2d_taps takes the weight in kernel_layout")
    if bias is not None and (bias.shape != weight.shape[:1]
                             or not bias.is_contiguous()):
        raise ValueError("conv2d_taps takes a contiguous (Cout,) bias")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv2d_taps takes channels-last contiguous x")


def _live_window(k: int, dilation: int, H: int, W: int):
    """(rows, cols, padding) of the live taps' window of a k x k kernel:
    the slices of the weight that `pruned_conv` keeps, and its padding."""
    c = k // 2
    keep_h = [i for i in range(k) if dilation * abs(i - c) < H]
    keep_w = [i for i in range(k) if dilation * abs(i - c) < W]
    return (slice(keep_h[0], keep_h[-1] + 1), slice(keep_w[0], keep_w[-1] + 1),
            (dilation * (c - keep_h[0]), dilation * (c - keep_w[0])))


def transposed_weight(weight: torch.Tensor) -> torch.Tensor:
    """The weight of the input-gradient conv, in `kernel_layout`: spatially
    flipped, input and output channels swapped. For a stride-1 "same"
    conv with dilation d this conv of grad_out is the transposed conv, and
    its dead taps are the same (the live set is symmetric)."""
    return kernel_layout(weight.flip(2, 3).transpose(0, 1))


def conv2d_backward(x: torch.Tensor, weight: torch.Tensor, has_bias: bool,
                    dilation: int, elu: bool, out: Optional[torch.Tensor],
                    grad: torch.Tensor, needs=(True, True, True)):
    """(dx, dweight, dbias) of `conv2d` from grad_out; `out` is the forward's
    output (read only with elu). `needs` says which of the three to
    compute. dx goes through `conv2d` on the transposed weight (the kernel
    on the card); dweight and dbias through aten.convolution_backward over
    the live taps, so a dead tap gets exactly zero gradient."""
    if elu:  # d elu(y) = 1 where out > 0, else exp(y) = out + 1
        grad = grad * torch.where(out > 0, 1.0, out + 1.0).to(grad.dtype)
    dx = dw = db = None
    if needs[0]:
        GRAD_COUNTS["dgrad"] += 1
        dx = conv2d(grad.contiguous(memory_format=torch.channels_last),
                    transposed_weight(weight), None, dilation)
    if needs[1] or (has_bias and needs[2]):
        rows, cols, pad = _live_window(weight.shape[-1], dilation,
                                       *x.shape[-2:])
        _, dwp, db = torch.ops.aten.convolution_backward(
            grad, x, weight[:, :, rows, cols],
            [weight.shape[0]] if has_bias else None, [1, 1], list(pad),
            [dilation, dilation], False, [0, 0], 1,
            [False, bool(needs[1]), bool(has_bias and needs[2])])
        if needs[1]:
            dw = torch.zeros_like(weight)
            dw[:, :, rows, cols] = dwp
    return dx, dw, db


class _Conv2dFunction(torch.autograd.Function):
    """The kernel launch with `conv2d_backward` as its gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, dilation, elu):
        out = _launch(x, weight, bias, dilation, elu)
        ctx.save_for_backward(x, weight, out if elu else None)
        ctx.dilation, ctx.elu = dilation, elu
        ctx.bias_dtype = None if bias is None else bias.dtype
        return out

    @staticmethod
    def backward(ctx, grad):
        x, weight, out = ctx.saved_tensors
        dx, dw, db = conv2d_backward(
            x, weight, ctx.bias_dtype is not None, ctx.dilation, ctx.elu, out,
            grad, ctx.needs_input_grad[:3])
        if db is not None:
            db = db.to(ctx.bias_dtype)
        return dx, dw, db, None, None


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, dilation: int = 1,
           elu: bool = False) -> torch.Tensor:
    """Conv of NCHW x (channels-last on the card) with (O, I, k, k) weight.

    On the card the weight is in `kernel_layout` with x's dtype, and the
    bias is float32 or x's dtype. With grad enabled and an input that
    requires grad, the launch goes through `_Conv2dFunction`.
    """
    if x.device.type == "cpu":
        return conv2d_plain(x, weight, bias, dilation, elu)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv2d_taps: no kernel for device {x.device}")
    _check_cuda(x, weight, bias)
    if torch.is_grad_enabled() and (
            x.requires_grad or weight.requires_grad
            or (bias is not None and bias.requires_grad)):
        GRAD_COUNTS["functions"] += 1
        return _Conv2dFunction.apply(x, weight, bias, dilation, elu)
    return _launch(x, weight, bias, dilation, elu)


def _launch(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor], dilation: int,
            elu: bool) -> torch.Tensor:
    """The kernel on checked card tensors."""
    B, Cin, H, W = x.shape
    Cout, k = weight.shape[0], weight.shape[-1]
    bf16 = x.dtype == torch.bfloat16
    p, T, dy, dx, wi = _launch_args(B, H, W, Cin, Cout, k, dilation, bf16)
    out = torch.empty((B, Cout, H, W), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    from . import _build

    lib = _build.library()
    b_ptr = bias.data_ptr() if bias is not None else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if bf16:
        rc = lib.sbc_conv2d_taps_wgmma(
            x.data_ptr(), weight.data_ptr(), b_ptr,
            int(bias is not None and bias.dtype == torch.bfloat16),
            out.data_ptr(), B, H, W, Cin, Cout, k, T, dy, dx, wi, p.SB, p.TH,
            p.py, p.px, p.BN, p.KS, p.BM // WG_ROWS, p.smem, int(elu),
            stream)
    else:
        rc = lib.sbc_conv2d_taps(
            x.data_ptr(), weight.data_ptr(), b_ptr, out.data_ptr(), B, H, W,
            Cin, Cout, T, dy, dx, wi, p.SB, p.TH, p.py, p.px, p.threads,
            p.smem, int(elu), stream)
    _build.check("conv2d_taps", rc)
    COUNTS["launches"] += 1
    return out
