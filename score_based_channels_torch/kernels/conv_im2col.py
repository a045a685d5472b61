"""k x k dilated conv as one implicit GEMM over the live taps
(csrc/conv_im2col.cu) and its plain PyTorch version.

Replaces the JAX package's kernels/conv_probe.py::conv_im2col: the same
function as `conv.conv2d` (stride 1, "same" zero padding, dead dilated taps
skipped, f32 accumulation, optional bias and ELU, one rounding to x's
dtype), computed as an (M = B*H*W, K = T*Cin) x (K, Cout) product whose
patch is built in K-chunks of packed (tap, channel) columns in shared
memory: on the bf16 tensor cores (wgmma) when x is bf16, whatever the
channel counts, else on the FP32 FMA units (`route`; tiles from `plan`).
Design notes and the bound are in the source.

Two entry points share the kernel, which takes the (batch, row, column)
strides of x and out with the channel innermost:

  conv_im2col(x, w, b, H, W, dilation, act)   the JAX signature and layout:
      x (S = H*W, B, Cin), w (k, k, Cin, Cout), b (Cout,) or None
  conv2d_im2col(x, weight, bias, dilation, elu)   `conv.conv2d`'s contract:
      NCHW x in channels_last, the (Cout, Cin, k, k) weight in
      `conv.kernel_layout`

The bias is float32 (as the JAX harness passes it) or x's dtype. Each entry
point dispatches on the tensor's device: a CPU tensor goes to its plain
version; a CUDA tensor launches the kernel or raises. Both count their
calls in COUNTS.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import conv

COUNTS = {"launches": 0, "plain": 0}

FMA, WGMMA = 0, 1  # routes: FP32 FMA units, bf16 tensor cores
# bf16 route, must match csrc/conv_im2col.cu
RING = 4                   # patch stages in flight


class Plan(NamedTuple):
    route: int
    BN: int                # output channels per block
    BM: int                # output pixels per tile (block on the FMA route)
    SB: int                # wgmma: samples per tile
    TH: int                # wgmma: output rows per tile (all W columns)
    KS: int                # wgmma: 16-deep k-steps per TMA box of channels
    stages: int            # wgmma: patch stages in the ring
    smem: int              # dynamic shared bytes (0: static only)
    grid: Tuple[int, int]  # (tiles, channel tiles); FMA: the launch grid


def route(dtype: torch.dtype) -> int:
    """The bf16 tensor cores for bf16 x, else the FP32 FMA units."""
    return WGMMA if dtype == torch.bfloat16 else FMA


def layout_bytes(BM: int, RB: int, BN: int, slices: int,
                 stages: int) -> int:
    """Dynamic shared bytes of the wgmma kernel (csrc Im2colLayout): the
    patch ring, every weight slice, the staging rows, the barriers, 1 KB of
    alignment."""
    bar_off = stages * BM * RB + slices * RB * BN + BM * (BN + 8) * 2
    return bar_off + (2 * stages + slices) * 8 + 1024


def plan(B: int, H: int, W: int, Cin: int, Cout: int, T: int,
         dtype: torch.dtype) -> Plan:
    """Tiles of one launch with T live taps. wgmma: the output tiles of
    conv.tile_geometry and BN from conv.split_n; its shared memory holds
    either stage form (TMA boxes of 16 KS channels of one tap when
    Cin % 8 == 0, else 64 packed columns). FMA: 128 x 32 tiles for
    Cout <= 32, else 64 x 64."""
    if route(dtype) == WGMMA:
        BM, SB, TH = conv.tile_geometry(B, H, W)
        KS = conv.k_steps(Cin)
        forms = [(128, -(-(T * Cin) // 64))]  # packed: 64 columns a stage
        if Cin % 8 == 0:
            forms.append((32 * KS, T * -(-Cin // (16 * KS))))
        smem = lambda bn: max(layout_bytes(BM, rb, bn, n, RING)
                              for rb, n in forms)
        tiles = -(-H // TH) * -(-B // SB)
        BN = conv.split_n(Cout, tiles, smem)
        return Plan(WGMMA, BN, BM, SB, TH, KS, RING, smem(BN),
                    (tiles, -(-Cout // BN)))
    bn = 32 if Cout <= 32 else 64
    bm = 256 * 16 // bn
    return Plan(FMA, bn, bm, 0, 0, 0, 0, 0,
                (-(-(B * H * W) // bm), -(-Cout // bn)))


def sbc_as_nchw(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(S = H*W, B, C) viewed as a (B, C, H, W) tensor, no copy."""
    S, B, C = x.shape
    if S != H * W:
        raise ValueError(f"S = {S} is not H*W = {H}*{W}")
    return x.view(H, W, B, C).permute(2, 3, 0, 1)


def nchw_as_sbc(y: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (S = H*W, B, C), contiguous."""
    B, C, H, W = y.shape
    return y.permute(2, 3, 0, 1).reshape(H * W, B, C)


def conv_im2col_plain(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor], H: int, W: int,
                      dilation: int = 1, act: bool = False) -> torch.Tensor:
    """The plain version of `conv_im2col` on the (S, B, C) layout."""
    COUNTS["plain"] += 1
    y = conv.pruned_conv(sbc_as_nchw(x, H, W), w.permute(3, 2, 0, 1), b,
                         dilation, act)
    return nchw_as_sbc(y)


def conv2d_im2col_plain(x: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        dilation: int = 1, elu: bool = False) -> torch.Tensor:
    """The plain version of `conv2d_im2col` (NCHW, channels_last out)."""
    COUNTS["plain"] += 1
    return conv.pruned_conv(x, weight, bias, dilation, elu).contiguous(
        memory_format=torch.channels_last)


@functools.lru_cache(maxsize=None)
def _taps(k: int, dilation: int, H: int, W: int) -> tuple:
    """ctypes tap arrays (dy, dx, wi) of one shape, made once."""
    taps = conv.live_taps(k, dilation, H, W)
    arr = ctypes.c_int * len(taps)
    return (len(taps), arr(*[t[2] for t in taps]), arr(*[t[3] for t in taps]),
            arr(*[iy * k + ix for iy, ix, _, _ in taps]))


def _vec(t: torch.Tensor, *strides: int) -> int:
    """1 when t's data and the given strides allow four-wide accesses."""
    return int(t.data_ptr() % (4 * t.element_size()) == 0
               and all(s % 4 == 0 for s in strides))


def _aligned(t: torch.Tensor, nbytes: int, strides=()) -> bool:
    """t's data and the given element strides are nbytes-aligned."""
    n = nbytes // t.element_size()
    return t.data_ptr() % nbytes == 0 and all(s % n == 0 for s in strides)


def _check_cuda(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor]) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv_im2col takes float32 or bfloat16, got {x.dtype}")
    if weight.dtype != x.dtype or weight.device != x.device:
        raise TypeError(f"conv_im2col: weight is {weight.dtype} on "
                        f"{weight.device}, x is {x.dtype} on {x.device}")
    if bias is not None and (bias.dtype not in (torch.float32, x.dtype)
                             or bias.device != x.device):
        raise TypeError(f"conv_im2col: bias is {bias.dtype} on {bias.device}; "
                        f"it takes float32 or {x.dtype} on {x.device}")
    if x.dim() != 4 or weight.dim() != 4 or x.shape[1] != weight.shape[1]:
        raise ValueError(f"conv_im2col: x {tuple(x.shape)} does not match "
                         f"weight {tuple(weight.shape)}")
    k = weight.shape[-1]
    if weight.shape[-2] != k or k not in (1, 3):
        raise ValueError("conv_im2col takes square k=1 or k=3 weights")
    if not conv.has_kernel_layout(weight):
        raise ValueError("conv_im2col takes the weight in (k, k, Cin, Cout) "
                         "memory (conv.kernel_layout)")
    if bias is not None and (bias.shape != weight.shape[:1]
                             or not bias.is_contiguous()):
        raise ValueError("conv_im2col takes a contiguous (Cout,) bias")
    if x.stride(1) != 1 and x.shape[1] > 1:
        raise ValueError("conv_im2col takes x with the channel innermost")


def _launch(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor], dilation: int, elu: bool,
            out: torch.Tensor) -> None:
    """One launch on (B, C, H, W) views of x and out whose channel stride
    is 1; the weight in kernel_layout."""
    _check_cuda(x, weight, bias)
    B, Cin, H, W = x.shape
    Cout, k = weight.shape[0], weight.shape[-1]
    T, dy, dx, wi = _taps(k, dilation, H, W)
    xs = (x.stride(0), x.stride(2), x.stride(3))
    os_ = (out.stride(0), out.stride(2), out.stride(3))
    p = plan(B, H, W, Cin, Cout, T, x.dtype)
    if p.route == WGMMA:  # the copy forms are chosen by the C side
        vecs = (0, 0, int(Cout % 8 == 0 and _aligned(out, 16, os_)))
    else:
        vecs = (int(Cin % 4 == 0) & _vec(x, *xs),
                int(Cout % 4 == 0) & _vec(weight),
                int(Cout % 4 == 0) & _vec(out, *os_))
    from . import _build

    rc = _build.library().sbc_conv_im2col(
        x.data_ptr(), weight.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        B, H, W, Cin, Cout, *xs, *os_, T, dy, dx, wi, k, p.route, p.BN,
        int(elu), int(x.dtype == torch.bfloat16),
        int(bias is not None and bias.dtype == torch.bfloat16), *vecs,
        p.SB, p.TH, p.KS, p.BM // conv.WG_ROWS, p.stages, p.smem,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("conv_im2col", rc)
    COUNTS["launches"] += 1


def _on_cpu(x: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version); raises for a device with no
    kernel."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise RuntimeError(f"conv_im2col: no kernel for device {x.device}")
    return False


def conv_im2col(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                H: int, W: int, dilation: int = 1,
                act: bool = False) -> torch.Tensor:
    """Conv of x (S = H*W, B, Cin) with w (k, k, Cin, Cout) -> (S, B, Cout)."""
    if _on_cpu(x):
        return conv_im2col_plain(x, w, b, H, W, dilation, act)
    if w.dim() != 4 or not w.is_contiguous():
        raise ValueError("conv_im2col takes a contiguous (k, k, Cin, Cout) w")
    S, B, _ = x.shape
    out = torch.empty((S, B, w.shape[-1]), dtype=x.dtype, device=x.device)
    _launch(sbc_as_nchw(x, H, W), w.permute(3, 2, 0, 1), b, dilation, act,
            sbc_as_nchw(out, H, W))
    return out


def conv2d_im2col(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, dilation: int = 1,
                  elu: bool = False) -> torch.Tensor:
    """Conv of NCHW x (channel innermost on the card) with the (O, I, k, k)
    weight in kernel_layout -> NCHW in channels_last."""
    if _on_cpu(x):
        return conv2d_im2col_plain(x, weight, bias, dilation, elu)
    B, _, H, W = x.shape
    out = torch.empty((B, weight.shape[0], H, W), dtype=x.dtype,
                      device=x.device, memory_format=torch.channels_last)
    _launch(x, weight, bias, dilation, elu, out)
    return out
