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
`wgmma_plan`). float32 runs on the FP32 FMA units in IEEE f32 (no TF32:
the recipes train in full f32), tile plan `plan`; there the operations
bound it: >= 3.066 ms per forward at batch 256, >= 0.382 ms of dgrad per
training step at batch 32, at 67 TFLOP/s. The f32 kernel is an implicit
GEMM (pixels x output channels x live taps * input channels) built for
what held the first port's kernel back:
  - a thread keeps 8 pixels x 4 channels, so 12 16-byte shared loads
    feed 128 FMAs, from layouts free of bank conflicts (an 8 x 8 tile took
    205-211 registers and was no faster: blocks take at most 32 channels);
  - chunks of BK input channels (the halo tile and every live tap's
    weight rows) stream through a ring of 2-4 stages in dynamic shared
    memory, opted in up to 227 KB, by 16-byte cp.async (4-byte where a
    channel count is not a multiple of 4), so a chunk lands while the
    one before it is multiplied; the halo's source offsets are computed
    once a block;
  - where the output tiles are too few to fill the card, a thread-block
    cluster of CL = 2, 4 or 8 blocks splits the chunks and sums its
    partial tiles in rank order through distributed shared memory (no
    atomics: two launches give equal bits), so a batch-32 8x2 layer runs
    on 256 blocks instead of 16;
  - a block reads only its chunks of its channels' weights, once.

The kernel reads the weight in place: an (O, I, k, k) tensor laid out in
memory as (k, k, I, O), one (I, O) matrix per tap (`kernel_layout`), which
is how models/layers.py Conv2d stores its parameter. It reads the live
taps' matrices only, so no packed copy of the weight is kept that could go
stale when the parameter changes.

Wide routes: a layer with more than 128 input or output channels, or an
image wider than 128 pixels (NCSNv2-Deepest at its published FFHQ
widths), takes a wide route, up to 512 channels and rows of 256 pixels.
In bf16 that is csrc/conv2d_taps_wide.cu, tile plan `wide_plan`: the same
wgmma on a halo tile, the weight slices streamed through a ring instead of
kept resident, a wide row cut into segments of at most 128 pixels. In f32
(training at those widths, forward and input gradient) it is the FMA
implicit GEMM above with the same `plan`, on tiles of TH rows x WS =
F32_SEGMENT columns, a segment of the row (the kernel's segment instance):
the same arithmetic, K summed in the same fixed order, no atomics. Every
other shape keeps the route and plan above (WS = W).

`conv2d` dispatches on the tensor's device: a CPU tensor goes to
`conv2d_plain`; a CUDA tensor launches the kernel or raises. Both count
their calls in COUNTS; WIDE_COUNTS counts the launches of the bf16 wide
route among them, F32_WIDE_COUNTS the forwards and F32_WIDE_DGRAD_COUNTS
the input gradients of an f32 shape that `takes_wide`.

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
import dataclasses
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

COUNTS = {"launches": 0, "plain": 0}
WIDE_COUNTS = {"launches": 0}
F32_WIDE_COUNTS = {"launches": 0}        # the forwards
F32_WIDE_DGRAD_COUNTS = {"launches": 0}  # the input gradients
GRAD_COUNTS = {"functions": 0, "dgrad": 0}

MAX_CHANNELS = 128
MAX_SMEM_OPTIN = 232_448   # dynamic shared memory a block may opt in to
SMS = 132

# f32 route (FMA): must match csrc/conv2d_taps.cu
F32_TM, F32_TN = 8, 4      # output pixels x channels a thread
F32_BN = (4, 8, 16, 32)    # output channels a block
F32_MAX_THREADS = 256
F32_MAX_BM = 512           # output pixels a block
F32_BK = (16, 8, 4)        # input channels a chunk, largest first
F32_CLUSTERS = (1, 2, 4, 8)
F32_MAX_TAPS = 9           # the tap tables' length (kMaxTaps)
F32_WARPS = 1024           # the grid's warps the plan splits K to reach
TWO_BLOCKS_SMEM = 113 * 1024  # two blocks an SM (228 KB, 1 KB each reserved)
F32_SEGMENT = 16           # the wide f32 route's tile columns in a wide row

# bf16 route (wgmma): must match csrc/conv2d_taps.cu, csrc/conv_sm90.cuh
WG_ROWS = 64               # output pixels of one consumer warpgroup
MAX_WG = 2
WGMMA_N = (8, 16, 32, 64, 128)  # the N of the kernels' wgmma instances
MIN_BLOCKS = 128           # output channels are split down to 32 until
                           # there are this many (tile, channel tile) jobs

# wide bf16 route: must match csrc/conv2d_taps_wide.cu
WIDE_MAX_CHANNELS = 512
WIDE_MAX_WIDTH = 256
WIDE_SEGMENT = 128         # most columns of a tile (a TMA box is <= 256)
WIDE_WG = (4, 2)           # consumer warpgroups of a tile, preferred first
WIDE_MAX_STAGES = 8        # weight stages of the ring, at most

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


@dataclasses.dataclass(frozen=True)
class Plan:
    """One f32 launch: output tiles of SB samples x TH rows x WS columns
    (at most BM pixels) by BN channels, a thread 8 pixels x 4 channels,
    chunks of BK input channels through a ring of `stages`, each tile's
    chunks split over a cluster of CL blocks. WS = W (whole rows), or on
    the wide route a segment of a wide row (then SB = 1). x16 / w16:
    16-byte copies of x / the weight (else 4-byte). The grid is tiles[0] *
    tiles[1] * tiles[2] * CL blocks; `why` says why it falls short of the
    card's SMS, or is empty."""

    SB: int
    TH: int
    WS: int        # tile columns
    py: int        # halo rows
    px: int        # halo columns
    BM: int
    BN: int
    BK: int
    stages: int
    CL: int
    x16: bool
    w16: bool
    threads: int
    smem: int      # dynamic shared bytes
    nchunks: int   # chunks of BK input channels
    tiles: Tuple[int, int, int]  # (row tiles x segments, sample groups,
                                 #  channel tiles)
    why: str = ""

    @property
    def blocks(self) -> int:
        return self.tiles[0] * self.tiles[1] * self.tiles[2] * self.CL


def _pow2_at_least(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def f32_warp_pixels(BN: int) -> int:
    """Pixels of one warp: BN / 4 lanes along the channels, the other
    32 / (BN / 4) along the pixels, 8 pixels each."""
    return F32_TM * 32 // (BN // F32_TN)


def f32_smem(SB: int, TR: int, TW: int, T: int, BM: int, BN: int, BK: int,
             stages: int) -> int:
    """Dynamic shared bytes of the f32 kernel (csrc F32Layout): the ring of
    stages (halo [HP][BK + 4], weights [T][BK][BN]) or the partial tile
    [BM][BN + 4], whichever is larger, then HP + 2 * 9 ints of tables."""
    hp = SB * TR * TW
    ring = stages * (hp * (BK + 4) + T * BK * BN)
    floats = max(ring, BM * (BN + 4)) + hp + 2 * F32_MAX_TAPS
    return -(-floats * 4 // 16) * 16


def tile_rows(B: int, H: int, W: int, BM: int) -> Tuple[int, int]:
    """(SB, TH) of an output tile of at most BM pixels (both routes): SB
    whole images of H x W while one fits, else TH whole rows of one
    sample."""
    if H * W <= BM:
        return min(B, BM // (H * W)), H
    return 1, BM // W


def f32_config(B: int, H: int, W: int, Cin: int, Cout: int, dy, dx,
               BN: int, BM: int, BK: int, CL: int = 1,
               stages: Optional[int] = None,
               WS: Optional[int] = None) -> Optional[Plan]:
    """The f32 launch with these choices, or None where the kernel cannot
    take them: BN in F32_BN, BM a multiple of a warp's pixels holding a
    row of WS (by default W) columns, WS dividing W, at most 256 threads,
    CL <= the chunks. Tiles: SB whole images or TH whole rows where WS = W
    (`tile_rows`), else min(BM / WS, H) rows of one segment. Without
    `stages`: three where they fit the budget, else two; the budget is two
    blocks an SM where a ring of two stages allows it, else one."""
    WS = W if WS is None else WS
    if BN not in F32_BN or BK not in F32_BK or CL not in F32_CLUSTERS:
        return None
    threads = BM * BN // (F32_TM * F32_TN)
    if (BM % f32_warp_pixels(BN) or BM < WS or BM > F32_MAX_BM or WS < 1
            or W % WS or threads > F32_MAX_THREADS or -(-Cin // BK) < CL):
        return None
    T = len(dy)
    py, px = max(abs(v) for v in dy), max(abs(v) for v in dx)
    SB, TH = tile_rows(B, H, W, BM) if WS == W else (1, min(BM // WS, H))
    smem = lambda s: f32_smem(SB, TH + 2 * py, WS + 2 * px, T, BM, BN, BK, s)
    if stages is None:
        budget = (TWO_BLOCKS_SMEM if smem(2) <= TWO_BLOCKS_SMEM
                  else MAX_SMEM_OPTIN)
        stages = 3 if smem(3) <= budget else 2
    if smem(stages) > MAX_SMEM_OPTIN:
        return None
    return Plan(SB, TH, WS, py, px, BM, BN, BK, stages, CL, Cin % 4 == 0,
                Cout % 4 == 0, threads, smem(stages), -(-Cin // BK),
                (-(-H // TH) * (W // WS), -(-B // SB), -(-Cout // BN)))


def plan(B: int, H: int, W: int, Cin: int, Cout: int, dy, dx) -> Plan:
    """Tile plan of one f32 launch; raises on a shape the kernel does not
    take (1..512 channels, rows of at most 256 pixels). Tiles hold whole
    rows (WS = W) unless the shape `takes_wide`: then segments of
    F32_SEGMENT columns of a wider row. BN is the power of 2 that holds
    Cout, at most 32; BK the largest chunk (16 at most) whose ring of two
    stages leaves room for two blocks an SM, else the largest that fits.
    The block starts at 256 threads (at most 512 pixels, no more than the
    batch holds). Then, while the grid has fewer than F32_WARPS warps,
    each tile's chunks are split over a cluster twice as large (BK halved
    down to 8 where the chunks run out); and while it has fewer blocks
    than the card has SMs, the block's pixels are halved, else its chunks
    split further. These rules come from timing every configuration at
    every f32 shape of the score model at batch 256 and 32, and of the
    FFHQ model's training step at batch 16 (`kernels.conv_f32_bench
    --sweep`)."""
    if not (1 <= Cin <= WIDE_MAX_CHANNELS and 1 <= Cout <= WIDE_MAX_CHANNELS):
        raise ValueError(f"conv2d_taps: the float32 route takes "
                         f"1..{WIDE_MAX_CHANNELS} channels, got Cin={Cin} "
                         f"Cout={Cout}")
    if W > WIDE_MAX_WIDTH:
        raise ValueError(f"conv2d_taps: image width {W} is wider than "
                         f"{WIDE_MAX_WIDTH} pixels")
    if not 1 <= len(dy) <= F32_MAX_TAPS:
        raise ValueError(f"conv2d_taps takes 1..9 live taps, got {len(dy)}")
    if B * H * W * max(Cin, Cout) >= 2 ** 31:
        raise ValueError("conv2d_taps: the f32 route's 32-bit offsets cannot "
                         "address this tensor")
    WS = min(W, F32_SEGMENT) if takes_wide(W, Cin, Cout) else W
    if W % WS:
        raise ValueError(f"conv2d_taps: a {W}-pixel row does not cut into "
                         f"segments of {WS}")
    BN = min(max(_pow2_at_least(Cout), F32_BN[0]), F32_BN[-1])
    bk_top = max(F32_BK[-1], min(F32_BK[0], _pow2_at_least(Cin)))

    def first(BM, CL, bk, least=F32_BK[-1]):
        """The plan with the largest BK in [least, bk] that leaves room for
        two blocks an SM, else that fits; or None."""
        fits = [p for BK in F32_BK if least <= BK <= bk
                for p in [f32_config(B, H, W, Cin, Cout, dy, dx, BN, BM, BK,
                                     CL, WS=WS)] if p is not None]
        two = [p for p in fits if p.smem <= TWO_BLOCKS_SMEM]
        return (two or fits or [None])[0]

    def split(p):
        if 2 * p.CL > F32_CLUSTERS[-1]:
            return None
        return first(p.BM, 2 * p.CL, p.BK, min(8, bk_top))

    def halve(p):
        if p.BM // 2 < max(WS, f32_warp_pixels(BN)):
            return None
        return first(p.BM // 2, p.CL, p.BK)

    BM = min(F32_MAX_THREADS * F32_TM * F32_TN // BN, F32_MAX_BM)
    while BM > f32_warp_pixels(BN) and BM // 2 >= max(WS, B * H * W):
        BM //= 2
    if WS > BM:
        raise ValueError(f"conv2d_taps: image width {W} is wider than a "
                         f"{BM}-pixel tile")
    p = first(BM, 1, bk_top)
    if p is None:
        raise ValueError("conv2d_taps: tile does not fit in shared memory")
    while p.blocks * p.threads // 32 < F32_WARPS:
        q = split(p)
        if q is None:
            break
        p = q
    while p.blocks < SMS:
        q = halve(p) or split(p)
        if q is None:
            return dataclasses.replace(p, why=(
                f"{p.blocks} blocks: {B * H * W} pixels in tiles of "
                f"{p.SB * p.TH * p.WS}, {Cout} channels in tiles of {p.BN}, "
                f"{p.nchunks} chunks of {p.BK} input channels split "
                f"{p.CL} ways"))
        p = q
    return p


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
    return (BM, *tile_rows(B, H, W, BM))


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


class WidePlan(NamedTuple):
    SB: int        # samples per tile
    TH: int        # output rows per tile
    WS: int        # output columns per tile: W, or a segment of a wide row
    py: int        # halo rows
    px: int        # halo columns
    BN: int        # output channels per block (a wgmma N)
    KS: int        # 16-deep k-steps per input-channel chunk (1, 2 or 4)
    nwg: int       # consumer warpgroups: a tile of 64 nwg pixels
    stages: int    # weight stages of the ring
    nchunks: int   # input-channel chunks of 16 * KS
    threads: int   # the consumer warpgroups + one producer warp
    smem: int      # dynamic shared bytes
    tiles: Tuple[int, int, int]  # (row tiles x segments, sample groups,
                                 #  channel tiles)


def takes_wide(W: int, Cin: int, Cout: int) -> bool:
    """Whether a launch goes to the wide route (bf16: `wide_plan`; f32:
    `plan`'s row segments): more than MAX_CHANNELS channels, or a row
    wider than the resident bf16 route's tile."""
    return max(Cin, Cout) > MAX_CHANNELS or W > MAX_WG * WG_ROWS


def resident_is_cut(p: WgmmaPlan, Cout: int) -> bool:
    """Whether the resident plan's BN is below the one the card's
    parallelism asks for (`split_n` without its shared-memory limit):
    its resident weight slices did not fit. Such a layer (128 -> 128
    channels at 128x128 takes BN 32) goes to the wide route, which
    streams the slices at the full BN; no layer of today's 64x16 tables
    is cut."""
    BN = next(n for n in WGMMA_N if n >= min(Cout, WGMMA_N[-1]))
    while BN > 32 and p.tiles[0] * p.tiles[1] * -(-Cout // BN) < MIN_BLOCKS:
        BN //= 2
    return p.BN < BN


def wide_smem(SB: int, TR: int, TW: int, KS: int, BN: int,
              stages: int) -> int:
    """Dynamic shared bytes of the wide kernel (csrc WideLayout): two halo
    buffers of 1 KB multiples, the weight stages, the barriers, 1 KB of
    alignment."""
    hb = -(-(SB * TR * TW * 32 * KS) // 1024) * 1024
    return 2 * hb + stages * 32 * KS * BN + (4 + 2 * stages) * 8 + 1024


def wide_tile(B: int, H: int, W: int, BM: int) -> Tuple[int, int, int]:
    """(SB, TH, WS) of the wide route's output tiles of BM pixels: SB whole
    images or TH whole rows where a row holds at most WIDE_SEGMENT pixels,
    else TH rows of equal segments of at most WIDE_SEGMENT columns."""
    if W <= WIDE_SEGMENT:
        return (*tile_rows(B, H, W, BM), W)
    nseg = -(-W // WIDE_SEGMENT)
    if W % nseg:
        raise ValueError(f"conv2d_taps: a {W}-pixel row does not cut into "
                         f"{nseg} equal segments")
    return 1, max(1, BM * nseg // W), W // nseg


def wide_plan(B: int, H: int, W: int, Cin: int, Cout: int, dy, dx,
              nwg: Optional[int] = None, KS: Optional[int] = None,
              stages: Optional[int] = None) -> WidePlan:
    """Tile plan of one launch of the wide bf16 route; raises on a shape
    it does not take. BN is the smallest wgmma N that holds Cout, at most
    128 (more channels take more channel tiles); chunks of 16, 32 or 64
    input channels as `k_steps` says. Without the choices: four
    warpgroups (256-pixel tiles, so a weight stage feeds twice the
    pixels) where the ring then holds 4 stages or more and the grid still
    has MIN_BLOCKS blocks, else two; the ring holds as many stages as
    fit, up to WIDE_MAX_STAGES. (At the FFHQ model's shapes, batch 8,
    four warpgroups ran 1.25-1.44x faster than two wherever the grid kept
    128 blocks, and 1.27x slower at 64; 3 to 8 stages ran within 1%.)"""
    if not (1 <= Cin <= WIDE_MAX_CHANNELS and 1 <= Cout <= WIDE_MAX_CHANNELS):
        raise ValueError(f"conv2d_taps takes 1..{WIDE_MAX_CHANNELS} channels "
                         f"in bf16, got Cin={Cin} Cout={Cout}")
    if W > WIDE_MAX_WIDTH:
        raise ValueError(f"conv2d_taps: image width {W} is wider than "
                         f"{WIDE_MAX_WIDTH} pixels")
    if not 1 <= len(dy) <= 9:
        raise ValueError(f"conv2d_taps takes 1..9 live taps, got {len(dy)}")
    py, px = max(abs(v) for v in dy), max(abs(v) for v in dx)
    BN = next(n for n in WGMMA_N if n >= min(Cout, WGMMA_N[-1]))
    for g in (WIDE_WG if nwg is None else (nwg,)):
        SB, TH, WS = wide_tile(B, H, W, g * WG_ROWS)
        TR, TW = TH + 2 * py, WS + 2 * px
        if TR > 256 or TW > 256:
            raise ValueError("conv2d_taps: the halo tile exceeds a TMA box")
        ks = KS or k_steps(Cin)
        fits = [n for n in range(WIDE_MAX_STAGES, 1, -1)
                if wide_smem(SB, TR, TW, ks, BN, n) <= MAX_SMEM_OPTIN]
        n = stages or (fits[0] if fits else 0)
        tiles = (-(-H // TH) * (W // WS), -(-B // SB), -(-Cout // BN))
        full = n >= 4 and tiles[0] * tiles[1] * tiles[2] >= MIN_BLOCKS
        if n in fits and (full or nwg is not None or g == WIDE_WG[-1]):
            return WidePlan(SB, TH, WS, py, px, BN, ks, g, n,
                            -(-Cin // (16 * ks)), g * 128 + 32,
                            wide_smem(SB, TR, TW, ks, BN, n), tiles)
    raise ValueError("conv: tile does not fit in shared memory")


@functools.lru_cache(maxsize=None)
def _launch_args(B: int, H: int, W: int, Cin: int, Cout: int, k: int,
                 dilation: int, bf16: bool = False) -> tuple:
    """Plan (for f32 `plan`; for bf16 `wide_plan` where `takes_wide` or the
    resident plan `resident_is_cut`, else `wgmma_plan`) and ctypes tap
    arrays of one launch shape, made once."""
    taps = live_taps(k, dilation, H, W)
    dy, dx = [t[2] for t in taps], [t[3] for t in taps]
    T = len(taps)
    arr = ctypes.c_int * T
    if not bf16:
        p = plan(B, H, W, Cin, Cout, dy, dx)
    elif takes_wide(W, Cin, Cout):
        p = wide_plan(B, H, W, Cin, Cout, dy, dx)
    else:
        p = wgmma_plan(B, H, W, Cin, Cout, dy, dx)
        if resident_is_cut(p, Cout):
            p = wide_plan(B, H, W, Cin, Cout, dy, dx)
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
        g = grad.contiguous(memory_format=torch.channels_last)
        wt = transposed_weight(weight)
        if g.device.type == "cuda":
            _check_cuda(g, wt)
            dx = _launch(g, wt, None, dilation, False, dgrad=True)
        else:
            dx = conv2d(g, wt, None, dilation)
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
            bias: Optional[torch.Tensor], dilation: int, elu: bool,
            p=None, dgrad: bool = False) -> torch.Tensor:
    """The kernel on checked card tensors, launched as `p` says (by default
    the shape's plan; the card tests pass others, made with
    dataclasses.replace). `dgrad`: an input gradient (`conv2d_backward`),
    counted apart on the f32 wide route."""
    B, Cin, H, W = x.shape
    Cout, k = weight.shape[0], weight.shape[-1]
    bf16 = x.dtype == torch.bfloat16
    planned, T, dy, dx, wi = _launch_args(B, H, W, Cin, Cout, k, dilation,
                                          bf16)
    p = planned if p is None else p
    out = torch.empty((B, Cout, H, W), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    from . import _build

    lib = _build.library()
    b_ptr = bias.data_ptr() if bias is not None else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if isinstance(p, WidePlan):
        rc = lib.sbc_conv2d_taps_wide(
            x.data_ptr(), weight.data_ptr(), b_ptr,
            int(bias is not None and bias.dtype == torch.bfloat16),
            out.data_ptr(), B, H, W, Cin, Cout, k, T, dy, dx, wi, p.SB, p.TH,
            p.WS, p.py, p.px, p.BN, p.KS, p.nwg, p.stages, p.smem, int(elu),
            stream)
        WIDE_COUNTS["launches"] += 1
    elif bf16:
        rc = lib.sbc_conv2d_taps_wgmma(
            x.data_ptr(), weight.data_ptr(), b_ptr,
            int(bias is not None and bias.dtype == torch.bfloat16),
            out.data_ptr(), B, H, W, Cin, Cout, k, T, dy, dx, wi, p.SB, p.TH,
            p.py, p.px, p.BN, p.KS, p.BM // WG_ROWS, p.smem, int(elu),
            stream)
    else:
        rc = lib.sbc_conv2d_taps(
            x.data_ptr(), weight.data_ptr(), b_ptr, out.data_ptr(), B, H, W,
            Cin, Cout, T, dy, dx, wi, p.SB, p.TH, p.WS, p.py, p.px, p.BM,
            p.BN, p.BK, p.stages, p.CL, int(p.x16), int(p.w16), p.threads,
            p.smem, int(elu), stream)
        if takes_wide(W, Cin, Cout):
            (F32_WIDE_DGRAD_COUNTS if dgrad
             else F32_WIDE_COUNTS)["launches"] += 1
    _build.check("conv2d_taps", rc)
    COUNTS["launches"] += 1
    return out
