"""5x5 stride-1 max pooling with padding 2 of channels-last activations
(csrc/max_pool5.cu): the CRP blocks' pools where autograd records nothing.

Replaces no Pallas kernel: the JAX package pools with its framework's
max_pool (XLA's reduce_window).
PyTorch's own channels-last pool ran at 3-6% of its bytes bound and took a
fifth of a bf16 sampler sweep (it visits all 25 taps of every output and
writes int64 argmax indices that no caller under no_grad reads).

Bound on an H100: bytes, one read and one write of the activation (the 12
pools of a 64x16 forward at batch 256 in bf16 move 101 MB, 0.030 ms at
3.35 TB/s; an FFHQ forward at batch 8 805 MB, 0.24 ms). The kernel copies a
block's band of rows and its 2-pixel halo into shared memory once, takes
each row's 5-wide maximum there and the 5-tall one in registers while a
thread walks down its rows, and stores by 16-byte writes. `launch_plan`
sizes the block from (B, H, W, C, dtype). Design notes are in the source.

`max_pool_5x5` dispatches on what the input shows:
- a CUDA tensor for which autograd records nothing (grad disabled, or an
  input that does not require it: every sampler) launches the kernel, or
  raises where the kernel cannot take it (not channels-last contiguous,
  another dtype, channels not whole 16-byte vectors);
- a CUDA tensor that autograd needs keeps `F.max_pool2d`, whose indices
  give the gradient (DSM and data-parallel training): the backward stays
  the library's, with its choice among tied inputs;
- a CPU tensor goes to `max_pool_5x5_plain`, `F.max_pool2d` itself.
COUNTS counts the three: "launches", "autograd", "plain". Like the other
counts, "autograd" and "plain" count calls the wrappers see; a replayed
CUDA graph adds only its recorded launches (`kernels.add_launches`).

The kernel's output equals `F.max_pool2d`'s bit for bit, up to the sign of
a zero where +0 and -0 tie and the bits of a NaN (a window with a NaN gives
NaN in both: the canonical NaN here, the input's there).

`POOLS` holds the pool shapes of one forward of NCSNv2-Deepest at ngf 32
(64x16) and ngf 128 (256x256); `pool_bench.per_forward` times the kernel
and `library` there on the card.
"""

from __future__ import annotations

import dataclasses
import functools
from math import gcd

import torch
import torch.nn.functional as F

COUNTS = {"launches": 0, "plain": 0, "autograd": 0}

# must match csrc/max_pool5.cu
MAX_THREADS = 512
MAX_SMEM = 232_448     # an H100 block's shared memory
# the plan's aims, from a sweep of 5-72 plans a shape at both models' pool
# shapes on an H100 (kernel time summed over a forward within 5% of each
# shape's best plan)
GROUP = 8              # 16-byte vectors of a pixel a block takes at most
THREADS = 128          # a block's threads
ROWS = 16              # output rows a thread walks at most
MIN_THREADS = 32_768   # a launch with fewer threads walks fewer rows each


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: blocks of `vg` 16-byte vectors (of a pixel's `vectors`)
    x `tw` columns x `sub` sub-bands of `rows` rows each, `threads` a
    block, one thread a (vector, column, sub-band); `smem` bytes hold the
    largest block's tile, its band's in-image rows and columns with their
    2-pixel halo; `bands` x `col_blocks` x `groups` blocks a sample."""

    vectors: int
    vg: int
    tw: int
    sub: int
    rows: int
    threads: int
    smem: int
    bands: int
    col_blocks: int
    groups: int
    blocks: int


def _pow2_at_most(v: int) -> int:
    p = 1
    while p * 2 <= v:
        p *= 2
    return p


def _check_dtype(dtype: torch.dtype) -> int:
    """The element size of a dtype the kernel takes; raises on another."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"max_pool_5x5 takes float32 or bfloat16, got {dtype}")
    return 2 if dtype == torch.bfloat16 else 4


def tile_bytes(H: int, W: int, vg: int, tw: int, th: int) -> int:
    """Shared bytes of the largest block's tile: its band of th rows and tw
    columns with a 2-pixel halo, cut to the image, vg 16-byte vectors a
    pixel."""
    return min(H, th + 4) * min(W, tw + 4) * vg * 16


@functools.lru_cache(maxsize=None)
def launch_plan(B: int, H: int, W: int, C: int, dtype: torch.dtype) -> Plan:
    """The launch of one (B, C, H, W) pool; raises on a shape the kernel
    does not take. A block takes up to GROUP of a pixel's 16-byte vectors
    (the largest power of two dividing them), as many columns as make
    THREADS threads or the whole row, and as many sub-bands as fill
    THREADS where the row is narrow. A thread walks ROWS rows, fewer where
    the launch would have under MIN_THREADS threads (the 8x2 layers: a
    latency-bound launch wants many short walks)."""
    es = _check_dtype(dtype)
    if B < 1 or H < 1 or W < 1 or C < 1:
        raise ValueError(f"max_pool_5x5: empty input ({B}, {C}, {H}, {W})")
    if C * es % 16:
        raise ValueError(f"max_pool_5x5 takes channels in whole 16-byte "
                         f"vectors ({16 // es} {dtype}), got {C}")
    V = C * es // 16
    vg = gcd(V, GROUP)
    tw = min(W, max(1, THREADS // vg))
    cols = vg * tw
    rows = _pow2_at_most(max(1, min(ROWS, B * H * W * V // MIN_THREADS, H)))
    sub = max(1, min(THREADS // cols, -(-H // rows)))
    th, bands, col_blocks = sub * rows, -(-H // (sub * rows)), -(-W // tw)
    p = Plan(V, vg, tw, sub, rows, cols * sub, tile_bytes(H, W, vg, tw, th),
             bands, col_blocks, V // vg, B * (V // vg) * col_blocks * bands)
    if p.smem > MAX_SMEM or p.threads > MAX_THREADS:
        raise ValueError(f"max_pool_5x5: no plan for ({B}, {C}, {H}, {W})")
    return p


def library(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel 5, stride 1, padding 2): F.max_pool2d."""
    return F.max_pool2d(x, 5, stride=1, padding=2)


def max_pool_5x5_plain(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel 5, stride 1, padding 2): `library`, counted."""
    COUNTS["plain"] += 1
    return library(x)


def _check_cuda(x: torch.Tensor) -> None:
    """Raises on a card tensor the kernel does not take."""
    _check_dtype(x.dtype)
    if x.dim() != 4:
        raise ValueError(f"max_pool_5x5 takes (B, C, H, W), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("max_pool_5x5 takes channels-last contiguous x")
    if x.data_ptr() % 16:
        raise ValueError("max_pool_5x5 takes x at a 16-byte aligned address")


def _launch(x: torch.Tensor, p: Plan) -> torch.Tensor:
    """The kernel on a checked card tensor, launched as `p` says."""
    from . import _build

    B, C, H, W = x.shape
    out = torch.empty_like(x, memory_format=torch.channels_last)
    rc = _build.library().sbc_max_pool5(
        x.data_ptr(), out.data_ptr(), B, H, W, p.vectors,
        int(x.dtype == torch.bfloat16), p.vg, p.tw, p.sub, p.rows, p.smem,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("max_pool_5x5", rc)
    COUNTS["launches"] += 1
    return out


def max_pool_5x5(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel 5, stride 1, padding 2) of NCHW x: the kernel on a
    card tensor that autograd does not need, F.max_pool2d on one it does,
    the plain version on the CPU."""
    if x.device.type == "cpu":
        return max_pool_5x5_plain(x)
    if x.device.type != "cuda":
        raise RuntimeError(f"max_pool_5x5: no kernel for {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        COUNTS["autograd"] += 1
        return library(x)
    _check_cuda(x)
    B, C, H, W = x.shape
    return _launch(x, launch_plan(B, H, W, C, x.dtype))


def bytes_moved(B: int, H: int, W: int, C: int, dtype: torch.dtype) -> int:
    """One read of x and one write of the output."""
    return 2 * B * H * W * C * _check_dtype(dtype)


# the pools of one forward, (H, W, C) x count: NCSNv2-Deepest's six CRP
# blocks, two pools each, at ngf 32 on 64x16 and at ngf 128 on 256x256
POOLS = {"ngf32": [((64, 16, 32), 2), ((32, 8, 32), 2), ((16, 4, 64), 2),
                   ((8, 2, 64), 4), ((8, 2, 128), 2)],
         "ngf128": [((256, 256, 128), 2), ((128, 128, 128), 2),
                    ((64, 64, 256), 2), ((32, 32, 256), 4),
                    ((32, 32, 512), 2)]}

