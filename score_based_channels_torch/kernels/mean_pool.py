"""2x2 mean pooling of channels-last activations (csrc/mean_pool2.cu):
ConvMeanPool's pools and the U-Net's down-sampling where autograd records
nothing.

Replaces no Pallas kernel: the JAX package pools with its framework's
reshape and mean. PyTorch's own channels-last `avg_pool2d` ran at ~13% of
its bytes bound and took 7% of a bf16 sampler sweep and of an FFHQ
inpainting unit.

Bound on an H100: bytes, one read of the input and one write of the
quarter-size output (the 6 pools of a 64x16 forward at batch 256 in bf16
move 110 MB, 0.033 ms at 3.35 TB/s; an FFHQ forward at batch 8 881 MB,
0.263 ms). The kernel gives each thread one 16-byte vector of the output:
four 16-byte loads of its window (streaming: the input is dead after the
pool), the sum in f32 in the library's order, one rounding, one 16-byte
store. `launch_plan` sizes the grid from (B, H, W, C, dtype).

`mean_pool_2x2` dispatches on what the input shows; odd H or W raises:
- a CUDA tensor for which autograd records nothing (grad disabled, or an
  input that does not require it: every sampler, DSM's validation, LDAMP's
  divergence forwards) launches the kernel, or raises where the kernel
  cannot take it (not channels-last contiguous, another dtype, channels
  not whole 16-byte vectors);
- a CUDA tensor that autograd needs keeps `F.avg_pool2d` and its backward
  (DSM steps, LDAMP's graded forwards);
- a CPU tensor goes to `mean_pool_2x2_plain`, `F.avg_pool2d` itself.
COUNTS counts the three: "launches", "autograd", "plain". Like the other
counts, "autograd" and "plain" count calls the wrappers see; a replayed
CUDA graph adds only its recorded launches (`kernels.add_launches`).

The kernel's output equals `F.avg_pool2d(x, 2)`'s bit for bit.

`POOLS` holds the pool shapes of one forward of NCSNv2-Deepest at ngf 32
(64x16) and ngf 128 (256x256) and of the LDAMP U-Net;
`pool_bench.per_forward` times the kernel and `library` there on the card.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

COUNTS = {"launches": 0, "autograd": 0, "plain": 0}

# must match csrc/mean_pool2.cu
MAX_VECTORS = 2 ** 31 - 1  # the input's 16-byte vectors, in 32-bit indices
# the plan's aims: a block of THREADS threads, fewer (down to MIN_THREADS)
# where the grid would have under MIN_BLOCKS blocks (four an SM of the
# H100's 132), so that the 16x4 and 8x2-output launches spread over every
# SM (blocks of 64, 256 or 512 threads read within 1% a forward on an H100)
THREADS = 256
MIN_THREADS = 64
MIN_BLOCKS = 4 * 132


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: `outputs` 16-byte output vectors (`vectors` a pixel),
    one a thread, `threads` a block, `blocks` blocks."""

    vectors: int
    outputs: int
    threads: int
    blocks: int


def _check_dtype(dtype: torch.dtype) -> int:
    """The element size of a dtype the kernel takes; raises on another."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mean_pool_2x2 takes float32 or bfloat16, got "
                        f"{dtype}")
    return 2 if dtype == torch.bfloat16 else 4


@functools.lru_cache(maxsize=None)
def launch_plan(B: int, H: int, W: int, C: int, dtype: torch.dtype) -> Plan:
    """The launch of one (B, C, H, W) pool; raises on a shape the kernel
    does not take. Blocks of THREADS threads, halved down to MIN_THREADS
    while the grid has under MIN_BLOCKS blocks."""
    es = _check_dtype(dtype)
    if B < 1 or H < 2 or W < 2 or C < 1 or H % 2 or W % 2:
        raise ValueError(f"mean_pool_2x2: no plan for ({B}, {C}, {H}, {W})")
    if C * es % 16:
        raise ValueError(f"mean_pool_2x2 takes channels in whole 16-byte "
                         f"vectors ({16 // es} {dtype}), got {C}")
    V = C * es // 16
    if B * H * W * V > MAX_VECTORS:
        raise ValueError(f"mean_pool_2x2: ({B}, {C}, {H}, {W}) has over "
                         f"2^31 vectors")
    n, threads = B * (H // 2) * (W // 2) * V, THREADS
    while threads > MIN_THREADS and -(-n // threads) < MIN_BLOCKS:
        threads //= 2
    return Plan(V, n, threads, -(-n // threads))


def library(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(2): F.avg_pool2d."""
    return F.avg_pool2d(x, 2)


def mean_pool_2x2_plain(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(2): `library`, counted."""
    COUNTS["plain"] += 1
    return library(x)


def _check_cuda(x: torch.Tensor) -> Plan:
    """The launch of a card tensor the kernel takes; raises on another."""
    _check_dtype(x.dtype)
    if x.dim() != 4:
        raise ValueError(f"mean_pool_2x2 takes (B, C, H, W), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("mean_pool_2x2 takes channels-last contiguous x")
    if x.data_ptr() % 16:
        raise ValueError("mean_pool_2x2 takes x at a 16-byte aligned address")
    B, C, H, W = x.shape
    return launch_plan(B, H, W, C, x.dtype)


def _launch(x: torch.Tensor, p: Plan) -> torch.Tensor:
    """The kernel on a checked card tensor, launched as `p` says."""
    from . import _build

    B, C, H, W = x.shape
    out = torch.empty(B, C, H // 2, W // 2, dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    rc = _build.library().sbc_mean_pool2(
        x.data_ptr(), out.data_ptr(), B, H, W, p.vectors,
        int(x.dtype == torch.bfloat16), p.threads,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("mean_pool_2x2", rc)
    COUNTS["launches"] += 1
    return out


def mean_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(2) of NCHW x with even H and W: the kernel on a card
    tensor that autograd does not need, F.avg_pool2d on one it does, the
    plain version on the CPU."""
    if x.shape[-2] % 2 or x.shape[-1] % 2:
        raise ValueError("mean_pool_2x2 requires even spatial dims")
    if x.device.type == "cpu":
        return mean_pool_2x2_plain(x)
    if x.device.type != "cuda":
        raise RuntimeError(f"mean_pool_2x2: no kernel for {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        COUNTS["autograd"] += 1
        return library(x)
    return _launch(x, _check_cuda(x))


def bytes_moved(B: int, H: int, W: int, C: int, dtype: torch.dtype) -> int:
    """One read of x and one write of the quarter-size output."""
    return B * H * W * C * _check_dtype(dtype) * 5 // 4


# the pools of one forward, (H, W, C) x count: NCSNv2-Deepest's three
# down-sampling residual blocks without dilation (res2, res3, res31), a
# ConvMeanPool on each branch, at ngf 32 on 64x16 and ngf 128 on 256x256;
# the LDAMP U-Net's three down-samplings (chans 16)
POOLS = {"ngf32": [((64, 16, 64), 2), ((32, 8, 64), 2), ((16, 4, 64), 2)],
         "ngf128": [((256, 256, 256), 2), ((128, 128, 256), 2),
                    ((64, 64, 256), 2)],
         "unet": [((64, 16, 16), 1), ((32, 8, 32), 1), ((16, 4, 64), 1)]}

