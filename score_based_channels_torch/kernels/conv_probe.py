"""The conv-probe harness: the score network's dominant conv shapes, timed
through the library yardstick and the port's conv kernels.

The counterpart of the JAX package's kernels/conv_probe.py::main. For each
probe case it times, per conv:

  library   F.conv2d on channels-last tensors (cuDNN; the counterpart of
            "XLA on its native layout"), weight in channels-last memory;
  per-tap   `conv.conv2d` (csrc/conv2d_taps.cu) on its channels-last layout;
  im2col    `conv_im2col.conv_im2col` (csrc/conv_im2col.cu) on the probe's
            (S = H*W, B, C) layout;

and for the n-step chain at 8x2, 128 channels, n in (4, 8): the library
chain, n x (F.conv2d + bias + F.elu), beside `conv_chain.conv_chain`
(csrc/conv_chain.cu). A kernel that fails to build or launch raises.

    python -m score_based_channels_torch.kernels.conv_probe \
        [--batch 256] [--dtype bfloat16] [--reps 20] [--device cuda]

On the card the times are device times (CUDA events around each call while
a spin kernel holds the device, median). `--device cpu` runs the plain
versions and reports host times, which say nothing about the card.

`conv_nhwc` and `conv_oracle` are the plain F.conv2d references of the JAX
module (no dead-tap pruning), on the NHWC and (S, B, C) layouts.
"""

from __future__ import annotations

import statistics
import time
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import conv, conv_chain, conv_im2col
from .launch_cost import spin_cycles

CASES = [  # name, H, W, Cin, Cout, dilation (conv_probe.py:295-301)
    ("64x16 c32  d1", 64, 16, 32, 32, 1),
    ("32x8  c64  d1", 32, 8, 64, 64, 1),
    ("8x2   c128 d1", 8, 2, 128, 128, 1),
    ("8x2   c128 d4", 8, 2, 128, 128, 4),
    ("8x2   c64  d1", 8, 2, 64, 64, 1),
]
CHAIN = (8, 2, 128, 1)   # H, W, C, dilation of the chain cases
CHAIN_NS = (4, 8)
HOLD_MS = 20.0  # the spin that holds the card while the host queues calls


def live_taps(k: int, dilation: int, H: int,
              W: int) -> List[Tuple[int, int, int, int, int]]:
    """(iy, ix, dy, dx, row_offset) of the taps that can touch real data,
    row_offset = dy*W + dx on the flattened pixel axis."""
    return [(iy, ix, dy, dx, dy * W + dx)
            for iy, ix, dy, dx in conv.live_taps(k, dilation, H, W)]


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
              dilation: int = 1, act: bool = False) -> torch.Tensor:
    """x (B, H, W, Cin), w (k, k, Cin, Cout): F.conv2d with the full
    padding d*(k//2) (no pruning), f32 accumulation, + bias, optional ELU,
    rounded to x's dtype."""
    pad = dilation * (w.shape[0] // 2)
    y = F.conv2d(x.permute(0, 3, 1, 2).float(),
                 w.permute(3, 2, 0, 1).float(), None, padding=pad,
                 dilation=dilation)
    if b is not None:
        y = y + b.float().view(1, -1, 1, 1)
    if act:
        y = F.elu(y)
    return y.to(x.dtype).permute(0, 2, 3, 1)


def conv_oracle(x_sbc: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor], H: int, W: int, dilation: int = 1,
                act: bool = False) -> torch.Tensor:
    """`conv_nhwc` on the (S, B, C) layout."""
    S, B, Cin = x_sbc.shape
    y = conv_nhwc(x_sbc.reshape(H, W, B, Cin).permute(2, 0, 1, 3), w, b,
                  dilation, act)
    return y.permute(1, 2, 0, 3).reshape(S, B, -1)


def device_ms(fn, device: torch.device, reps: int, warmup: int = 2,
              spin: Optional[int] = None) -> float:
    """Median time of fn() in ms: on the card, CUDA events around each call
    while a spin kernel of `spin` cycles (None: `launch_cost.spin_cycles`
    of HOLD_MS) holds the device, long enough for the host to queue every
    call, so the calls run back to back and the events time the device;
    on the CPU, the host's clock."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    cycles = spin_cycles(HOLD_MS) if spin is None else spin
    torch.cuda.synchronize()
    torch.cuda._sleep(cycles)
    events = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def main(argv=None) -> List[dict]:
    """Print the probe table; return its rows (times in us)."""
    import argparse

    from .._device import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--device", type=str, default=None,
                   help="default: the card; cpu runs the plain versions")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    dt = getattr(torch, args.dtype)
    B = args.batch
    g = torch.Generator().manual_seed(0)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "the CPU (host times of the plain versions)")
    ms = lambda fn: device_ms(fn, dev, args.reps)
    rows = []
    print(f"# batch {B}, {args.dtype}; per-conv us on {where}")
    print(f"{'case':16s} {'library':>9s} {'per-tap':>9s} {'im2col':>9s} "
          f"{'GFLOP':>8s}   TF/s (library / per-tap / im2col)")
    for name, H, W, Cin, Cout, d in CASES:
        S = H * W
        x = torch.randn(S, B, Cin, generator=g).to(dev, dt)
        x_cl = torch.randn(B, Cin, H, W, generator=g).to(dev, dt).contiguous(
            memory_format=torch.channels_last)
        w = (torch.randn(3, 3, Cin, Cout, generator=g)
             / (9 * Cin) ** 0.5).to(dev, dt)
        b = torch.zeros(Cout, device=dev)  # f32, as the JAX harness passes it
        weight = w.permute(3, 2, 0, 1)     # (O, I, k, k) in kernel_layout
        w_lib = weight.contiguous(memory_format=torch.channels_last)
        bx = b.to(dt)
        gflop = 2 * S * B * len(live_taps(3, d, H, W)) * Cin * Cout / 1e9
        t = [1e3 * ms(fn) for fn in (
            lambda: F.conv2d(x_cl, w_lib, bx, padding=d, dilation=d),
            lambda: conv.conv2d(x_cl, weight, bx, d),
            lambda: conv_im2col.conv_im2col(x, w, b, H, W, d))]
        rows.append(dict(case=name, H=H, W=W, Cin=Cin, Cout=Cout, d=d,
                         batch=B, dtype=args.dtype, gflop=gflop,
                         library_us=t[0], pertap_us=t[1], im2col_us=t[2]))
        print(f"{name:16s} {t[0]:9.2f} {t[1]:9.2f} {t[2]:9.2f} {gflop:8.3f}"
              f"   ({gflop * 1e3 / t[0]:.1f} / {gflop * 1e3 / t[1]:.1f} / "
              f"{gflop * 1e3 / t[2]:.1f})", flush=True)

    H, W, C, d = CHAIN
    S = H * W
    print(f"{'chain':16s} {'library':>9s} {'chain':>9s} {'':9s} {'GFLOP':>8s}"
          "   (library = n x (F.conv2d + bias + F.elu))")
    for n in CHAIN_NS:
        x = torch.randn(S, B, C, generator=g).to(dev, dt)
        x_cl = torch.randn(B, C, H, W, generator=g).to(dev, dt).contiguous(
            memory_format=torch.channels_last)
        ws = (torch.randn(n, 3, 3, C, C, generator=g)
              / (9 * C) ** 0.5).to(dev, dt)
        bs = torch.zeros(n, C, device=dev)
        w_lib = [ws[i].permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last) for i in range(n)]
        bs_x = bs.to(dt)

        def library_chain():
            y = x_cl
            for i in range(n):
                y = F.elu(F.conv2d(y, w_lib[i], bs_x[i], padding=d,
                                   dilation=d))
            return y

        gflop = n * 2 * S * B * len(live_taps(3, d, H, W)) * C * C / 1e9
        t = [1e3 * ms(fn) for fn in (
            library_chain,
            lambda: conv_chain.conv_chain(x, ws, bs, H, W, d))]
        rows.append(dict(case=f"chain n={n}", H=H, W=W, Cin=C, Cout=C, d=d,
                         n=n, batch=B, dtype=args.dtype, gflop=gflop,
                         library_us=t[0], chain_us=t[1]))
        print(f"chain n={n} c{C:<6d} {t[0]:9.2f} {t[1]:9.2f} {'':9s} "
              f"{gflop:8.3f}   ({gflop * 1e3 / t[0]:.1f} / "
              f"{gflop * 1e3 / t[1]:.1f})", flush=True)
    return rows


if __name__ == "__main__":
    main()
