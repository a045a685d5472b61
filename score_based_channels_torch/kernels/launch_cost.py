"""Host cost of one network forward and of its conv launches, on the card.

    python -m score_based_channels_torch.kernels.launch_cost [--reps 10]

Runs the full-width NCSNv2-Deepest forward in bf16 at batch 256 (random
weights from seed 0, as chip_smoke.py's bench phase) while a spin kernel
holds the device, so no launch waits for the card. The host's time for a
forward is then what the host alone spends on it (Python, the modules, the
wrappers, the launches), and a timer around every `conv.conv2d` call gives
the conv wrapper's share of it. Events around the queued forward give its
device time, and forwards run back to back without the spin give the wall
time per forward the two together allow.

Prints one line per rep, a summary line and a JSON line. It uses only what
every version of the port has (`conv.conv2d`, the model,
`score_fn_from_params`), so a copy of this file in an older checkout
measures that version the same way.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import List, Optional

import torch

HOLD_MS = 300.0  # the spin kernel's time: far longer than a forward's host time


def spin_cycles(ms: float) -> int:
    """Cycles of torch.cuda._sleep that hold the device for about ms."""
    probe = 20_000_000
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    s.record()
    torch.cuda._sleep(probe)
    e.record()
    e.synchronize()
    return int(probe * ms / s.elapsed_time(e))


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("launch_cost: no CUDA device; this script runs on the card")

    from ..config import ModelConfig
    from ..eval.estimate import score_fn_from_params
    from ..models import make_score_model
    from . import conv

    g = torch.Generator().manual_seed(0)
    model = make_score_model(ModelConfig(), device="cuda", generator=g)
    score = score_fn_from_params(model, torch.bfloat16)
    x = torch.randn(args.batch, 64, 16, 2, generator=g).cuda()
    sig = (torch.rand(args.batch, generator=g) * 2 + 0.05).cuda()
    for _ in range(3):  # builds the kernels, plans and caches every shape
        score(x, sig)
    torch.cuda.synchronize()

    spent: List[float] = []
    plain_conv2d = conv.conv2d

    def timed_conv2d(*a, **k):
        t0 = time.perf_counter()
        y = plain_conv2d(*a, **k)
        spent.append(time.perf_counter() - t0)
        return y

    cycles = spin_cycles(HOLD_MS)
    reps = []
    conv.conv2d = timed_conv2d
    try:
        for r in range(args.reps):
            torch.cuda.synchronize()
            torch.cuda._sleep(cycles)
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            spent.clear()
            t0 = time.perf_counter()
            score(x, sig)
            host_ms = (time.perf_counter() - t0) * 1e3
            e.record()
            held = not torch.cuda.current_stream().query()
            torch.cuda.synchronize()
            reps.append(dict(host_ms=host_ms, conv_ms=sum(spent) * 1e3,
                             conv_calls=len(spent), device_ms=s.elapsed_time(e),
                             held=held))
            print(f"# rep {r}: host {host_ms:.3f} ms per forward, conv.conv2d "
                  f"{reps[-1]['conv_ms']:.3f} ms in {len(spent)} calls, device "
                  f"{reps[-1]['device_ms']:.3f} ms, device held: {held}",
                  flush=True)
    finally:
        conv.conv2d = plain_conv2d

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.reps):
        score(x, sig)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.reps

    med = {k: statistics.median(r[k] for r in reps)
           for k in ("host_ms", "conv_ms", "device_ms")}
    calls = reps[0]["conv_calls"]
    out = dict(batch=args.batch, reps=args.reps,
               held=all(r["held"] for r in reps), conv_calls=calls,
               host_ms=med["host_ms"], conv_host_ms=med["conv_ms"],
               conv_host_us_per_call=med["conv_ms"] * 1e3 / calls,
               conv_share=med["conv_ms"] / med["host_ms"],
               device_ms=med["device_ms"], wall_ms=wall_ms, rows=reps)
    print(f"# launch cost, bf16 forward at batch {args.batch} (median of "
          f"{args.reps}, device held: {out['held']}): host {med['host_ms']:.3f} "
          f"ms, of which conv.conv2d {med['conv_ms']:.3f} ms "
          f"({100 * out['conv_share']:.1f}%; {out['conv_host_us_per_call']:.2f} "
          f"us per call x {calls}); device {med['device_ms']:.3f} ms; "
          f"back to back {wall_ms:.3f} ms per forward", flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
