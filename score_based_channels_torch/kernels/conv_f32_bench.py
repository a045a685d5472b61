"""The f32 route of `conv2d_taps` at every f32 shape of the score model's
paths, on the card, beside cuDNN and the bound.

    python -m score_based_channels_torch.kernels.conv_f32_bench \
        [--model deepest|ffhq] [--batch 16] [--reps 20] [--sweep] \
        [--json FILE]

Shapes: every conv variant of one forward of the model (found by hooks on
a forward). `--model deepest` (the default): NCSNv2-Deepest at ngf 32 on
64x16x2 (19 shapes, 113 convs, a CPU forward), timed
  - as the forward at batch 256 (`tune`, `mmse`, the f32 variants), and
  - at the training batch of 32: the forward, and the dgrad (the kernel on
    the transposed weight, as `conv2d_backward` launches it).
`--model ffhq`: NCSNv2-Deepest at its published FFHQ widths (ngf 128,
256x256x3; 113 convs, a forward on the card), each forward and dgrad
launch of a training step at `--batch`, most on the wide route.
Each time is the median of CUDA events around each call while a spin
kernel holds the device (`conv_probe.device_ms`), beside cuDNN with TF32
off (`F.conv2d`; for the dgrad, the input gradient of
`aten.convolution_backward`) and the bound: the larger of the operations
at 67 TFLOP/s and the bytes (x, the live taps' weights and the bias read
once, the output written once) at 3.35 TB/s. Prints one line per shape,
the sums per forward and per training step, and a JSON line.

For `deepest` it uses only what every version of the port has
(`conv.conv2d`, `kernel_layout`, `transposed_weight`, `live_taps`, the
model), so a copy of this file in an older checkout measures that version
the same way.

--sweep times, at each shape and batch, the plan beside the other
configurations of the f32 kernel (`conv.f32_config`: block pixels and
channels, chunk, cluster size; for `ffhq` the tile columns WS, block
pixels, chunk and stages) and prints the fastest: the data a change to
`conv.plan` starts from.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from typing import Dict, List

import torch
import torch.nn.functional as F

PEAK_F32 = 67e12     # H100 SXM FP32 outside the tensor cores, FLOP/s
PEAK_BYTES = 3.35e12  # HBM3, bytes/s
FWD_BATCH, TRAIN_BATCH = 256, 32
# (ngf, data channels, image H x W) of each model's forward
MODELS = {"deepest": (32, 2, (64, 16)), "ffhq": (128, 3, (256, 256))}


def census(model: str = "deepest",
           device: str = "cpu") -> Dict[tuple, int]:
    """{(H, W, Cin, Cout, k, d, bias, elu): calls} of one forward of the
    model at batch 1 on `device`."""
    from ..config import ModelConfig
    from ..models.layers import Conv2d
    from ..models.ncsnv2 import NCSNv2Deepest

    ngf, channels, (H, W) = MODELS[model]
    net = NCSNv2Deepest(ModelConfig(ngf=ngf), channels)
    net.init_parameters(torch.Generator().manual_seed(0))
    net = net.to(device)
    found: Dict[tuple, int] = {}

    def hook(mod, args, kwargs):
        x = args[0]
        key = (x.shape[2], x.shape[3], x.shape[1], mod.weight.shape[0],
               mod.weight.shape[-1], mod.dilation, mod.bias is not None,
               bool(kwargs.get("elu", False)))
        found[key] = found.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(hook, with_kwargs=True)
             for m in net.modules() if isinstance(m, Conv2d)]
    with torch.no_grad():
        net(torch.zeros(1, H, W, channels, device=device), 1.0)
    for h in hooks:
        h.remove()
    return found


def step_launches(model: str = "ffhq",
                  device: str = "cuda") -> List[tuple]:
    """(H, W, Cin, Cout, k, d, bias, count, kind) of one training step's
    conv launches of one row: each forward conv shape ("fwd", ELU folded
    into the count), and its input gradient ("dgrad": Cin and Cout
    swapped, no bias) except for the conv that reads the data."""
    channels = MODELS[model][1]
    per: Dict[tuple, int] = {}
    for (H, W, ci, co, k, d, b, _), n in census(model, device).items():
        per[(H, W, ci, co, k, d, b)] = per.get((H, W, ci, co, k, d, b), 0) + n
    out = []
    for (H, W, ci, co, k, d, b), n in sorted(per.items()):
        out.append((H, W, ci, co, k, d, b, n, "fwd"))
        if ci != channels:
            out.append((H, W, co, ci, k, d, False, n, "dgrad"))
    return out


def bound_ms(B, H, W, Cin, Cout, T, bias) -> float:
    flops = 2 * B * H * W * T * Cin * Cout
    nbytes = 4 * (B * H * W * (Cin + Cout) + T * Cin * Cout
                  + (Cout if bias else 0))
    return max(flops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3


def _inputs(g, B, H, W, Cin, Cout, k, bias, dev):
    """x (channels-last), the weight (`kernel_layout`) and the bias, drawn
    by `g` on its device and moved to `dev`."""
    from . import conv

    gd = g.device
    x = torch.randn(B, Cin, H, W, generator=g, device=gd).to(dev).contiguous(
        memory_format=torch.channels_last)
    w = conv.kernel_layout((torch.randn(Cout, Cin, k, k, generator=g,
                                        device=gd)
                            / (k * k * Cin) ** 0.5).to(dev))
    b = torch.randn(Cout, generator=g, device=gd).to(dev) if bias else None
    return x, w, b


def rows(reps: int) -> List[dict]:
    from . import conv
    from .conv_probe import device_ms

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    out = []
    for (H, W, Cin, Cout, k, d, bias, elu), n in sorted(census().items()):
        T = len(conv.live_taps(k, d, H, W))
        pad = d * (k // 2)
        r = dict(shape=[H, W, Cin, Cout, k, d], bias=bias, elu=elu,
                 per_forward=n, taps=T)
        x, w, b = _inputs(g, FWD_BATCH, H, W, Cin, Cout, k, bias, dev)
        r["fwd256_ms"] = device_ms(lambda: conv.conv2d(x, w, b, d, elu), dev,
                                   reps)
        r["fwd256_cudnn_ms"] = device_ms(
            lambda: F.conv2d(x, w, b, padding=pad, dilation=d), dev, reps)
        r["fwd256_bound_ms"] = bound_ms(FWD_BATCH, H, W, Cin, Cout, T, bias)
        x, w, b = _inputs(g, TRAIN_BATCH, H, W, Cin, Cout, k, bias, dev)
        gout = torch.randn(TRAIN_BATCH, Cout, H, W, generator=g).to(
            dev).contiguous(memory_format=torch.channels_last)
        wt = conv.transposed_weight(w)
        r["fwd32_ms"] = device_ms(lambda: conv.conv2d(x, w, b, d, elu), dev,
                                  reps)
        r["fwd32_cudnn_ms"] = device_ms(
            lambda: F.conv2d(x, w, b, padding=pad, dilation=d), dev, reps)
        r["fwd32_bound_ms"] = bound_ms(TRAIN_BATCH, H, W, Cin, Cout, T, bias)
        # the begin conv's input takes no gradient: no dgrad in a step
        r["dgrad_per_step"] = 0 if Cin == 2 else n
        r["dgrad32_ms"] = device_ms(lambda: conv.conv2d(gout, wt, None, d),
                                    dev, reps)
        r["dgrad32_cudnn_ms"] = device_ms(
            lambda: torch.ops.aten.convolution_backward(
                gout, x, w, None, [1, 1], [pad, pad], [d, d], False, [0, 0],
                1, [True, False, False]), dev, reps)
        r["dgrad32_bound_ms"] = bound_ms(TRAIN_BATCH, H, W, Cout, Cin, T,
                                         False)
        out.append(r)
        print(f"{H}x{W} {Cin}->{Cout} k{k} d{d} bias={int(bias)} "
              f"elu={int(elu)} x{n:<2d} b256 {r['fwd256_ms']:.4f} (cudnn "
              f"{r['fwd256_cudnn_ms']:.4f}, bound {r['fwd256_bound_ms']:.4f})"
              f"  b32 fwd {r['fwd32_ms']:.4f} (cudnn "
              f"{r['fwd32_cudnn_ms']:.4f}, bound {r['fwd32_bound_ms']:.4f})"
              f"  dgrad {r['dgrad32_ms']:.4f}"
              f" (cudnn {r['dgrad32_cudnn_ms']:.4f}, bound "
              f"{r['dgrad32_bound_ms']:.4f})", flush=True)
    return out


def sums(table: List[dict]) -> dict:
    """Per forward at batch 256 and per training step at batch 32."""
    tot = lambda key, n="per_forward": sum(r[key] * r[n] for r in table)
    s = {k: tot(k) for k in ("fwd256_ms", "fwd256_cudnn_ms",
                             "fwd256_bound_ms", "fwd32_ms", "fwd32_cudnn_ms",
                             "fwd32_bound_ms")}
    s.update({k: tot(k, "dgrad_per_step") for k in (
        "dgrad32_ms", "dgrad32_cudnn_ms", "dgrad32_bound_ms")})
    return s


def step_rows(B: int, reps: int, sweep: bool,
              model: str = "ffhq") -> List[dict]:
    """Each forward and dgrad launch shape of a training step of `model`
    at batch B: its plan, its time, cuDNN's and the bound; with `sweep`,
    the plan beside the other configurations near it (`_candidates`)."""
    from . import conv
    from .conv_probe import device_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for H, W, Cin, Cout, k, d, bias, n, kind in step_launches(model, "cuda"):
        taps = conv.live_taps(k, d, H, W)
        dy, dx = [t[2] for t in taps], [t[3] for t in taps]
        pad = d * (k // 2)
        x, w, b = _inputs(g, B, H, W, Cin, Cout, k, bias, dev)
        p0 = conv._launch_args(B, H, W, Cin, Cout, k, d, False)[0]
        r = dict(kind=kind, shape=[H, W, Cin, Cout, k, d], bias=bias,
                 count=n, plan=_brief(p0),
                 ms=device_ms(lambda: conv._launch(x, w, b, d, False), dev,
                              reps),
                 bound_ms=bound_ms(B, H, W, Cin, Cout, len(taps), bias))
        if kind == "fwd":
            r["cudnn_ms"] = device_ms(
                lambda: F.conv2d(x, w, b, padding=pad, dilation=d), dev,
                reps)
        else:  # x is grad_out (Cin = the forward's Cout), w transposed
            xf, wf, _ = _inputs(g, B, H, W, Cout, Cin, k, False, dev)
            r["cudnn_ms"] = device_ms(
                lambda: torch.ops.aten.convolution_backward(
                    x, xf, wf, None, [1, 1], [pad, pad], [d, d], False,
                    [0, 0], 1, [True, False, False]), dev, reps)
        if sweep:
            timed = sorted(
                (device_ms(lambda: conv._launch(x, w, b, d, False, p), dev,
                           max(3, reps // 2)), _brief(p))
                for p in _candidates(B, H, W, Cin, Cout, dy, dx, p0))
            r["best_ms"], r["best"] = timed[0]
            r["all"] = timed
        out.append(r)
        print(f"{kind:5s} {H}x{W} {Cin}->{Cout} k{k} d{d} x{n:<2d} "
              f"{r['ms']:.4f} ms ({r['plan']}) cudnn {r['cudnn_ms']:.4f} "
              f"bound {r['bound_ms']:.4f}"
              + (f"; best {r['best_ms']:.4f} ({r['best']})" if sweep
                 else ""), flush=True)
        del x, w, b
    return out


def step_sums(table: List[dict]) -> dict:
    """`step_rows` summed per training step (each shape x its count)."""
    s = {}
    for kind in ("fwd", "dgrad"):
        for key in ("ms", "cudnn_ms", "bound_ms", "best_ms"):
            if all(key in r for r in table):
                s[f"{kind}_{key}"] = sum(r[key] * r["count"] for r in table
                                         if r["kind"] == kind)
    return s


def _candidates(B, H, W, Cin, Cout, dy, dx, p0):
    """The plan and the configurations near it: tile columns WS, block
    pixels BM, chunk BK and stages, at the plan's BN and no cluster, where
    the grid fills the card."""
    from . import conv

    out = {p0}
    for WS in sorted({16, 32, 64, 128, W}):
        for BM in (128, 256):
            for BK in (8, 16):
                for st in (2, 3):
                    q = conv.f32_config(B, H, W, Cin, Cout, dy, dx, p0.BN,
                                        BM, BK, 1, st, WS=WS)
                    if q is not None and q.blocks >= conv.SMS:
                        out.add(q)
    return sorted(out, key=_brief)


def sweep(reps: int) -> List[dict]:
    """Every configuration of the f32 kernel (`conv.f32_config`: BN up to
    the power of 2 that holds Cout, BM 32-512, BK 4-16, CL 1-8, two or
    three stages) timed at each forward shape (bias and ELU off) at batch
    256 and at each forward and dgrad shape at batch 32, with the plan's
    time and rank among them."""
    from . import conv
    from .conv_probe import device_ms
    from .launch_cost import spin_cycles

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    found = []
    fwd = sorted({k[:6] for k in census()})
    dgrad = sorted({(H, W, co, ci, k, d) for H, W, ci, co, k, d in fwd
                    if ci != 2} - set(fwd))
    for B, shapes in ((FWD_BATCH, fwd), (TRAIN_BATCH, fwd + dgrad)):
        for H, W, Cin, Cout, k, d in shapes:
            taps = conv.live_taps(k, d, H, W)
            dy, dx = [t[2] for t in taps], [t[3] for t in taps]
            x, w, _ = _inputs(g, B, H, W, Cin, Cout, k, False, dev)
            p0 = conv.plan(B, H, W, Cin, Cout, dy, dx)
            cands = {p0}
            top = conv._pow2_at_least(Cout)
            for BN in conv.F32_BN:
                for BM in (32, 64, 128, 256, 512):
                    for BK in conv.F32_BK:
                        for CL in conv.F32_CLUSTERS:
                            for st in (2, 3):
                                p = conv.f32_config(B, H, W, Cin, Cout, dy,
                                                    dx, BN, BM, BK, CL, st)
                                if p is not None and BN <= top:
                                    cands.add(p)
            cands = sorted(cands, key=_brief)
            # a short spin: it covers the host's queueing of `reps` calls
            times = [device_ms(lambda: conv._launch(x, w, None, d, False, p),
                               dev, reps, spin=spin_cycles(5.0))
                     for p in cands]
            timed = sorted(zip(times, cands), key=lambda t: t[0])
            plan_ms = next(ms for ms, p in timed if p == p0)
            rank = [p for _, p in timed].index(p0)
            row = dict(B=B, shape=[H, W, Cin, Cout, k, d], plan_ms=plan_ms,
                       best_ms=timed[0][0], rank=rank, plan=_brief(p0),
                       best=_brief(timed[0][1]),
                       all=[(ms, _brief(p)) for ms, p in timed])
            found.append(row)
            print(f"sweep B{B} {H}x{W} {Cin}->{Cout} k{k} d{d}: plan "
                  f"{plan_ms:.4f} ({row['plan']}) rank {rank}/{len(timed)}; "
                  f"best {row['best_ms']:.4f} ({row['best']})", flush=True)
    return found


def _brief(p) -> str:
    return (f"WS{getattr(p, 'WS', '-')} TH{p.TH} SB{p.SB} BM{p.BM} BN{p.BN} "
            f"BK{p.BK} st{p.stages} CL{p.CL} thr{p.threads} "
            f"blocks{p.blocks}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="deepest")
    ap.add_argument("--batch", type=int, default=16,
                    help="the training batch of --model ffhq")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--json", help="write the rows and sums here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_f32_bench: no CUDA device; it times the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    if args.model == "deepest":
        table = rows(args.reps)
        res = dict(card=card, rows=table, sums=sums(table))
    else:
        table = step_rows(args.batch, args.reps, args.sweep, args.model)
        res = dict(card=card, batch=args.batch, rows=table,
                   sums=step_sums(table))
    print("sums: " + ", ".join(f"{k} {v:.4f}" for k, v in res["sums"].items()))
    if args.sweep and args.model == "deepest":
        res["sweep"] = sweep(args.reps)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res["sums"]))
    return res


if __name__ == "__main__":
    main()
