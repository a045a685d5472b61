"""Smoke run of the PyTorch port (score_based_channels_torch) on one NVIDIA
card: the quickest proof that the port builds, is right and runs its main
path on the GPU.

    python3 chip_smoke.py        # from the repository root, one card

Phases (any failure propagates and the exit code is non-zero):
  1. device: the card's name and power limit;
  2. build: the CUDA kernels of csrc/, from the sources in the checkout;
  3. kernels: every conv and InstanceNorm++ variant of one full-width
     NCSNv2-Deepest forward (found by hooks on a census forward), at batch
     256 in float32 and bfloat16, held against its plain PyTorch version on
     the card (an f32 conv launched twice gives equal bits: no atomics),
     and timed (CUDA events, median) beside its plain version,
     its bound and, for the conv, the one-call cuDNN yardstick F.conv2d
     (the norm also by its device time in a profiler window); the LDPC
     min-sum iteration against its plain version, bit for bit over 25
     iterations at 1, 5, 100 and 256 packets of the 802.11n (648, 324)
     code, timed at 100 and 256 (events and device time) beside a
     Tensor.zero_ of its output; the 5x5 max-pool and 2x2 mean-pool
     kernels at every pool shape of NCSNv2-Deepest at ngf 32 (batch 256,
     bf16 and f32) and ngf 128 (batch 8, bf16) against F.max_pool2d and
     F.avg_pool2d (torch.equal; the mean pool also at the LDAMP U-Net's),
     their device time per forward beside the library's and the bytes
     bound;
  4. estimate path: the full-width 5,890,082-parameter network from a
     seed; its kernel forward against the plain forward; `run_estimation`
     (the `estimate` entry point) on a small file dataset written here,
     with the launch counts of that run (12 max-pool and 6 mean-pool
     launches a forward, no plain or autograd pool), saving its
     channel estimates;
     the `link` command on that file; the bench.py workload (batch 256, 38
     pilots, 10 dB, alpha 3e-11, beta 0.01, bf16 network, f32 state) on a
     truncated schedule with its launch counts (the `deepest.estimate.bf16`
     benchmark cell times that path); every path that samples the
     posterior (here and in phases 7-9 and 15) runs through the
     posterior runner, one level captured in a CUDA graph and replayed,
     and the counts of launches and forwards come from the runner
     (`graph_forwards`: one eager level and one capture a call);
     the graph phase (`graph_phase`): the bench workload through the
     graph against the same runner under `_graph.eager()` (equal bits),
     the card's ms per forward under the graph, the device busy share of
     a 2-level profiler window, capture seconds and pool MB;
  5. link path: `run_link_simulation` at the reference's full width (256
     packets, Nr 16, Nt 64, 4 QPSK streams, exact-ML LLRs, 25 BP
     iterations, 9 SNRs, ideal and estimated CSI at -10 dB NMSE) with its
     launch counts and BER/BLER; the sweep runs through one receiver
     graph (detector, de-interleave and decode captured at the second
     call and replayed), and `link_graph_phase` holds it, for the ML,
     K-best and ZF-SIC detectors, against the same sweep with the
     receiver eager (BER/BLER at every SNR, one point's bits and LLRs bit
     for bit), times both in turns as packets/s, profiles one point each
     way (wall, device busy, largest device ops) beside the host encoder
     timed alone, with the capture's seconds and pool MB;
  6. conv probe: `conv_im2col` against its plain version at the 5 probe
     cases (with and without bias and ELU) and at every conv shape of the
     forward (timed beside `conv2d_taps`), `conv_chain` at 8x2 c128 for
     n = 4, 8 and a dilated chain, all at batch 256 in float32 and
     bfloat16, and the n = 8 bf16 chain at each thread-block cluster size
     and samples per block; the harness `kernels.conv_probe.main` at full width with its
     launch counts; `fused_forward` at batch 256 in bfloat16 against the
     module forward, with its launch counts;
  7. train path: `ScoreTrainer.train` (the `train-score` entry point) on
     CDL-C generated on the host (200 train, 200 val realizations), the
     full-width network in f32, 4 epochs of 6 steps at batch 32 with a
     validation every 10 steps; its launch counts (conv forward and dgrad,
     norm, 0 plain calls); the card's gradient against the plain CPU
     gradient at batch 4 for every parameter; at every training conv
     shape the forward and the dgrad launch (against F.conv2d's input
     gradient), each launched twice for equal bits and timed beside its
     plain version, cuDNN's and its bound; the saved checkpoint read back and
     run through `run_estimation`; ms per step (forward, backward,
     optimizer+EMA), steps/s and a profiler window; `train` runs
     through the training runner (step 0 eager, one step captured in a
     CUDA graph, replayed for the others), and the train graph phase
     (`train_graph_phase`) holds it bit for bit against the eager loop
     under deterministic algorithms (12 steps across chunk and epoch
     boundaries), prints their largest difference without, times both
     in turns, the host's time a replay with the card held, a 3-step
     profiler window each way, the capture's seconds and pool MB;
  8. the comparison side: `run_ls_baseline`, `run_lasso_baseline` and
     `run_amp_baseline` at their defaults on the card, held per SNR point
     against the CPU on the same draws (0.01, 0.05 and 0.1 dB; lasso and
     amp on two channels of each point); from the train phase's
     checkpoint (full width, every 100th level of the schedule),
     `run_hparam_search` (2x2 grid x 3 SNRs x 32 channels) and
     `run_mmse_estimation` (init ls, coef_cap auto, 16 samples x 2 SNRs x 8
     channels) with their launch counts, each in turns eagerly
     (`_graph.eager()`) and through the graph (NMSE within 1e-5), each
     again on a slice of chains at beta 0 on the card and the CPU (NMSE
     within rtol 1e-3), the
     tuner's slim table driving `run_estimation`, and `lmmse --cov
     analytic`; lasso and amp run one captured iteration, replayed, and
     `baseline_graph_phase` holds each against its plain loop bit for bit
     at the commands' batch of 450 rows (estimate and trace), times both
     in turns and profiles each way (busy share, largest kernels);
  9. the other score models: NCSNv2 and NCSNv2Deeper at ngf 32, every conv
     and norm shape that NCSNv2-Deepest lacks held against its plain
     version at batch 256 in f32 and bf16 (timed beside cuDNN), the kernel
     forward against the plain CPU forward with its launch counts,
     `ScoreTrainer` with arch ncsnv2_deeper (one epoch) and
     `run_estimation` from its checkpoint;
 10. the samplers: unconditional, inpainting and interpolation on the
     full-width NCSNv2-Deepest, with their launch counts, each held against
     the CPU on a 2-sample slice fed the same draws; each runs one captured
     inner step, replayed, and `sampler_graph_check` holds it bit for bit
     against its eager loop fed the generator's draws (4 levels x 10
     steps at 64 chains), times both in turns as steps/s and profiles a
     run each way;
 11. LDAMP: `train_ldamp_snr` at the JAX package's defaults (10 unrolls,
     chans 16, batch 128) for 4 steps with its launch counts (conv2d_taps
     forward and dgrad), the card's gradient against the CPU's at batch 4,
     ms per step, `run_ldamp_eval` from the checkpoint, their
     `pilot_eigmax` launch counts (one a step, one an evaluated SNR),
     the kernel at the recipe's pilots against its plain version and
     float64 and timed beside eigvalsh; training runs
     through the LDAMP runner (step 0 eager, one step captured in a CUDA
     graph, replayed for the others), and `ldamp_graph_phase` holds it
     bit for bit against the eager loop under deterministic algorithms
     across the learning rate's staircase, prints their largest
     difference without, times both in turns, the host's time a replay
     with the card held, a 3-step profiler window each way, the capture's
     seconds and pool MB, and `train_ldamp_snr` at the recipe (24 epochs)
     each way;
 12. WGAN: `train_wgan` at the defaults (2 generator iterations of 100
     critic steps), ms per D and G step, `run_wgan_eval` on a reduced grid
     held against the CPU and float64 on 2 channels (the whole run on the
     card's ReLU branches), an inversion step at 4,096 chains, and the
     device busy share of one D, one G and one inversion step in one
     profiler window;
 13. `generate-data --backend native` against the torch generator's
     moments;
 14. variants: NCSNv2Deepest at full width (batch 256, f32) with each
     config-chosen activation (relu, lrelu, swish) and norm (InstanceNorm,
     VarianceNorm, None) and the default, against the plain CPU forward on
     8 rows, with the launch counts of a forward and its device ms;
 15. wide: the wide conv2d_taps route and the two-pass instance_norm_plus
     route at every conv and norm shape of NCSNv2-Deepest at its published
     FFHQ widths (ngf 128, 256x256x3) at batch 8 in bf16, against their
     plain versions, timed beside their bounds and cuDNN, and a short
     `annealed_langevin_inpainting` run of that model (2 levels x 3 steps)
     with its launch counts: every conv and norm on the new routes, every
     max pool on its kernel;
 15b. wide_train: the wide f32 conv2d_taps route, forward and input
     gradient, at every conv of one FFHQ training step at batch 16 (the
     cell's plans) against conv2d_plain and its autograd (1e-5 of
     max|plain|, two launches equal bits), timed beside conv2d_plain,
     cuDNN (TF32 off) and the bound, summed over the step's 104 + 103
     wide launches (the `conv2d_taps.f32_wide` entry of the kernels
     line); the two-pass norm under grad against the plain autograd, and
     three DSM steps of that model at batch 2 through `TrainChunkRunner`
     (step 0 eager, step 1 captured, step 2 replayed) with their launch
     counts by route, none plain, and the card ms of a replayed step;
 16. distributed: parallel/mp_smoke.run_smoke on NCCL at world size 1 (2
     data-parallel DSM steps at batch 32 in f32, the checkpoint round trip,
     a sweep chunk on every 100th level from the restored EMA) against the
     same run with no process group, to 1e-6; `ScoreTrainer.train` on
     the group through the captured step (the all-reduce in the graph),
     bit for bit the run with no group;
 17. trace: 2 bench forwards under torch.profiler, the exported chrome
     trace read by utils/trace_analysis.summarize and held against the
     profiler's own device total (1%), its top 5 lines;
 18. the {"kernels": [...]} line, the card line, and the {"ok": ...} line.

The train phase's gradient at the trained parameters is held norm-wise
against float64 with the card's max-pool selections replayed
(`trained_gradient_check`).

Details too long for the output go to chiprun_out/chip_smoke.json.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
BATCH = 256
PEAK_BYTES = 3.35e12                      # H100 SXM HBM3, bytes/s
PEAK_OPS = {torch.bfloat16: 989e12,       # dense tensor-core bf16
            torch.float32: 67e12}         # FP32 outside the tensor cores
TOL = {  # relative to max|plain|, or (rtol, atol)
    ("conv", torch.float32): 1e-5, ("conv", torch.bfloat16): 2e-2,
    ("norm", torch.float32): (2e-4, 2e-5), ("norm", torch.bfloat16): 2e-2,
    # tests/test_kernels.py:111
    ("chain", torch.float32): (1e-4, 1e-5), ("chain", torch.bfloat16): 2e-2,
}
SOURCES = {
    "conv2d_taps": ("score_based_channels_torch/csrc/conv2d_taps.cu",
                    "score_based_channels_tpu/kernels/conv_probe.py:105"),
    "instance_norm_plus": (
        "score_based_channels_torch/csrc/instance_norm_plus.cu",
        "score_based_channels_tpu/kernels/instance_norm.py:91"),
    "ldpc_minsum": ("score_based_channels_torch/csrc/ldpc_minsum.cu",
                    "score_based_channels_tpu/kernels/ldpc_minsum.py:79"),
    "conv_im2col": ("score_based_channels_torch/csrc/conv_im2col.cu",
                    "score_based_channels_tpu/kernels/conv_probe.py:135"),
    "conv_chain": ("score_based_channels_torch/csrc/conv_chain.cu",
                   "score_based_channels_tpu/kernels/conv_probe.py:178"),
    # replaces no Pallas kernel: eig1 was eigvalsh on the host's batch
    "pilot_eigmax": ("score_based_channels_torch/csrc/pilot_eigmax.cu", None),
    # replaces no Pallas kernel: the JAX package pools with XLA's
    # reduce_window
    "max_pool_5x5": ("score_based_channels_torch/csrc/max_pool5.cu", None),
    # replaces no Pallas kernel: the JAX package's mean pool is a reshape
    # and a mean
    "mean_pool_2x2": ("score_based_channels_torch/csrc/mean_pool2.cu", None),
}
ROUTE = {torch.bfloat16: "wgmma", torch.float32: "fma"}  # the convs' routes
LINK_PACKETS = 256
LINK_SNRS = np.arange(-10, 12.5, 2.5)  # the reference's grid
BP_ITERS = 25
LINK_DETECTORS = ("ml", "kbest", "zf-sic")  # each through its receiver graph


def cuda_ms(fn, reps=20):
    """Median device time of fn() in ms: CUDA events around each call while
    a spin kernel holds the device, so the events time the device, not the
    host's launch overhead (which the bench phase measures end to end)."""
    from score_based_channels_torch.kernels.conv_probe import device_ms

    return device_ms(fn, torch.device("cuda"), reps)


def profiled_ms(fn, name, reps=20):
    """Device time in ms per call of fn() of the kernels whose name holds
    `name`, from a profiler window: the kernel alone, without the gaps
    between launches that the events around each call include."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(ms for k, ms in device_ms_by_name(prof).items()
               if name in k) / reps


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def build_summary(log):
    """One line per kernel of nvcc's -Xptxas=-v output: registers, stack,
    spills and shared bytes, named by the kernel's function."""
    import re

    out, name, spills = [], None, ""
    for line in log.splitlines():
        if line.startswith("=="):
            out.append(line.strip())
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            # the readable part of the mangled name, e.g. ..._cu_<hash>
            # 24conv2d_taps_wgmma_kernelILi64ELi4E... -> ..._kernel<64, 4>
            raw = m.group(1)
            if "_cu_" in raw:
                raw = re.sub(r"^[0-9a-f]{8}\d+", "", raw.split("_cu_")[-1])
            raw = re.sub(r"^_Z\d+", "", raw)
            k = re.match(r"(\w+?_kernel)(I(?:Li\d+E)+|I\w+?E)?", raw)
            args = k and k.group(2) or ""
            targs = (["bf16"] if "bfloat" in args else
                     ["f32"] if args.startswith("If") else [])
            targs += re.findall(r"Li(\d+)E", args)
            name = raw[:60] if k is None else k.group(1) + (
                "<" + ", ".join(targs) + ">" if targs else "")
        elif "stack frame" in line and name:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spills}")
            name = None
    return out


def census(model):
    """{variant: calls per forward} of the convs and norms of one forward."""
    from score_based_channels_torch.models.layers import (
        Conv2d, InstanceNorm2dPlus,
    )

    convs, norms, handles = {}, {}, []

    def conv_hook(mod, args, kwargs):
        x = args[0]
        key = (x.shape[2], x.shape[3], x.shape[1], mod.weight.shape[0],
               mod.weight.shape[-1], mod.dilation, mod.bias is not None,
               bool(kwargs.get("elu", False)))
        convs[key] = convs.get(key, 0) + 1

    def norm_hook(mod, args, kwargs):
        x = args[0]
        key = (x.shape[2], x.shape[3], x.shape[1], bool(kwargs.get("elu")))
        norms[key] = norms.get(key, 0) + 1

    for m in model.modules():
        if isinstance(m, Conv2d):
            handles.append(m.register_forward_pre_hook(conv_hook,
                                                       with_kwargs=True))
        elif isinstance(m, InstanceNorm2dPlus):
            handles.append(m.register_forward_pre_hook(norm_hook,
                                                       with_kwargs=True))
    with torch.no_grad():
        model(torch.zeros(2, 64, 16, 2, device="cuda"), 1.0)
    for h in handles:
        h.remove()
    return convs, norms


def check_convs(convs, g):
    from score_based_channels_torch.kernels import conv

    rows = []
    for (H, W, Cin, Cout, k, d, bias, elu), per_fwd in sorted(convs.items()):
        T = len(conv.live_taps(k, d, H, W))
        for dt in (torch.float32, torch.bfloat16):
            bound = 1.0 / np.sqrt(Cin * k * k)
            x = torch.randn(BATCH, Cin, H, W, generator=g).to(
                "cuda", dt).contiguous(memory_format=torch.channels_last)
            w = conv.kernel_layout(((torch.rand(Cout, Cin, k, k, generator=g)
                                     * 2 - 1) * bound).to("cuda", dt))
            b = ((torch.rand(Cout, generator=g) * 2 - 1) * bound).to(
                "cuda", dt) if bias else None
            got = conv.conv2d(x, w, b, d, elu)
            torch.cuda.synchronize()
            want = conv.conv2d_plain(x, w, b, d, elu)
            err = (got.float() - want.float()).abs().max().item()
            ref = want.float().abs().max().item()
            tol = TOL[("conv", dt)]
            assert err <= tol * ref, (
                f"conv {(H, W, Cin, Cout, k, d, bias, elu)} {dt}: max err "
                f"{err:.3e} > {tol} * {ref:.3e}")
            if dt == torch.float32:  # no atomics: two launches, equal bits
                assert torch.equal(got, conv.conv2d(x, w, b, d, elu)), (
                    f"conv {(H, W, Cin, Cout, k, d)} f32: launches differ")
            pad = d * (k // 2)
            es = x.element_size()
            # x, the live taps' weights and the bias read once, out written
            nbytes = (x.numel() + T * Cin * Cout + BATCH * H * W * Cout
                      + (Cout if bias else 0)) * es
            flops = 2 * BATCH * H * W * T * Cin * Cout
            rows.append(dict(
                kind="conv", shape=[H, W, Cin, Cout, k, d], bias=bias, elu=elu,
                dtype=str(dt).split(".")[1], per_forward=per_fwd, taps=T,
                max_abs_err=err, rel_err=err / ref, tol=tol,
                ms=cuda_ms(lambda: conv.conv2d(x, w, b, d, elu)),
                plain_ms=cuda_ms(lambda: conv.conv2d_plain(x, w, b, d, elu)),
                library_ms=cuda_ms(lambda: F.conv2d(x, w, b, padding=pad,
                                                    dilation=d)),
                bytes_ms=nbytes / PEAK_BYTES * 1e3,
                ops_ms=flops / PEAK_OPS[dt] * 1e3))
            r = rows[-1]
            print(f"conv {H}x{W} {Cin}->{Cout} k{k} d{d} bias={int(bias)} "
                  f"elu={int(elu)} {r['dtype']:8s} x{per_fwd:<2d} rel_err "
                  f"{r['rel_err']:.2e} (tol {tol})  {ROUTE[dt]} {r['ms']:.4f} ms  "
                  f"plain {r['plain_ms']:.4f}  cudnn {r['library_ms']:.4f}  "
                  f"bound {max(r['bytes_ms'], r['ops_ms']):.4f}", flush=True)
    return rows


def check_norms(norms, g, summary=True):
    """Each norm variant against its plain version, timed; with summary,
    the sums over one forward (norms holds a whole forward's census)."""
    from score_based_channels_torch.kernels import instance_norm as inorm

    rows = []
    for (H, W, C, elu), per_fwd in sorted(norms.items()):
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn(BATCH, C, H, W, generator=g) * 2 + 0.5).to(
                "cuda", dt).contiguous(memory_format=torch.channels_last)
            a, gm = (1 + 0.02 * torch.randn(2, C, generator=g)).to("cuda", dt)
            bt = (0.1 * torch.randn(C, generator=g)).to("cuda", dt)
            got = inorm.instance_norm_plus(x, a, gm, bt, elu)
            torch.cuda.synchronize()
            want = inorm.instance_norm_plus_plain(x, a, gm, bt, elu)
            err = (got.float() - want.float()).abs().max().item()
            tol = TOL[("norm", dt)]
            if dt == torch.float32:
                torch.testing.assert_close(got, want, rtol=tol[0], atol=tol[1])
            else:
                ref = want.float().abs().max().item()
                assert err <= tol * ref, (
                    f"norm {(H, W, C)} bf16: max err {err:.3e} > {tol} * {ref}")
            es = x.element_size()
            nbytes = (2 * x.numel() + 3 * C) * es
            fn = lambda: inorm.instance_norm_plus(x, a, gm, bt, elu)
            rows.append(dict(
                kind="norm", shape=[H, W, C], elu=elu,
                dtype=str(dt).split(".")[1], per_forward=per_fwd,
                max_abs_err=err, tol=tol, ms=cuda_ms(fn),
                device_ms=profiled_ms(fn, "instance_norm_plus"),
                plain_ms=cuda_ms(
                    lambda: inorm.instance_norm_plus_plain(x, a, gm, bt, elu)),
                library_ms=None, bytes_ms=nbytes / PEAK_BYTES * 1e3,
                ops_ms=12 * x.numel() / PEAK_OPS[torch.float32] * 1e3))
            r = rows[-1]
            p = inorm.plan(BATCH, H, W, C, dt)
            r["plan"] = p.__dict__
            print(f"norm {H}x{W} c{C} elu={int(elu)} {r['dtype']:8s} "
                  f"x{per_fwd:<2d} max_abs_err {err:.2e} (tol {tol})  kernel "
                  f"{r['ms']:.4f} ms (device {r['device_ms']:.4f})  plain "
                  f"{r['plain_ms']:.4f}  bound "
                  f"{max(r['bytes_ms'], r['ops_ms']):.4f}  ({p.copy}, "
                  f"{p.threads} threads, cluster {p.cluster}, {p.chunks} "
                  "chunks)", flush=True)
    for dt in ("bfloat16", "float32") if summary else ():
        pf = per_forward(rows, dt)
        dev = sum(r["device_ms"] * r["per_forward"] for r in rows
                  if r["dtype"] == dt)
        print(f"# instance_norm_plus per {dt} forward at batch {BATCH}: "
              f"{pf['ms']:.4f} ms (device {dev:.4f}), plain "
              f"{pf['plain_ms']:.4f}, bound {pf['bound_ms']:.4f}")
    return rows


def check_ldpc(g):
    """Kernel against plain version, bit for bit (torch.equal: -0.0 equals
    +0.0), after each of 25 iterations and on post and bits, from zero
    messages with LLRs of noisy codewords and from random masked
    messages; timed at 100 and 256 packets."""
    from score_based_channels_torch.comms.ldpc import make_wifi_ldpc
    from score_based_channels_torch.kernels import ldpc_minsum as lm

    code = make_wifi_ldpc()
    mask = torch.as_tensor(code.H, dtype=torch.float32, device="cuda")
    t = lm.edge_tables(mask)
    E = t.num_edges
    rng = np.random.default_rng(0)
    rows = []
    p = lm.plan(LINK_PACKETS, t.m, t.n, E, t.max_row_degree)
    print(f"# ldpc_minsum plan at {LINK_PACKETS} packets: {p.copy} stores "
          f"of {p.rows_per_band}-row bands, {p.lanes_per_row} lanes a row, "
          f"{p.smem} shared bytes a block")
    for B in (1, 5, 100, LINK_PACKETS):
        cw = code.encode(rng.integers(0, 2, (B, code.k), np.uint8))
        llr = torch.from_numpy((1 - 2 * cw.astype(np.float32)) * 2.0 + 1.5
                               * rng.standard_normal(cw.shape).astype(
                                   np.float32)).cuda()
        starts = {"zeros": torch.zeros(B, code.m, code.n, device="cuda"),
                  "random": torch.randn(B, code.m, code.n, generator=g)
                  .cuda() * 3.0 * mask}
        for start, c0 in starts.items():
            ck, cp = c0, c0
            for it in range(BP_ITERS):
                ck = lm.bp_iteration(ck, llr, mask, 0.75, t)
                cp = lm.bp_iteration_plain(cp, llr, mask, 0.75, t)
                assert torch.equal(ck, cp), (
                    f"ldpc B={B} {start}: kernel != plain after iteration "
                    f"{it + 1}: max diff {(ck - cp).abs().max().item():.3e}")
            post_k = llr + lm.column_sums(ck, t)
            post_p = llr + lm.column_sums(cp, t)
            assert torch.equal(post_k, post_p)
            assert torch.equal(post_k < 0, post_p < 0)
            if start == "zeros":
                ber = float(((post_k < 0).cpu().numpy() != cw).mean())
        row = dict(B=B, max_abs_err=0.0, ber=ber)
        if B >= 100:
            c = starts["random"]
            nbytes = 4 * (B * code.m * code.n + B * E + B * code.n) \
                + t.nbytes()
            fn = lambda: lm.bp_iteration(c, llr, mask, 0.75, t)
            zero = torch.empty_like(c)
            row.update(
                ms=cuda_ms(fn), device_ms=profiled_ms(fn, "ldpc_minsum"),
                plain_ms=cuda_ms(lambda: lm.bp_iteration_plain(
                    c, llr, mask, 0.75, t)),
                zero_ms=cuda_ms(zero.zero_),  # the dense output alone
                library_ms=None, bytes_ms=nbytes / PEAK_BYTES * 1e3,
                # per edge: 2 adds, sub, abs, 2 compares, mul, select
                ops_ms=10 * B * E / PEAK_OPS[torch.float32] * 1e3)
        rows.append(row)
        print(f"ldpc_minsum B={B:3d}: kernel == plain bit for bit over "
              f"{BP_ITERS} iterations from zero and random messages"
              + f" (decoded BER {ber:.2e})"
              + (f"  kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f})"
                 f"  plain {row['plain_ms']:.4f}  zero_ of the output "
                 f"{row['zero_ms']:.4f}  bound "
                 f"{max(row['bytes_ms'], row['ops_ms']):.4f} ms per "
                 "iteration" if "ms" in row else ""), flush=True)
    return rows


def check_pools():
    """The pool kernels against the library (torch.equal) at every pool
    shape of one forward of NCSNv2-Deepest at ngf 32 (batch 256, bf16 and
    f32) and ngf 128 (batch 8, bf16): the 5x5 max pool against
    F.max_pool2d and the 2x2 mean pool against F.avg_pool2d (also at the
    LDAMP U-Net's, batch 128, f32), and the device time of a forward's 12
    max and 6 mean pools (kernels/pool_bench.py::per_forward: launches
    captured in a CUDA graph) beside the library's and the bytes bound."""
    from score_based_channels_torch.kernels import (max_pool, mean_pool,
                                                    pool_bench)

    out = {}
    for kind, mod, lib in (("max", max_pool, "F.max_pool2d"),
                           ("mean", mean_pool, "F.avg_pool2d")):
        runs = [("ngf32", BATCH, torch.bfloat16),
                ("ngf32", BATCH, torch.float32),
                ("ngf128", WIDE_BATCH, torch.bfloat16)]
        if kind == "mean":  # the LDAMP U-Net's pools too
            runs.append(("unet", 128, torch.float32))
        for model, B, dt in runs:
            f = pool_bench.per_forward(mod, model, B, dt)
            for r in f["rows"]:
                H, W, C = r["shape"]
                print(f"{kind} pool {H}x{W}x{C} {f['dtype']:8s} B={B} "
                      f"x{r['per_forward']}: equal {r['equal']}  "
                      f"{r['kernel_ms']:.4f} ms  {lib} "
                      f"{r['library_ms']:.4f}  bound {r['bound_ms']:.4f} "
                      "(bytes)", flush=True)
            n = sum(r["per_forward"] for r in f["rows"])
            print(f"# {n} {kind} pools of one {model} {f['dtype']} forward "
                  f"at batch {B}: {f['kernel_ms']:.4f} ms, {lib} "
                  f"{f['library_ms']:.4f} ms, bound {f['bound_ms']:.4f} ms "
                  f"({100 * f['bound_ms'] / f['kernel_ms']:.1f}%)",
                  flush=True)
            assert f["equal"], f
            out[f"{kind}.{model}.{f['dtype']}"] = f
    return out


def device_ms_by_name(prof):
    """{kernel name: device ms} of a profiler window."""
    by_name = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # CPU-side ops repeat the time of the kernels they launch
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t:
            by_name[e.key] = by_name.get(e.key, 0.0) + t / 1e3
    return by_name


def same_bits(a, b):
    """a and b (float32) hold the same bits, NaNs included."""
    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32),
                                                   b.view(torch.int32)))


def busy_window(fn, top=12):
    """fn() once to warm, then once inside a profiler window, the card
    synchronised: (wall ms, device busy ms, the `top` largest kernels as
    (name, device ms))."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_ms_by_name(prof)
    return (wall_ms, sum(by_name.values()),
            sorted(by_name.items(), key=lambda kv: -kv[1])[:top])


def link_phase(card):
    """`run_link_simulation` at the reference's full width on the card,
    through its receiver graph; then `link_graph_phase`."""
    from score_based_channels_torch import cplx, kernels
    from score_based_channels_torch.comms import link
    from score_based_channels_torch.comms.ldpc import make_wifi_ldpc
    from score_based_channels_torch.comms.link_bench import channels
    from score_based_channels_torch.comms.mimo import mimo_ml_llr

    H, H_est = channels(LINK_PACKETS)  # i.i.d. Rayleigh, -10 dB NMSE
    Ht, He = cplx.from_complex(H).cuda(), cplx.from_complex(H_est).cuda()
    code = make_wifi_ldpc()
    gen = torch.Generator(device="cuda").manual_seed(0)
    link.simulate_packets(gen, Ht, He, 0.0, code)  # warm-up
    torch.cuda.synchronize()

    kernels.reset_counts()
    t0 = time.perf_counter()
    res = link.run_link_simulation(H, H_est, snr_range=LINK_SNRS,
                                   num_bp_iters=BP_ITERS, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = kernels.counts()
    print(f"# link: {LINK_PACKETS} packets x {len(LINK_SNRS)} SNRs, ML, "
          f"{BP_ITERS} BP iterations, ideal and estimated CSI: {dt:.3f} s, "
          f"{LINK_PACKETS * len(LINK_SNRS) / dt:.1f} packets/s (each "
          f"detected and decoded twice); launches {n}")
    for i, snr in enumerate(res.snr_range):
        print(f"#   SNR {snr:6.1f} dB  BER ideal {res.ber_ideal[i]:.5f} est "
              f"{res.ber_est[i]:.5f}  BLER ideal {res.bler_ideal[i]:.4f} est "
              f"{res.bler_est[i]:.4f}")
    assert n["ldpc_minsum"] == {"launches": BP_ITERS * 2 * len(LINK_SNRS),
                                "plain": 0}, n
    assert all(v["launches"] == v.get("plain", 0) == 0 for k, v in n.items()
               if k != "ldpc_minsum"), n
    i10 = int(np.argmin(np.abs(res.snr_range - 10.0)))
    assert res.ber_ideal[i10] <= 0.05, res.ber_ideal  # tests/test_comms.py:158
    assert res.ber_est[i10] >= res.ber_ideal[i10], (res.ber_est, res.ber_ideal)
    assert np.isfinite(res.ber_est).all() and np.isfinite(res.bler_est).all()

    graph = link_graph_phase(H, H_est, Ht, He, code, card)
    win = graph["ml"]["windows"]["graph"]
    ldpc_ms = sum(ms for k, ms in win["top"] if "ldpc_minsum_kernel" in k)

    # the ML detector of the same point, alone (2 calls per SNR point)
    g = torch.Generator(device="cuda").manual_seed(1)
    V = cplx.randn(g, (LINK_PACKETS, 64, 4)) / 8.0
    Heff = cplx.matmul(Ht, V)
    Y = cplx.matmul(cplx.randn(g, (LINK_PACKETS, 81, 4)),
                    cplx.transpose(Heff))
    ml_ms = cuda_ms(lambda: mimo_ml_llr(Y, Heff, 0.05), reps=5)
    print(f"# ML LLR alone: {ml_ms:.3f} ms per call ({LINK_PACKETS} packets "
          f"x 81 slots x 256 hypotheses), 2 per SNR point: "
          f"{100 * 2 * ml_ms / win['wall_ms']:.1f}% of the graph window's "
          f"wall; LDPC kernel {ldpc_ms:.2f} ms a point in that window "
          f"({ldpc_ms / (2 * BP_ITERS):.4f} ms per iteration in the path)")
    return dict(seconds=dt, packets_per_s=LINK_PACKETS * len(LINK_SNRS) / dt,
                counts=n, ber_ideal=res.ber_ideal.tolist(),
                ber_est=res.ber_est.tolist(), bler_ideal=res.bler_ideal.tolist(),
                bler_est=res.bler_est.tolist(), profile_wall_ms=win["wall_ms"],
                profile_busy_ms=win["busy_ms"], profile_ldpc_ms=ldpc_ms,
                profile_top=win["top"], ml_llr_ms=ml_ms,
                host_encode_ms=graph["host_encode_ms"],
                ms_per_iteration_in_path=ldpc_ms / (2 * BP_ITERS),
                graph=graph)


@contextlib.contextmanager
def captures_made(caps):
    """Every `_graph.capture` made inside, appended to caps."""
    from score_based_channels_torch import _graph

    capture = _graph.capture
    _graph.capture = lambda *a: caps.append(capture(*a)) or caps[-1]
    try:
        yield
    finally:
        _graph.capture = capture


def link_graph_phase(H, H_est, Ht, He, code, card):
    """The link's receiver graph (in phase 5), at the link phase's full
    width, for each detector: `run_link_simulation` through the graph
    (one capture a sweep: call 1 eager, 17 replays) against the same
    sweep with its receivers eager, BER and BLER equal at every SNR;
    the hard bits and final LLRs of one point (10 dB, estimated CSI)
    bit for bit; whole sweeps in turns (eager, graph, graph, eager) as
    packets/s; one point's wall and device time in a profiler window
    each way with its largest device ops; a point's host wall beside the
    numpy encoder timed alone; the capture's seconds and pool MB."""
    from score_based_channels_torch import _graph, kernels
    from score_based_channels_torch.comms import link

    n_pk = LINK_PACKETS * len(LINK_SNRS)
    bits = np.random.default_rng(4).integers(0, 2, (LINK_PACKETS, code.k),
                                             dtype=np.uint8)
    enc_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        code.encode(bits)
        enc_ms.append((time.perf_counter() - t0) * 1e3)
    out = {"host_encode_ms": float(np.median(enc_ms))}
    print(f"# link graph: host numpy encoder {out['host_encode_ms']:.2f} ms "
          f"a point ({LINK_PACKETS} packets, median of 5) on {card}")
    for det in LINK_DETECTORS:
        sweep = lambda: link.run_link_simulation(
            H, H_est, snr_range=LINK_SNRS, num_bp_iters=BP_ITERS,
            detector=det, device="cuda")

        def eager():
            with _graph.eager():
                return sweep()

        caps = []
        kernels.reset_counts()
        with captures_made(caps):
            got = sweep()
        n = kernels.counts()
        want = eager()
        keys = ("ber_ideal", "ber_est", "bler_ideal", "bler_est")
        same = all(np.array_equal(getattr(got, k), getattr(want, k))
                   for k in keys)
        # one point through a kept receiver each way: bits and LLRs
        rx = {way: link.LinkReceiver(code, LINK_PACKETS, 16, detector=det,
                                     device="cuda")
              for way in ("graph", "eager")}

        def point_of(way):
            def run():
                with (_graph.eager() if way == "eager"
                      else contextlib.nullcontext()):
                    return link.simulate_packets(
                        torch.Generator(device="cuda").manual_seed(7), Ht,
                        He, 10.0, code, detector=det, receiver=rx[way])
            return run
        point = {way: point_of(way) for way in rx}
        for way in ("graph", "graph", "eager"):  # graph: eager, capture
            point[way]()
        bit_equal = (torch.equal(rx["graph"].decoder.bits,
                                 rx["eager"].decoder.bits)
                     and same_bits(rx["graph"].decoder.post,
                                   rx["eager"].decoder.post))
        print(f"# link graph, {det}: {LINK_PACKETS} packets x "
              f"{len(LINK_SNRS)} SNRs; BER/BLER equal to the eager sweep at "
              f"every SNR {same}; one point's bits and LLRs bit-equal "
              f"{bit_equal}; {len(caps)} capture a sweep of "
              f"{rounded([c.seconds for c in caps], 4)} s, pool "
              f"{rounded([c.pool_bytes / 2**20 for c in caps], 1)} MB; "
              f"ldpc_minsum {n['ldpc_minsum']}", flush=True)
        assert same and bit_equal, (det, same, bit_equal)
        assert len(caps) == 1, caps
        assert n["ldpc_minsum"] == {"launches": BP_ITERS * 2 * len(LINK_SNRS),
                                    "plain": 0}, n
        secs, _ = in_turns(eager, sweep, f"link {det} sweeps, eager "
                           "receiver and graph")
        rate = {k: [n_pk / v for v in vs] for k, vs in secs.items()}
        print(f"#   packets/s: eager {rounded(rate['plain'], 1)}, graph "
              f"{rounded(rate['graph'], 1)}")
        windows, host = {}, {}
        for way in ("eager", "graph"):
            wall, busy, top = busy_window(point[way])
            windows[way] = dict(wall_ms=wall, busy_ms=busy, top=top)
            walls = [timed(point[way])[1] * 1e3 for _ in range(5)]
            host[way] = float(np.median(walls))
            print(f"#   one point (10 dB), {way}: profiled wall {wall:.2f} "
                  f"ms, device busy {busy:.2f} ms ({100 * busy / wall:.1f}%)"
                  f"; wall {host[way]:.2f} ms (median of 5), of which "
                  f"{out['host_encode_ms']:.2f} the encoder and "
                  f"{host[way] - out['host_encode_ms'] - busy:.2f} neither "
                  f"the encoder nor the card")
            for k, ms in top[:8]:
                print(f"#     {ms:9.3f} ms  {k[:80]}")
        out[det] = dict(equal=same, bit_equal=bit_equal, counts=n,
                        capture_seconds=[c.seconds for c in caps],
                        pool_bytes=[c.pool_bytes for c in caps],
                        seconds=secs, packets_per_s=rate, windows=windows,
                        point_wall_ms=host, ber_est=got.ber_est.tolist())
    return out


def rel_check(got, want, tol, what):
    """max|got - want| <= tol * max|want|; returns the max abs error."""
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    assert err <= tol * ref, f"{what}: max err {err:.3e} > {tol} * {ref:.3e}"
    return err


def check_im2col_probe(g):
    """conv_im2col against its plain version at the probe's 5 cases, each
    with and without bias and ELU (f32 bias, as the JAX harness passes
    it), batch 256, float32 and bfloat16."""
    from score_based_channels_torch.kernels import conv_im2col as ci
    from score_based_channels_torch.kernels.conv_probe import CASES

    rows = []
    for name, H, W, Cin, Cout, d in CASES:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(H * W, BATCH, Cin, generator=g).to("cuda", dt)
            w = (torch.randn(3, 3, Cin, Cout, generator=g)
                 / (9 * Cin) ** 0.5).to("cuda", dt)
            b = (0.1 * torch.randn(Cout, generator=g)).cuda()
            errs = []
            for bias, act in ((False, False), (True, False), (False, True),
                              (True, True)):
                bb = b if bias else None
                got = ci.conv_im2col(x, w, bb, H, W, d, act)
                torch.cuda.synchronize()
                want = ci.conv_im2col_plain(x, w, bb, H, W, d, act)
                errs.append(rel_check(got, want, TOL[("conv", dt)],
                                      f"im2col {name} {dt} {bias} {act}"))
            rows.append(dict(case=name, dtype=str(dt).split(".")[1],
                             max_abs_err=max(errs), tol=TOL[("conv", dt)]))
            print(f"conv_im2col probe {name} {rows[-1]['dtype']:8s} "
                  f"(S, B, C) layout, 4 bias/ELU variants: max abs err "
                  f"{max(errs):.2e} (tol {TOL[('conv', dt)]} of max|plain|)",
                  flush=True)
    return rows


def check_im2col_main(convs, conv_rows, g):
    """conv2d_im2col against its plain version at every conv shape of one
    forward (channels-last), timed beside conv2d_taps; the plain and cuDNN
    times are conv2d_taps's rows of the same function and shape."""
    from score_based_channels_torch.kernels import conv, conv_im2col as ci

    taps_rows = {(tuple(r["shape"]), r["bias"], r["elu"], r["dtype"]): r
                 for r in conv_rows}
    rows = []
    for (H, W, Cin, Cout, k, d, bias, elu), per_fwd in sorted(convs.items()):
        for dt in (torch.float32, torch.bfloat16):
            bound = 1.0 / np.sqrt(Cin * k * k)
            x = torch.randn(BATCH, Cin, H, W, generator=g).to(
                "cuda", dt).contiguous(memory_format=torch.channels_last)
            w = conv.kernel_layout(((torch.rand(Cout, Cin, k, k, generator=g)
                                     * 2 - 1) * bound).to("cuda", dt))
            b = ((torch.rand(Cout, generator=g) * 2 - 1) * bound).to(
                "cuda", dt) if bias else None
            got = ci.conv2d_im2col(x, w, b, d, elu)
            torch.cuda.synchronize()
            want = ci.conv2d_im2col_plain(x, w, b, d, elu)
            shape = (H, W, Cin, Cout, k, d)
            err = rel_check(got, want, TOL[("conv", dt)], f"im2col {shape}")
            t = taps_rows[(shape, bias, elu, str(dt).split(".")[1])]
            rows.append(dict(
                kind="im2col", shape=list(shape), bias=bias, elu=elu,
                dtype=t["dtype"], per_forward=per_fwd, max_abs_err=err,
                rel_err=err / want.float().abs().max().item(),
                ms=cuda_ms(lambda: ci.conv2d_im2col(x, w, b, d, elu)),
                taps_ms=t["ms"], plain_ms=t["plain_ms"],
                library_ms=t["library_ms"], bytes_ms=t["bytes_ms"],
                ops_ms=t["ops_ms"]))
            r = rows[-1]
            print(f"im2col {H}x{W} {Cin}->{Cout} k{k} d{d} bias={int(bias)} "
                  f"elu={int(elu)} {r['dtype']:8s} x{per_fwd:<2d} rel_err "
                  f"{r['rel_err']:.2e}  {ROUTE[dt]} {r['ms']:.4f} ms  conv2d_taps "
                  f"{r['taps_ms']:.4f}  cudnn {r['library_ms']:.4f}  bound "
                  f"{max(r['bytes_ms'], r['ops_ms']):.4f}", flush=True)
    return rows


CHAINS = [(4, 1), (8, 1), (4, 2)]  # (n, dilation) at 8x2, 128 channels


def check_chains(g):
    """conv_chain against its plain version at 8x2 c128, batch 256, n = 4
    and 8 (d 1) and a dilated chain (d 2: 3 live taps), float32 and
    bfloat16; timed beside the plain version and the library chain
    n x (F.conv2d + bias + F.elu)."""
    from score_based_channels_torch.kernels import conv, conv_chain as cc

    H, W, C = 8, 2, 128
    S = H * W
    rows = []
    for n, d in CHAINS:
        T = len(conv.live_taps(3, d, H, W))
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(S, BATCH, C, generator=g).to("cuda", dt)
            ws = (torch.randn(n, 3, 3, C, C, generator=g)
                  / (9 * C) ** 0.5).to("cuda", dt)
            bs = (0.1 * torch.randn(n, C, generator=g)).cuda()
            got = cc.conv_chain(x, ws, bs, H, W, d)
            torch.cuda.synchronize()
            want = cc.conv_chain_plain(x, ws, bs, H, W, d)
            tol = TOL[("chain", dt)]
            err = (got.float() - want.float()).abs().max().item()
            if dt == torch.float32:
                torch.testing.assert_close(got, want, rtol=tol[0], atol=tol[1])
            else:
                rel_check(got, want, tol, f"chain n={n} d={d} bf16")
            x_cl = cc.sbc_as_nchw(x, H, W).contiguous(
                memory_format=torch.channels_last)
            w_lib = [ws[i].permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last) for i in range(n)]
            bs_x = bs.to(dt)

            def library_chain():
                y = x_cl
                for i in range(n):
                    y = F.elu(F.conv2d(y, w_lib[i], bs_x[i], padding=d,
                                       dilation=d))
                return y

            es = x.element_size()
            rows.append(dict(
                n=n, d=d, taps=T, dtype=str(dt).split(".")[1],
                max_abs_err=err, tol=tol,
                ms=cuda_ms(lambda: cc.conv_chain(x, ws, bs, H, W, d)),
                plain_ms=cuda_ms(lambda: cc.conv_chain_plain(x, ws, bs, H, W,
                                                             d)),
                library_chain_ms=cuda_ms(library_chain),
                bytes_ms=((2 * x.numel() + n * T * C * C) * es + 4 * bs.numel())
                / PEAK_BYTES * 1e3,
                ops_ms=2 * S * BATCH * T * C * C * n / PEAK_OPS[dt] * 1e3))
            r = rows[-1]
            print(f"conv_chain 8x2 c128 n={n} d={d} ({T} taps) {r['dtype']:8s}"
                  f" max abs err {err:.2e} (tol {tol})  kernel {r['ms']:.4f} "
                  f"ms  plain {r['plain_ms']:.4f}  library chain "
                  f"{r['library_chain_ms']:.4f}  bound "
                  f"{max(r['bytes_ms'], r['ops_ms']):.4f}", flush=True)
    # the n = 8 bf16 chain at each cluster size (the plan with its cluster
    # replaced), held against the plain version: each cluster of CL blocks
    # fetches the chain's weights from L2 once
    n, T, bf = 8, len(conv.live_taps(3, 1, H, W)), torch.bfloat16
    x = torch.randn(S, BATCH, C, generator=g).to("cuda", bf)
    ws = (torch.randn(n, 3, 3, C, C, generator=g) / (9 * C) ** 0.5).to(
        "cuda", bf)
    bs = (0.1 * torch.randn(n, C, generator=g)).cuda()
    want = cc.conv_chain_plain(x, ws, bs, H, W, 1)
    base = cc.plan(BATCH, H, W, C, bf)
    by_cluster = {}
    for cl in cc.CLUSTERS:
        p = dataclasses.replace(base, cluster=cl)
        got = cc._launch(x, ws, bs, H, W, 1, p)
        torch.cuda.synchronize()
        err = rel_check(got, want, TOL[("chain", bf)], f"chain n=8 CL={cl}")
        clusters = cc.grid(BATCH, p) // cl
        by_cluster[cl] = dict(
            ms=cuda_ms(lambda: cc._launch(x, ws, bs, H, W, 1, p)),
            l2_weight_mb=clusters * n * T * C * C * 2 / 1e6,
            clusters=clusters, max_active_clusters=cc.max_clusters(p),
            max_abs_err=err)
        r = by_cluster[cl]
        mark = "  (the plan's)" if cl == base.cluster else ""
        print(f"conv_chain n=8 bf16 CL={cl}: {r['ms']:.4f} ms, L2 weight "
              f"reads {r['l2_weight_mb']:.1f} MB a chain, {clusters} "
              f"clusters launched, cudaOccupancyMaxActiveClusters "
              f"{r['max_active_clusters']}, max abs err {err:.2e} (tol "
              f"{TOL[('chain', bf)]} of max|plain|){mark}", flush=True)
    # the plan's samples per block (B // BLOCKS) against its neighbours, at
    # the plan's cluster size
    sweep = {}
    for blocks in (256, 128, 64, 32):
        cc.BLOCKS = blocks
        cc._plan.cache_clear()
        sb = cc.plan(BATCH, H, W, C, bf).SB
        sweep[sb] = cuda_ms(lambda: cc.conv_chain(x, ws, bs, H, W, 1))
    cc.BLOCKS = 128
    cc._plan.cache_clear()
    print(f"# conv_chain n=8 bf16 ms by samples per block at CL="
          f"{base.cluster}: "
          + ", ".join(f"{sb}: {ms:.4f}" for sb, ms in sweep.items()))
    row = next(r for r in rows
               if (r["n"], r["d"], r["dtype"]) == (8, 1, "bfloat16"))
    row.update(cluster=base.cluster, by_cluster=by_cluster,
               samples_per_block_ms=sweep)
    return rows


def fused_forward_phase(model, g):
    """fused_forward on the card at batch 256 in bf16 against the module
    forward (the same kernels), with its launch counts and time."""
    import copy

    from score_based_channels_torch import kernels
    from score_based_channels_torch.kernels.fused_forward import fused_forward

    m16 = copy.deepcopy(model).to(torch.bfloat16)
    sd = m16.state_dict()
    x = torch.randn(BATCH, 64, 16, 2, generator=g).to("cuda", torch.bfloat16)
    sig = (torch.rand(BATCH, generator=g) * 2 + 0.05).cuda()
    with torch.no_grad():
        kernels.reset_counts()
        got = fused_forward(sd, x, sig)
        torch.cuda.synchronize()
        n = kernels.counts()
        want = m16(x, sig)
        ms = cuda_ms(lambda: fused_forward(sd, x, sig), reps=5)
        module_ms = cuda_ms(lambda: m16(x, sig), reps=5)
    assert n["conv2d_taps"] == {"launches": 113, "plain": 0}, n
    assert n["instance_norm_plus"] == {"launches": 25, "plain": 0}, n
    assert n["max_pool_5x5"] == {"launches": 12, "plain": 0,
                                 "autograd": 0}, n
    assert n["mean_pool_2x2"] == {"launches": 6, "autograd": 0,
                                  "plain": 0}, n
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    equal = torch.equal(got, want)
    print(f"# fused_forward, batch {BATCH} bf16: launches {n}; equal to the "
          f"module forward: {equal}; {ms:.3f} ms per forward (module "
          f"{module_ms:.3f} ms)", flush=True)
    assert equal, (got - want).abs().max().item()
    return dict(counts=n, equal=equal, ms=ms, module_ms=module_ms)


def conv_probe_phase(convs, conv_rows, model, g):
    """Phase 6: the two conv-probe kernels, the harness and fused_forward."""
    from score_based_channels_torch import kernels
    from score_based_channels_torch.kernels import conv_probe

    probe_rows = check_im2col_probe(g)
    im2col_rows = check_im2col_main(convs, conv_rows, g)
    for dt in ("bfloat16", "float32"):
        pi, pt = per_forward(im2col_rows, dt), per_forward(conv_rows, dt)
        print(f"# per {dt} forward at batch {BATCH}: conv_im2col "
              f"{pi['ms']:.3f} ms, conv2d_taps {pt['ms']:.3f} ms, cuDNN "
              f"{pt['library_ms']:.3f} ms, bound {pt['bound_ms']:.3f} ms")
    chain_rows = check_chains(g)
    kernels.reset_counts()
    harness_rows = conv_probe.main(["--batch", str(BATCH), "--dtype",
                                    "bfloat16"])
    torch.cuda.synchronize()
    n = kernels.counts()
    print(f"# conv probe harness launches: {n}")
    for name in ("conv_im2col", "conv_chain"):
        assert n[name]["launches"] > 0 and n[name]["plain"] == 0, n
    fused = fused_forward_phase(model, g)
    return dict(probe_rows=probe_rows, im2col_rows=im2col_rows,
                chain_rows=chain_rows, harness_rows=harness_rows,
                harness_counts=n, fused_forward=fused)


TRAIN_BATCH = 32          # the reference recipe (train_score.py:54)
TRAIN_EPOCHS = 4          # 4 x 6 steps: 200 realizations, drop_last
TRAIN_LOG_EVERY = 10
GRAD_CHECK_BATCH = 4


def train_conv_rows(convs, g):
    """At every conv variant of a training step (batch 32, f32): the
    forward launch; the dgrad launch (the kernel on the transposed weight)
    held against F.conv2d's input gradient, timed beside its plain version
    and aten.convolution_backward's input gradient; the weight and bias
    gradient (aten.convolution_backward over the live taps)."""
    from score_based_channels_torch.kernels import conv

    rows, B, dt = [], TRAIN_BATCH, torch.float32
    for (H, W, Cin, Cout, k, d, bias, elu), per_fwd in sorted(convs.items()):
        T = len(conv.live_taps(k, d, H, W))
        pad = d * (k // 2)
        x = torch.randn(B, Cin, H, W, generator=g).to("cuda").contiguous(
            memory_format=torch.channels_last)
        w = conv.kernel_layout((torch.randn(Cout, Cin, k, k, generator=g)
                                / (k * k * Cin) ** 0.5).cuda())
        b = torch.randn(Cout, generator=g).cuda() if bias else None
        gout = torch.randn(B, Cout, H, W, generator=g).to("cuda").contiguous(
            memory_format=torch.channels_last)
        wt = conv.transposed_weight(w)
        got = conv.conv2d(gout, wt, None, d)           # the dgrad launch
        xr = x.clone().requires_grad_()
        want, = torch.autograd.grad(
            F.conv2d(xr, w, None, padding=pad, dilation=d), xr, gout)
        err = rel_check(got, want, TOL[("conv", dt)],
                        f"dgrad {(H, W, Cin, Cout, k, d)}")
        fwd = conv.conv2d(x, w, b, d, elu)
        fwd_err = rel_check(fwd, conv.conv2d_plain(x, w, b, d, elu),
                            TOL[("conv", dt)],
                            f"fwd {(H, W, Cin, Cout, k, d)}")
        # no atomics: two launches of each, equal bits
        assert torch.equal(got, conv.conv2d(gout, wt, None, d))
        assert torch.equal(fwd, conv.conv2d(x, w, b, d, elu))
        lib = lambda: torch.ops.aten.convolution_backward(
            gout, x, w, None, [1, 1], [pad, pad], [d, d], False, [0, 0], 1,
            [True, False, False])
        dgrad_bytes = (gout.numel() + T * Cin * Cout + x.numel()) * 4
        fwd_bytes = dgrad_bytes + (Cout if bias else 0) * 4
        flops = 2 * B * H * W * T * Cin * Cout
        rows.append(dict(
            shape=[H, W, Cin, Cout, k, d], bias=bias, elu=elu,
            per_step=per_fwd, dgrad_per_step=0 if Cin == 2 else per_fwd,
            taps=T, dgrad_max_abs_err=err,
            dgrad_rel_err=err / want.abs().max().item(),
            fwd_max_abs_err=fwd_err,
            fwd_ms=cuda_ms(lambda: conv.conv2d(x, w, b, d, elu)),
            fwd_plain_ms=cuda_ms(lambda: conv.conv2d_plain(x, w, b, d, elu)),
            fwd_library_ms=cuda_ms(lambda: F.conv2d(x, w, b, padding=pad,
                                                    dilation=d)),
            fwd_bound_ms=max(fwd_bytes / PEAK_BYTES,
                             flops / PEAK_OPS[dt]) * 1e3,
            dgrad_ms=cuda_ms(lambda: conv.conv2d(gout, wt, None, d)),
            dgrad_plain_ms=cuda_ms(lambda: conv.conv2d_plain(gout, wt, None,
                                                             d)),
            dgrad_library_ms=cuda_ms(lib),
            wgrad_ms=cuda_ms(lambda: conv.conv2d_backward(
                x, w, bias, d, False, None, gout, (False, True, True))),
            dgrad_bound_ms=max(dgrad_bytes / PEAK_BYTES,
                               flops / PEAK_OPS[dt]) * 1e3))
        r = rows[-1]
        print(f"train conv {H}x{W} {Cin}->{Cout} k{k} d{d} x{per_fwd:<2d} "
              f"fwd {r['fwd_ms']:.4f} ms (plain {r['fwd_plain_ms']:.4f}, "
              f"cudnn {r['fwd_library_ms']:.4f}, bound "
              f"{r['fwd_bound_ms']:.4f})  dgrad {r['dgrad_ms']:.4f} (rel_err "
              f"{r['dgrad_rel_err']:.2e}, plain {r['dgrad_plain_ms']:.4f}, "
              f"cudnn {r['dgrad_library_ms']:.4f}, bound "
              f"{r['dgrad_bound_ms']:.4f})  wgrad {r['wgrad_ms']:.4f}",
              flush=True)
    return rows


def train_norm_rows(norms, g):
    """At every norm variant of a training step (batch 32, f32): the kernel
    forward and the closed-form backward, timed."""
    from score_based_channels_torch.kernels import instance_norm as inorm

    rows = []
    for (H, W, C, elu), per_fwd in sorted(norms.items()):
        x = (torch.randn(TRAIN_BATCH, C, H, W, generator=g) * 2 + 0.5).to(
            "cuda").contiguous(memory_format=torch.channels_last)
        a, gm = (1 + 0.02 * torch.randn(2, C, generator=g)).cuda()
        bt = (0.1 * torch.randn(C, generator=g)).cuda()
        out = inorm.instance_norm_plus(x, a, gm, bt, elu)
        gout = torch.randn(x.shape, generator=g).to("cuda")
        rows.append(dict(
            shape=[H, W, C], elu=elu, per_step=per_fwd,
            fwd_ms=cuda_ms(lambda: inorm.instance_norm_plus(x, a, gm, bt, elu)),
            bwd_ms=cuda_ms(lambda: inorm.instance_norm_plus_backward(
                x, a, gm, bt, out, gout, elu))))
    return rows


TRAINED_GRAD_TOL = 1e-3  # norm-wise relative error of each tensor


def pooling(record=None, replay=None):
    """A stand-in for models/layers.py::max_pool_5x5 that appends the
    selections of each call to `record` (indices into H*W, on the CPU)
    or, with `replay`, takes its values at the given selections (a gather,
    whose gradient goes where max pooling's would)."""
    calls = iter(replay or [])

    def pool(x):
        if replay is not None:
            idx = next(calls).to(x.device)
            return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        out, idx = F.max_pool2d(x, 5, stride=1, padding=2,
                                return_indices=True)
        record.append(idx.cpu())
        return out

    return pool


@contextlib.contextmanager
def leaky_branches(record=None, replay=None):
    """models/unet.py's InstanceNorm -> LeakyReLU(0.2) while the block
    runs, appending each call's branch mask (pre-activation > 0) to
    `record`, or taking the slopes from `replay`'s masks in order."""
    from score_based_channels_torch.models import unet

    calls = iter(replay or [])

    def norm_act(x):
        y = F.instance_norm(x, eps=1e-5)
        if replay is not None:
            keep = next(calls).to(y.device)
        else:
            keep = y > 0
            record.append(keep)
        return torch.where(keep, y, 0.2 * y).contiguous(
            memory_format=torch.channels_last)

    saved = unet._norm_act
    unet._norm_act = norm_act
    try:
        yield
    finally:
        unet._norm_act = saved


def trained_gradient_check(model, cfg, x4, labels, noise, sigmas, where):
    """The card's DSM gradient at trained parameters against float64 on
    the CPU, batch 4.

    A max pool (CRPBlock) is piecewise: where two inputs of a window
    nearly tie, f32 and float64 may select different ones, and the
    gradient then goes elsewhere for every implementation (the plain f32
    one included). So the float64 reference (and the plain f32 one,
    reported beside it) replays the card's selections, and each tensor is
    held norm-wise: ||g - g64|| / ||g64|| <= TRAINED_GRAD_TOL. The
    selections of free float64 and f32 CPU runs are compared with the
    card's and reported, with the worst tensor's elementwise distance and
    share of elements off by more than the bar times its max|g64|."""
    from score_based_channels_torch.diffusion.dsm import anneal_dsm_loss
    from score_based_channels_torch.models import layers, make_score_model

    def grads(m, dev, dt, **pool_kw):
        saved = layers.max_pool_5x5
        layers.max_pool_5x5 = pooling(**pool_kw)
        try:
            m.zero_grad()
            anneal_dsm_loss(m, x4.to(dev, dt), sigmas.to(dev, dt),
                            labels=labels.to(dev),
                            noise=noise.to(dev, dt)).backward()
        finally:
            layers.max_pool_5x5 = saved
        return [p.grad.detach().cpu().double() for p in m.parameters()]

    names = [n for n, _ in model.named_parameters()]
    cpu = {dt: make_score_model(cfg.model, device="cpu").to(dt)
           for dt in (torch.float32, torch.float64)}
    for m in cpu.values():
        m.load_state_dict(model.state_dict())
    sel = {"card": [], "free32": [], "free64": []}
    g = {"card": grads(model, next(model.parameters()).device,
                       torch.float32, record=sel["card"]),
         "free32": grads(cpu[torch.float32], "cpu", torch.float32,
                         record=sel["free32"]),
         "free64": grads(cpu[torch.float64], "cpu", torch.float64,
                         record=sel["free64"]),
         "cpu32": grads(cpu[torch.float32], "cpu", torch.float32,
                        replay=sel["card"]),
         "cpu64": grads(cpu[torch.float64], "cpu", torch.float64,
                        replay=sel["card"])}
    model.zero_grad()

    def against(tag, ref):
        rows = []
        for name, a, b in zip(names, g[tag], g[ref]):
            d, scale = (a - b).abs(), b.abs().max().item()
            rows.append(dict(name=name,
                             norm=(torch.linalg.norm(a - b)
                                   / torch.linalg.norm(b)).item(),
                             elem=d.max().item() / scale,
                             share_off=(d > TRAINED_GRAD_TOL * scale)
                             .double().mean().item()))
        return rows

    differ = lambda a, b: sum(int((x != y).sum()) for x, y in
                              zip(sel[a], sel[b]))
    n_sel = sum(x.numel() for x in sel["card"])
    out = dict(selections=n_sel, pools=len(sel["card"]),
               differ={f"{a}/{b}": differ(a, b) for a, b in
                       (("card", "free32"), ("card", "free64"),
                        ("free32", "free64"))})
    for tag, ref in (("card", "cpu64"), ("cpu32", "cpu64"),
                     ("card", "free64"), ("free32", "free64")):
        rows = against(tag, ref)
        out[f"{tag}_vs_{ref}"] = dict(
            worst_norm=max(rows, key=lambda r: r["norm"]),
            worst_elem=max(rows, key=lambda r: r["elem"]))
    print(f"# gradient at the trained parameters ({where}), batch "
          f"{x4.shape[0]}, {len(names)} tensors; max-pool selections that "
          f"differ from the card's, of {n_sel} in {out['pools']} pools: "
          f"{out['differ']}")
    for key in ("card_vs_cpu64", "cpu32_vs_cpu64", "card_vs_free64",
                "free32_vs_free64"):
        wn, we = out[key]["worst_norm"], out[key]["worst_elem"]
        print(f"#   {key:17s} worst norm-wise {wn['norm']:.2e} ({wn['name']});"
              f" worst elementwise {we['elem']:.2e} ({we['name']}, "
              f"{100 * we['share_off']:.3f}% of it off by > "
              f"{TRAINED_GRAD_TOL} max|g64|)")
    worst = out["card_vs_cpu64"]["worst_norm"]
    assert worst["norm"] <= TRAINED_GRAD_TOL, (
        f"card gradient at the trained parameters: {worst['name']} is "
        f"{worst['norm']:.2e} from float64 (norm-wise, tol "
        f"{TRAINED_GRAD_TOL}); {out}")
    return out


def train_phase(convs, norms, card, g, ck_path):
    """Phase 7: `ScoreTrainer.train` (the train-score entry point) on CDL-C
    at full width in f32, its launch counts, the card's gradient against
    the plain CPU gradient, the dgrad kernel against cuDNN's at every
    training conv shape, the checkpoint (written to ck_path) read back and
    run through `run_estimation`, and ms per step."""
    from torch.profiler import ProfilerActivity, profile

    from score_based_channels_torch import _graph, kernels
    from score_based_channels_torch.config import (
        TrainingConfig, default_score_config,
    )
    from score_based_channels_torch.data import ChannelDataset
    from score_based_channels_torch.diffusion.dsm import anneal_dsm_loss
    from score_based_channels_torch.diffusion.ema import ema_update
    from score_based_channels_torch.eval.estimate import (
        run_estimation, score_fn_from_params,
    )
    from score_based_channels_torch.models import (
        jax_params_to_state_dict, make_score_model,
    )
    from score_based_channels_torch.train import ScoreTrainer
    from score_based_channels_torch.train import score as train_score
    from score_based_channels_torch.utils.checkpoint import load_checkpoint

    cfg = default_score_config("CDL-C")
    cfg = cfg.replace(training=TrainingConfig(
        batch_size=TRAIN_BATCH, n_epochs=TRAIN_EPOCHS,
        log_every_steps=TRAIN_LOG_EVERY))
    trainer = ScoreTrainer(cfg, device="cuda")
    n_fwd, n_norm = sum(convs.values()), sum(norms.values())
    kernels.reset_counts()
    train_score.reset_stats()
    _graph.reset_stats()
    t0 = time.perf_counter()
    state, logs = trainer.train(checkpoint_path=ck_path,
                                log_fn=lambda s: print("# " + s))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    n, ng = kernels.counts(), kernels.grad_counts()
    run_stats = dict(train_score.STATS, **_graph.STATS)
    steps = state.step
    n_val = len(logs["val_loss"])
    print(f"# train-score CDL-C, ngf 32, batch {TRAIN_BATCH}, f32: "
          f"{steps} steps + {n_val} validations in {train_s:.2f} s "
          f"(data generation and set-up included); launches {n}; "
          f"gradient work {ng}; the runner {run_stats}")
    assert steps == TRAIN_EPOCHS * (200 // TRAIN_BATCH), steps
    # step 0 eager, one capture, every later step a replay
    assert (run_stats["steps"], run_stats["captures"],
            run_stats["replays"]) == (steps, 1, steps - 1), run_stats
    assert np.isfinite(logs["train_loss"]).all(), logs["train_loss"]
    assert np.isfinite(logs["val_loss"]).all(), logs["val_loss"]
    assert any((p - e).abs().max().item() > 0 for p, e in zip(
        state.model.parameters(), state.ema.parameters()))
    dgrad_per_step = n_fwd - 1  # the begin conv's input takes none
    assert ng == {"conv2d_taps": {"functions": n_fwd * steps,
                                  "dgrad": dgrad_per_step * steps},
                  "instance_norm_plus": {"functions": n_norm * steps,
                                         "backward": n_norm * steps}}, ng
    assert n["conv2d_taps"] == {
        "launches": (n_fwd + dgrad_per_step) * steps + n_fwd * n_val,
        "plain": 0}, n
    assert n["instance_norm_plus"] == {
        "launches": n_norm * (steps + n_val), "plain": 0}, n
    # the steps pool under grad on the library's pool; the validations on
    # the kernel
    pool = n["max_pool_5x5"]
    assert pool["launches"] == 12 * n_val and pool["plain"] == 0 \
        and pool["autograd"] > 0, n
    pool = n["mean_pool_2x2"]
    assert pool["launches"] == 6 * n_val and pool["plain"] == 0 \
        and pool["autograd"] > 0, n

    # the card's gradient against the plain CPU gradient, batch 4, at
    # the run's initial parameters (the first step's); once training
    # has moved the parameters, an f32 gradient's distance from float64
    # can grow for every implementation, the plain one included, so
    # there the card is held against the plain f32 gradient's own
    # distance from float64
    first = trainer.init_state(cfg.training.seed).model
    gg = torch.Generator().manual_seed(11)
    x4 = ChannelDataset(1234, cfg, norm="global").network_input()[
        :GRAD_CHECK_BATCH]
    labels = torch.randint(0, cfg.model.num_classes, (GRAD_CHECK_BATCH,),
                           generator=gg)
    noise = torch.randn(x4.shape, generator=gg)
    cpu = make_score_model(cfg.model, device="cpu")
    cpu.load_state_dict(first.state_dict())
    loss_card = anneal_dsm_loss(first, x4.cuda(), trainer.sigmas,
                                labels=labels.cuda(), noise=noise.cuda())
    loss_card.backward()
    loss_cpu = anneal_dsm_loss(cpu, x4, trainer.sigmas.cpu(),
                               labels=labels, noise=noise)
    loss_cpu.backward()
    worst = (0.0, "")
    for (name, p), q in zip(first.named_parameters(), cpu.parameters()):
        rel = ((p.grad.cpu() - q.grad).abs().max()
               / q.grad.abs().max()).item()
        worst = max(worst, (rel, name))
    loss_rel = abs(loss_card.item() - loss_cpu.item()) / loss_cpu.item()
    print(f"# gradient at the initial parameters, card (kernels) vs CPU "
          f"(plain), batch {GRAD_CHECK_BATCH}: loss rel err {loss_rel:.2e}; worst "
          f"parameter {worst[1]} at {worst[0]:.2e} of its max|g| (tol "
          f"1e-3) over {len(list(cpu.parameters()))} tensors")
    assert loss_rel < 2e-4 and worst[0] <= 1e-3, (loss_rel, worst)
    trained = trained_gradient_check(state.model, cfg, x4, labels, noise,
                                     trainer.sigmas, f"step {steps}")
    state.opt.zero_grad()

    # dgrad / forward / wgrad / norm at every training shape
    conv_rows = train_conv_rows(convs, g)
    norm_rows = train_norm_rows(norms, g)

    # the checkpoint, read back, through the estimate harness
    ck = load_checkpoint(ck_path)
    assert ck["metadata"] == {"steps": steps}
    assert ck["config"].data.source == "cdl"
    est_model = make_score_model(ck["config"].model, device="cuda")
    est_model.load_state_dict(jax_params_to_state_dict(ck["ema"]),
                              strict=True)
    stride = 64
    kernels.reset_counts()
    res = run_estimation(score_fn_from_params(est_model, torch.bfloat16),
                         ck["config"], snr_range=np.array([0., 20.]),
                         num_channels=32, level_stride=stride,
                         init="noise", chunk_size=64, device="cuda")
    est_counts = kernels.counts()
    print(f"# estimate from the saved checkpoint (level_stride {stride}, "
          f"32 CDL-C channels): best NMSE dB "
          f"{np.round(res.best_nmse_db().ravel(), 2).tolist()}; launches "
          f"{est_counts}")
    assert np.isfinite(res.nmse_log).all()
    assert est_counts["conv2d_taps"]["plain"] == 0
    assert est_counts["conv2d_taps"]["launches"] > 0

    # ms per step: forward, backward, optimizer + EMA (synchronised), and
    # steps/s of train_step as the trainer runs it (no synchronisation)
    x_all = ChannelDataset(1234, cfg, norm="global").network_input().cuda()
    gen = torch.Generator(device="cuda")
    phases = {"forward": [], "backward": [], "optimizer_ema": []}
    for i in range(10):
        x = x_all[i * TRAIN_BATCH % 192:][:TRAIN_BATCH]
        gen.manual_seed(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = anneal_dsm_loss(state.model, x, trainer.sigmas, gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state.opt.zero_grad()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        state.opt.step()
        ema_update(state.ema, state.model, cfg.model.ema_rate)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if i >= 2:  # warm
            phases["forward"].append((t1 - t0) * 1e3)
            phases["backward"].append((t2 - t1) * 1e3)
            phases["optimizer_ema"].append((t3 - t2) * 1e3)
    med = {k: float(np.median(v)) for k, v in phases.items()}
    reps = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        trainer.train_step(state, x_all[:TRAIN_BATCH], gen)
    torch.cuda.synchronize()
    steps_per_s = reps / (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3):
            trainer.train_step(state, x_all[:TRAIN_BATCH], gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_ms_by_name(prof)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    per_step = lambda key: sum(r[key] * r["per_step"] for r in conv_rows)
    split = dict(
        conv_fwd_ms=per_step("fwd_ms"),
        conv_fwd_plain_ms=per_step("fwd_plain_ms"),
        conv_fwd_library_ms=per_step("fwd_library_ms"),
        conv_fwd_bound_ms=per_step("fwd_bound_ms"),
        dgrad_ms=sum(r["dgrad_ms"] * r["dgrad_per_step"] for r in conv_rows),
        dgrad_plain_ms=sum(r["dgrad_plain_ms"] * r["dgrad_per_step"]
                           for r in conv_rows),
        dgrad_library_ms=sum(r["dgrad_library_ms"] * r["dgrad_per_step"]
                             for r in conv_rows),
        dgrad_bound_ms=sum(r["dgrad_bound_ms"] * r["dgrad_per_step"]
                           for r in conv_rows),
        wgrad_ms=per_step("wgrad_ms"),
        norm_fwd_ms=sum(r["fwd_ms"] * r["per_step"] for r in norm_rows),
        norm_bwd_ms=sum(r["bwd_ms"] * r["per_step"] for r in norm_rows))
    print(f"# train step, f32 batch {TRAIN_BATCH}, ms (median of 8, "
          f"synchronised): forward {med['forward']:.3f}, backward "
          f"{med['backward']:.3f}, optimizer+EMA {med['optimizer_ema']:.3f}; "
          f"{steps_per_s:.2f} steps/s unsynchronised; on {card}")
    print("# train step, per-call CUDA events x calls a step: " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()))
    print(f"# train profile, 3 steps: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%)" if busy else
          "# train profile: no device time reported (not measured)")
    for name, ms in top:
        print(f"#   {ms / 3:9.3f} ms a step  {name[:90]}")
    graph = train_graph_phase(trainer, card)
    return dict(steps=steps, seconds=train_s, counts=n, grad_counts=ng,
                runner=run_stats, graph=graph,
                train_loss=logs["train_loss"].tolist(),
                val_loss=logs["val_loss"].tolist(), grad_check_worst=worst,
                grad_check_loss_rel=loss_rel, trained_grad=trained,
                conv_rows=conv_rows,
                norm_rows=norm_rows, est_best_nmse_db=
                res.best_nmse_db().ravel().tolist(), phase_ms=med,
                steps_per_s=steps_per_s, split_ms=split,
                profile_wall_ms=wall_ms, profile_busy_ms=busy,
                profile_top=top)


TRAIN_GRAPH_CHANNELS = 64  # 2 steps an epoch at batch 32 ...
TRAIN_GRAPH_EPOCHS = 6     # ... 12 steps in chunks of 5, 5 and 2
TRAIN_GRAPH_LOG_EVERY = 5
TRAIN_TURN_STEPS = 20      # steps a timed run, each way
EAGER_RUN_SPREAD = 1.1e-5  # two eager runs, norm-wise (ROADMAP §3)
QUEUE_WAIT_S = 5e-3        # a run longer than this waited for the card


def train_graph_config(data_parallel=True):
    """CDL-C at full width in f32, batch 32, 64 realizations: 12 steps over
    chunks of 5, 5 and 2 that cross five epoch boundaries."""
    from score_based_channels_torch.config import (
        TrainingConfig, default_score_config,
    )

    cfg = default_score_config("CDL-C")
    return cfg.replace(
        data=dataclasses.replace(cfg.data, num_channels=TRAIN_GRAPH_CHANNELS),
        training=TrainingConfig(batch_size=TRAIN_BATCH,
                                n_epochs=TRAIN_GRAPH_EPOCHS,
                                log_every_steps=TRAIN_GRAPH_LOG_EVERY,
                                data_parallel=data_parallel))


def eager_if(eager):
    """`_graph.eager()` when eager, else a block that changes nothing."""
    from score_based_channels_torch import _graph

    return _graph.eager() if eager else contextlib.nullcontext()


def train_run(cfg, eager=False):
    """(state, logs) of ScoreTrainer.train on cfg, through the captured
    step or (eager) the same steps run eagerly."""
    from score_based_channels_torch.train import ScoreTrainer

    with eager_if(eager):
        return ScoreTrainer(cfg, device="cuda").train(log_fn=lambda s: None)


def train_runs_differ(a, b):
    """(equal bit for bit, the largest norm-wise relative difference over
    the parameter, EMA and moment tensors, the largest relative difference
    over the train and validation losses) of two train_run results."""
    (sa, la), (sb, lb) = a, b
    pairs = [(p, q) for m, n in ((sa.model, sb.model), (sa.ema, sb.ema))
             for p, q in zip(m.parameters(), n.parameters())]
    pairs += [(p, q) for k in sa.opt.moments
              for p, q in zip(sa.opt.moments[k], sb.opt.moments[k])]
    same = (all(torch.equal(p, q) for p, q in pairs)
            and sa.opt.count == sb.opt.count and sa.step == sb.step
            and all(np.array_equal(la[k], lb[k])
                    for k in ("train_loss", "val_loss")))
    norm = max(float(torch.linalg.norm(p - q) / torch.linalg.norm(q))
               for p, q in pairs if torch.linalg.norm(q) > 0)
    loss = max(float(np.max(np.abs(la[k] - lb[k]) / np.abs(lb[k])))
               for k in ("train_loss", "val_loss"))
    return same, norm, loss


def train_graph_phase(trainer, card):
    """The training graph (in phase 7), full width, f32, batch 32: two
    `ScoreTrainer.train` runs from one seed, through the captured step and
    through the eager loop, equal bit for bit under deterministic
    algorithms (12 steps over chunks of 5, 5 and 2 and five epoch
    boundaries), and their largest difference without; then on one state,
    runs of TRAIN_TURN_STEPS steps in turns (eager, graph, graph, eager),
    synchronised, after the capture; the host's time a replay with the card
    held by a spin kernel (a graph run of every step; an eager run of one
    step beside it); the device busy share of a 3-step profiler window each
    way and the top device ops a step under the graph; the capture's
    seconds and the graph pool's MB."""
    from score_based_channels_torch import _graph
    from score_based_channels_torch.data import ChannelDataset
    from score_based_channels_torch.kernels.launch_cost import spin_cycles
    from score_based_channels_torch.train import TrainChunkRunner
    from score_based_channels_torch.train.score import matmul_precision

    cfg = train_graph_config()
    with deterministic_algorithms():
        det = train_runs_differ(train_run(cfg), train_run(cfg, eager=True))
    eager_run = train_run(cfg, eager=True)
    free = train_runs_differ(train_run(cfg), eager_run)
    spread = train_runs_differ(train_run(cfg, eager=True), eager_run)
    print(f"# train graph vs eager loop, full width f32, {TRAIN_GRAPH_EPOCHS}"
          f" epochs of {TRAIN_GRAPH_CHANNELS // TRAIN_BATCH} steps in chunks "
          f"of {TRAIN_GRAPH_LOG_EVERY}: under deterministic algorithms "
          f"bit-equal {det[0]} (parameters, EMA, moments, count, losses; "
          f"largest norm-wise {det[1]:.2e}); without, largest norm-wise "
          f"difference {free[1]:.2e}, losses {free[2]:.2e}; two eager runs "
          f"of the same 12 steps {spread[1]:.2e}, losses {spread[2]:.2e} "
          f"(after 2 steps: up to {EAGER_RUN_SPREAD:g})", flush=True)
    assert det[0], det

    # in turns on one state: the runners share its optimizer table
    state = trainer.init_state(0)
    x_all = ChannelDataset(1234, trainer.config,
                           norm=trainer.config.data.norm_channels
                           ).network_input().cuda()
    n = TRAIN_TURN_STEPS
    gi = torch.Generator().manual_seed(3)
    idx = torch.stack([torch.randperm(x_all.shape[0], generator=gi)
                       [:TRAIN_BATCH] for _ in range(n)]).cuda()
    seeds = list(range(n))
    gen = torch.Generator(device="cuda")
    with matmul_precision("highest"):
        _graph.reset_stats()
        graph = TrainChunkRunner(trainer.update, state, x_all, TRAIN_BATCH,
                                 n, gen, 20 * n)
        eager = TrainChunkRunner(trainer.update, state, x_all, TRAIN_BATCH,
                                 n, gen, 20 * n)
        _, first_s = timed(lambda: graph.run(idx, seeds))
        stats = dict(_graph.STATS)
        rec, rec_grad = graph.replayer.cap.launches, graph.replayer.cap.grad
        print(f"#   first graph run of {n} steps {first_s:.3f} s (step 0 "
              f"eager, capture {stats['capture_seconds']:.3f} s, graph pool "
              f"{stats['pool_bytes'] / 2**20:.1f} MB); a replay records "
              f"{rec['conv2d_taps']} conv + {rec['instance_norm_plus']} norm "
              f"launches, gradient work {rec_grad}", flush=True)
        assert rec["conv2d_taps"] == 225 and rec["instance_norm_plus"] == 25
        assert rec_grad == {"conv2d_taps": {"functions": 113, "dgrad": 112},
                            "instance_norm_plus": {"functions": 25,
                                                   "backward": 25}}, rec_grad
        def eager_run(idx, seeds):
            with _graph.eager():
                return eager.run(idx, seeds)

        runs = {"eager": lambda: eager_run(idx, seeds),
                "graph": lambda: graph.run(idx, seeds)}
        secs = {"eager": [], "graph": []}
        for way in ("eager", "graph", "graph", "eager"):
            secs[way].append(timed(runs[way])[1])
        sps = {k: [n / v for v in vs] for k, vs in secs.items()}
        print(f"#   steps/s in turns (eager, graph, graph, eager), {n} steps "
              f"a run, synchronised: eager {[round(v, 3) for v in sps['eager']]}"
              f", graph {[round(v, 3) for v in sps['graph']]} on {card}")

        # the host's time with the card held by a spin: n graph runs of
        # one step, each timed on its own. A replay of the step's ~1,700
        # launches takes many entries of the launch queue (some ten
        # replays fill it on an H100): once the replays queued behind
        # the spin fill it, each run waits for a replay to finish (a
        # step's card time). So the host's own time a replay is the median
        # of the runs before the first that waits, and the count of those
        # is how many replays the queue holds. Then one eager step, whose
        # ~1,700 launches fill the queue too.
        cycles = spin_cycles(GRAPH_HOLD_MS)
        host, held = {"eager": [], "graph": []}, {"eager": [], "graph": []}
        for way in ("graph", "eager", "graph"):
            torch.cuda.synchronize()
            torch.cuda._sleep(cycles)
            times = []
            for i in range(n if way == "graph" else 1):
                t0 = time.perf_counter()
                (graph.run if way == "graph" else eager_run)(
                    idx[i:i + 1], seeds[i:i + 1])
                times.append(time.perf_counter() - t0)
            held[way].append(not torch.cuda.current_stream().query())
            host[way].append(times)
            torch.cuda.synchronize()
        queued = [next((i for i, t in enumerate(ts) if t > QUEUE_WAIT_S),
                       len(ts)) for ts in host["graph"]]
        us_step = {"graph": [float(np.median(ts[:q])) * 1e6 for ts, q in
                             zip(host["graph"], queued)],
                   "eager": [ts[0] * 1e6 for ts in host["eager"]]}
        print(f"#   host time a step, card held ({GRAPH_HOLD_MS:.0f} ms spin; "
              f"held after the runs {held}): graph, one-step runs, median "
              f"{[round(v, 1) for v in us_step['graph']]} us a replay over "
              f"the {queued} runs before the first that waited for the "
              f"launch queue (of {n}; the others: the card's step time); "
              f"eager, a run of 1 step "
              f"{[round(v, 1) for v in us_step['eager']]} us")
        assert all(held["graph"]) and min(queued) > 0, (held, queued)

        windows = {}
        for way, run in (("eager", eager_run), ("graph", graph.run)):
            wall_ms, busy, top = busy_window(lambda: run(idx[:3], seeds[:3]))
            windows[way] = dict(wall_ms=wall_ms, busy_ms=busy, top=top)
            print(f"#   profile, 3 steps, {way}: wall {wall_ms:.1f} ms, "
                  f"device busy {busy:.1f} ms ({100 * busy / wall_ms:.1f}%)"
                  if busy else f"#   profile, 3 steps, {way}: no device "
                  f"time reported (not measured)")
        for name, ms in windows["graph"]["top"]:
            print(f"#     {ms / 3:9.3f} ms a step  {name[:90]}")
    return dict(bit_equal_deterministic=det[0], det_norm=det[1],
                free_norm=free[1], free_loss=free[2], eager_spread_norm=
                spread[1], eager_spread_loss=spread[2], first_run_seconds=
                first_s, stats=stats, recorded=rec, recorded_grad=rec_grad,
                seconds=secs, steps_per_s=sps, host_seconds_held=host,
                host_us_per_step_held=us_step, held=held,
                replays_queued=queued, windows=windows)


EVAL_LEVELS = 24       # levels of the tuner's and MMSE's schedule ...
EVAL_STRIDE = 100      # ... every 100th of the 2311: sigma 39.15 to 3.9e-4
TUNE_ALPHAS = (3e-11, 1e-10)
TUNE_BETAS = (0.01, 0.001)
TUNE_SNRS = np.array([0.0, 10.0, 20.0])
TUNE_CHANNELS = 32
TUNE_CHUNK = 192
MMSE_SNRS = np.array([0.0, 20.0])
MMSE_AVG = 16
MMSE_CHANNELS = 8
REF_CHANNELS = (0, 1)  # the channels run again on the CPU, per SNR point
REF_RTOL = 1e-3        # card vs CPU on the sampler's NMSE at beta = 0


def db_gap(a, b):
    """Largest |10 log10(a / b)| over SNR points, in dB."""
    return float(np.max(np.abs(10 * np.log10(np.asarray(a) / np.asarray(b)))))


def rounded(v, nd=2):
    """A list of Python floats rounded to nd places, for printing."""
    return [round(float(x), nd) for x in np.ravel(v)]


def timed(fn):
    """(result, seconds) of fn() on the host clock, the card synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def counting(score_fn, calls):
    """score_fn that adds one to calls[0] at each Python call."""
    def fn(x, s):
        calls[0] += 1
        return score_fn(x, s)
    return fn


def reset_stats():
    """Zero the posterior runner's counts and the graph counts."""
    from score_based_channels_torch import _graph
    from score_based_channels_torch.diffusion import sampling

    sampling.reset_stats()
    _graph.reset_stats()


def graph_forwards(calls, runs, steps=3):
    """The forwards the posterior runner ran since `reset_stats()`, held to
    its graph: `runs` runners (one a `langevin_chunked` call), each one
    eager level and one capture (so 2 x steps Python calls of the score
    function in all, `calls`), every other level a replay."""
    from score_based_channels_torch import _graph
    from score_based_channels_torch.diffusion import sampling

    st = dict(sampling.STATS, **_graph.STATS)
    assert st["captures"] == runs, st
    assert st["replays"] == st["levels"] - runs, st
    assert st["forwards"] == steps * st["levels"], st
    assert calls == 2 * steps * runs, (calls, st)
    return st["forwards"]


def in_turns(plain, graph, what, rate=None):
    """plain, graph, graph, plain, the card synchronised around each run:
    ({"plain": [s, s], "graph": [s, s]}, the first result of each way).
    `plain` is the eager yardstick (`_graph.eager()` or the baselines'
    Python loops). rate(seconds) -> full-schedule est/s, printed beside
    the seconds."""
    secs = {"plain": [], "graph": []}
    first = {}
    order = ("plain", "graph", "graph", "plain")
    for way in order:
        out, sec = timed(plain if way == "plain" else graph)
        secs[way].append(sec)
        first.setdefault(way, out)
    seq = [secs["plain"][0], *secs["graph"], secs["plain"][1]]
    line = ", ".join(f"{v:.4f}" for v in seq) + " s"
    if rate is not None:
        line += "; full-schedule est/s " + ", ".join(
            f"{rate(v):.4f}" for v in seq)
    print(f"#   {what} in turns (plain, graph, graph, plain): {line}")
    return secs, first


BASELINE_SNRS = np.arange(-10, 35, 5)  # the commands' grid: 9 SNRs ...
BASELINE_CHANNELS = 50                  # ... x 50 channels = 450 rows


def baseline_graph_phase(card):
    """The baselines' graphs (in phase 8): FISTA (`fista_l1_lifted`, 1,000
    iterations, lambda 0.3, lr 3e-3) and EM-GM-AMP (`em_gm_amp`, 50
    iterations, K = 3) on the `lasso` and `amp` commands' batch (CDL-C
    test channels made as their runners make them, 9 SNRs x 50 channels,
    64x16, 38 pilots, lift 4), each through its captured iteration and its
    plain loop (`*_plain`): the estimate and the trace equal bit for bit;
    whole runs in turns (plain, graph, graph, plain) as iterations/s; a
    run of 2 iterations through the graph (the eager first one, the
    capture, one replay); the busy share and largest kernels of a whole
    run each way in a profiler window."""
    from score_based_channels_torch import cplx, physics
    from score_based_channels_torch.baselines import amp, lasso
    from score_based_channels_torch.config import default_score_config
    from score_based_channels_torch.data import ChannelDataset

    data = default_score_config("CDL-C").data
    train = ChannelDataset(1234, data, norm="global")
    S, C = len(BASELINE_SNRS), BASELINE_CHANNELS
    X = ChannelDataset(4321, dataclasses.replace(
        data, spacing_list=(0.5,), num_channels=max(C, data.num_channels)),
        norm=list(train.norm_stats), num_pilots=38).hermitian_c2()[:C]
    g = torch.Generator().manual_seed(11)
    A = cplx.conj_transpose(cplx.qpsk_pilots(g, C, 64, 38)).repeat(S, 1, 1, 1)
    X = X.repeat(S, 1, 1, 1)
    npow = torch.from_numpy(np.repeat(10.0 ** (-BASELINE_SNRS / 10.0) * 64,
                                      C).astype(np.float32))
    A, X, Y = (t.cuda() for t in (A, X, physics.measure_c2(g, A, X, npow)))
    L2, R2 = (cplx.from_complex(d).cuda()
              for d in lasso.lifted_fourier_dicts(64, 16, 4))
    ways = {
        "lasso": (1000, lambda f, n: f(A, Y, L2, R2, 0.3, 3e-3, num_iters=n,
                                       oracle2=X),
                  lasso.fista_l1_lifted, lasso.fista_l1_lifted_plain),
        "amp": (50, lambda f, n: f(A, Y, L2, R2, num_iters=n, oracle2=X),
                amp.em_gm_amp, amp.em_gm_amp_plain)}
    out = {}
    for name, (iters, call, graph_fn, plain_fn) in ways.items():
        graph = lambda n=iters: call(graph_fn, n)
        plain = lambda n=iters: call(plain_fn, n)
        caps = []
        with captures_made(caps):
            got = graph()
        want = plain()
        same = [same_bits(a, b) for a, b in zip(got, want)]
        print(f"# eval {name} graph, {S * C} rows x {iters} iterations: "
              f"estimate and trace bit-equal to the plain loop {same}; "
              f"final NMSE {10 * np.log10(float(got[1][-1].nanmean())):.3f} "
              f"dB; {len(caps)} captures of "
              f"{rounded([c.seconds for c in caps], 4)} s, graph pools "
              f"{rounded([c.pool_bytes / 2**20 for c in caps], 1)} MB on "
              f"{card}", flush=True)
        assert all(same), (name, same)
        secs, _ = in_turns(plain, graph, f"eval {name}, plain loop and graph")
        rate = {k: [iters / v for v in vs] for k, vs in secs.items()}
        _, two_s = timed(lambda: graph(2))
        print(f"#   iterations/s: plain {rounded(rate['plain'])}, graph "
              f"{rounded(rate['graph'])}; a graph run of 2 iterations "
              f"(eager, capture, one replay) {two_s:.4f} s")
        windows = {}
        for way, fn in (("plain", plain), ("graph", graph)):
            wall, busy, top = busy_window(fn)
            windows[way] = dict(wall_ms=wall, busy_ms=busy, top=top)
            print(f"#   profile, one run of {iters} iterations, {way}: wall "
                  f"{wall:.1f} ms ({wall / iters:.4f} a iteration), device "
                  f"busy {busy:.1f} ms ({100 * busy / wall:.1f}%)")
            for k, ms in top[:10]:
                print(f"#     {ms / iters:9.4f} ms a iteration  {k[:80]}")
        out[name] = dict(rows=S * C, iterations=iters, bit_equal=same,
                         capture_seconds=[c.seconds for c in caps],
                         pool_bytes=[c.pool_bytes for c in caps],
                         seconds=secs, iterations_per_s=rate,
                         two_iteration_seconds=two_s, windows=windows)
    return out


def eval_phase(ck_path, card):
    """Phase 8: the paper's comparison side at full width. ls, lasso and
    amp at their defaults on the card, held per SNR against the CPU on the
    same draws (made on the CPU): ls whole, lasso and amp on REF_CHANNELS
    (each row is solved on its own); the tuner and posterior-averaging
    MMSE from the train phase's checkpoint (NCSNv2-Deepest, ngf 32) on
    every EVAL_STRIDE-th level of the schedule, with their launch counts,
    and each again for a slice of chains at beta = 0 (deterministic) on
    the card and the CPU; the tuner's slim table driving `run_estimation`
    (train -> tune -> estimate); `lmmse --cov analytic` on the host."""
    import contextlib
    import io

    from score_based_channels_torch import _graph, kernels
    from score_based_channels_torch.baselines.amp import run_amp_baseline
    from score_based_channels_torch.baselines.lasso import run_lasso_baseline
    from score_based_channels_torch.baselines.lmmse import main as lmmse_main
    from score_based_channels_torch.baselines.ls import run_ls_baseline
    from score_based_channels_torch.baselines.mmse import run_mmse_estimation
    from score_based_channels_torch.config import default_score_config
    from score_based_channels_torch.eval.estimate import (
        load_score_fn, run_estimation,
    )
    from score_based_channels_torch.eval.tune import run_hparam_search

    out = {}
    cfg = default_score_config("CDL-C")

    def launches_per_forward(nfe):
        n = kernels.counts()
        assert n["conv2d_taps"] == {"launches": 113 * nfe, "plain": 0}, n
        assert n["instance_norm_plus"] == {"launches": 25 * nfe,
                                           "plain": 0}, n
        return n

    def graph_vs_plain(what, run, values, got, n_chains):
        """run() in turns eagerly (`_graph.eager()`) and through the graph;
        values() of `got` (the counted graph run) and of the turns' first
        graph run against the first eager run's: equal bits, or within
        1e-5 of max|eager|. Capture seconds and pool MB of the counted
        run."""
        graph = dict(_graph.STATS)

        def plain():
            with _graph.eager():
                return run()

        secs, first = in_turns(
            plain, run, f"eval {what}, eager runner and graph",
            rate=lambda v: n_chains / v * EVAL_LEVELS / 2311)
        ref = values(first["plain"])
        same = [np.array_equal(values(r), ref) for r in (got, first["graph"])]
        diff = float(np.abs(values(got) - ref).max() / np.abs(ref).max())
        print(f"#   eval {what}: graph vs eager runner NMSE bit-equal {same} "
              f"(counted and next graph run), max rel diff {diff:.2e} (tol "
              f"1e-5); capture {graph['capture_seconds']:.3f} s, graph "
              f"pool {graph['pool_bytes'] / 2**20:.1f} MB")
        assert diff <= 1e-5, (what, diff)
        return dict(turns=secs, graph=graph, plain_equal=same,
                    plain_max_rel_diff=diff)

    def amp_best(r, c):
        """AMPResults.best_db over channels c, as a power ratio."""
        avg = r.nmse_trace[..., c].mean(-1)
        return np.where(np.isfinite(avg), avg, np.inf).min(-1)

    # -- baselines at their defaults, card vs CPU ----------------------------
    chans = list(REF_CHANNELS)
    for name, run, per_snr, tol, ref_kw in (
            ("ls", run_ls_baseline,
             lambda r, c: r.nmse[..., c].mean(-1).ravel(), 0.01, {}),
            ("lasso", run_lasso_baseline,
             lambda r, c: r.nmse_log[..., c].mean(-1).ravel(), 0.05,
             dict(_channels=chans)),
            ("amp", run_amp_baseline, amp_best, 0.1,
             dict(_channels=chans))):
        kernels.reset_counts()
        res, sec = timed(lambda: run(cfg))
        n = kernels.counts()
        ref, sec_cpu = timed(lambda: run(cfg, device="cpu", **ref_kw))
        card_c = slice(None) if not ref_kw else chans
        got, want = per_snr(res, card_c), per_snr(ref, slice(None))
        full = per_snr(res, slice(None))
        gap = db_gap(got, want)
        snrs = res.snr_range
        on_cpu = ("all channels" if not ref_kw else
                  f"channels {chans} of each SNR point")
        print(f"# eval {name} (defaults: {len(snrs)} SNRs x 50 channels): "
              f"{sec:.2f} s on the card, {sec_cpu:.2f} s on the CPU for "
              f"{on_cpu} (data made on the host included); NMSE dB per SNR "
              f"{rounded(10 * np.log10(full))} at {snrs.tolist()}; largest "
              f"card-CPU gap on {on_cpu} {gap:.6f} dB (tol {tol}); "
              f"launches {n}; on {card}")
        assert np.isfinite(full).all() and gap <= tol, (name, gap)
        out[name] = dict(seconds=sec, seconds_cpu=sec_cpu, snr=snrs.tolist(),
                         nmse_db=rounded(10 * np.log10(full), 6),
                         ref_channels=None if not ref_kw else chans,
                         nmse_db_ref_card=rounded(10 * np.log10(got), 6),
                         nmse_db_ref_cpu=rounded(10 * np.log10(want), 6),
                         gap_db=gap, launches=n)

    out["graph"] = baseline_graph_phase(card)

    # -- tune from the trained checkpoint ------------------------------------
    config, score32 = load_score_fn(ck_path, "cuda")
    _, score_cpu = load_score_fn(ck_path, "cpu")
    config = config.replace(model=dataclasses.replace(  # a cut in depth
        config.model, num_classes=EVAL_LEVELS,
        sigma_rate=config.model.sigma_rate ** EVAL_STRIDE))
    cut = (f"every {EVAL_STRIDE}th level, {EVAL_LEVELS} levels, sigma "
           f"{config.model.sigma_begin:.2f} to {config.model.sigma_end:.2e}")

    def card_vs_cpu(what, run, values):
        """run(score_fn, device) on the card and on the CPU (the same
        draws); holds values(result) within REF_RTOL. Returns the CPU's
        result and the comparison's numbers."""
        got, sec = timed(lambda: run(score32, "cuda"))
        want, sec_cpu = timed(lambda: run(score_cpu, "cpu"))
        a, b = values(got), values(want)
        assert np.isfinite(b).all(), what
        rel = float(np.max(np.abs(a - b) / np.abs(b)))
        print(f"# eval {what} card vs CPU (beta 0, channels "
              f"{list(REF_CHANNELS)}): largest relative NMSE difference "
              f"{rel:.2e} (tol {REF_RTOL}); {sec:.2f} s on the card, "
              f"{sec_cpu:.2f} s on the CPU")
        assert rel <= REF_RTOL, (what, rel)
        return want, dict(rel=rel, seconds=sec, seconds_cpu=sec_cpu)
    n_chains = (len(TUNE_ALPHAS) * len(TUNE_BETAS) * len(TUNE_SNRS)
                * TUNE_CHANNELS)
    calls = [0]

    def tune(score_fn):
        return run_hparam_search(
            score_fn, config, snr_range=TUNE_SNRS,
            alpha_step_range=TUNE_ALPHAS, beta_noise_range=TUNE_BETAS,
            num_channels=TUNE_CHANNELS, chunk_size=TUNE_CHUNK, device="cuda")

    kernels.reset_counts()
    reset_stats()
    tune_res, sec = timed(lambda: tune(counting(score32, calls)))
    nfe = graph_forwards(calls[0], runs=1)
    n = launches_per_forward(nfe)
    assert nfe == -(-n_chains // TUNE_CHUNK) * EVAL_LEVELS * 3, nfe
    assert np.isfinite(tune_res.nmse_log).all()
    vs_plain = graph_vs_plain("tune", lambda: tune(score32),
                              lambda r: r.nmse_log, tune_res, n_chains)
    best_db = 10 * np.log10(tune_res.best_nmse.min(axis=(0, 1)))
    avg = tune_res.avg_nmse  # the selection is the argmin of the log
    for s in range(len(TUNE_SNRS)):
        iA, iB, step = np.unravel_index(int(np.argmin(avg[:, :, s])),
                                        avg[:, :, s].shape)
        assert (TUNE_ALPHAS[iA], TUNE_BETAS[iB], step) == (
            tune_res.best_alpha_snr[s], tune_res.best_beta_snr[s],
            tune_res.best_step_snr[s]), s
    rate = n_chains / sec
    print(f"# eval tune ({len(TUNE_ALPHAS)}x{len(TUNE_BETAS)} grid x "
          f"{len(TUNE_SNRS)} SNRs x {TUNE_CHANNELS} channels = {n_chains} "
          f"chains in chunks of {TUNE_CHUNK}, f32 network, {cut}): "
          f"{sec:.2f} s, {nfe} forwards, {rate:.1f} est/s on the "
          f"cut schedule ({rate * EVAL_LEVELS / 2311:.4f} full-schedule); "
          f"best NMSE dB per SNR {rounded(best_db)}; selection "
          f"alpha {tune_res.best_alpha_snr.tolist()} beta "
          f"{tune_res.best_beta_snr.tolist()} step "
          f"{tune_res.best_step_snr.tolist()}; blind "
          f"{tune_res.blind_selection()}; launches {n}")
    out["tune"] = dict(seconds=sec, forwards=nfe, est_per_s=rate,
                       est_per_s_full=rate * EVAL_LEVELS / 2311,
                       **vs_plain,
                       best_nmse_db=rounded(best_db, 6),
                       best_alpha=tune_res.best_alpha_snr.tolist(),
                       best_beta=tune_res.best_beta_snr.tolist(),
                       best_step=tune_res.best_step_snr.tolist(),
                       blind=list(tune_res.blind_selection()))
    ref, out["tune_ref"] = card_vs_cpu(
        "tune", lambda fn, dev: run_hparam_search(
            fn, config, snr_range=TUNE_SNRS, alpha_step_range=TUNE_ALPHAS[:1],
            beta_noise_range=(0.0,), num_channels=len(REF_CHANNELS),
            device=dev), lambda r: r.nmse_log)
    trace_db = 10 * np.log10(ref.avg_nmse[0, 0])  # (S, steps)
    print(f"#   its NMSE dB per SNR from the init {rounded(trace_db[:, 0])} "
          f"to the last step {rounded(trace_db[:, -1])}")
    out["tune_ref"].update(init_db=rounded(trace_db[:, 0], 6),
                           last_db=rounded(trace_db[:, -1], 6))

    # -- train -> tune -> estimate: the slim table drives run_estimation ------
    with tempfile.TemporaryDirectory() as tmp:
        slim = os.path.join(tmp, "hyperparameters.npz")
        tune_res.save_slim(slim)
        with np.load(slim) as h:
            table = {k: h[k] for k in h.files}
    _, score16 = load_score_fn(ck_path, "cuda", dtype=torch.bfloat16)
    calls = [0]
    kernels.reset_counts()
    reset_stats()
    est, sec = timed(lambda: run_estimation(
        counting(score16, calls), config, snr_range=table["snr_range"],
        num_channels=TUNE_CHANNELS, alpha_step=table["best_alpha_snr"],
        beta_noise=table["best_beta_snr"], stop_steps=table["best_step_snr"],
        init="noise", chunk_size=TUNE_CHUNK, device="cuda"))
    n = launches_per_forward(graph_forwards(calls[0], runs=1))
    known = [float(10 * np.log10(est.avg_nmse[0, 0, s, int(st)]))
             for s, st in enumerate(table["best_step_snr"])]
    assert np.isfinite(est.nmse_log).all()
    print(f"# eval estimate --hparams (the tuner's slim table, per-SNR "
          f"alpha/beta, bf16 network, init noise, {TUNE_CHANNELS} channels): "
          f"{sec:.2f} s; known-SNR stop NMSE dB {rounded(known)}"
          f"; launches {n}")
    out["estimate_hparams"] = dict(seconds=sec, known_stop_db=known)

    # -- posterior-averaging MMSE --------------------------------------------
    rows = [int(np.flatnonzero(TUNE_SNRS == s)[0]) for s in MMSE_SNRS]
    stop = table["best_step_snr"][rows]
    n_chains = MMSE_AVG * len(MMSE_SNRS) * MMSE_CHANNELS

    def mmse_run(score_fn):
        return run_mmse_estimation(
            score_fn, config, snr_range=MMSE_SNRS,
            num_channels=MMSE_CHANNELS, mmse_avg=MMSE_AVG, init="ls",
            stop_step=stop, coef_cap="auto", chunk_size=n_chains,
            device="cuda")

    calls = [0]
    kernels.reset_counts()
    reset_stats()
    mmse, sec = timed(lambda: mmse_run(counting(score32, calls)))
    nfe = graph_forwards(calls[0], runs=1)
    n = launches_per_forward(nfe)
    assert nfe == EVAL_LEVELS * 3, nfe  # one chunk
    vs_plain = graph_vs_plain(
        "mmse", lambda: mmse_run(score32),
        lambda r: np.stack([r.nmse_single, r.nmse_mean_est]), mmse, n_chains)
    mean_db, single_db = (10 * np.log10(v.mean(-1)) for v in
                          (mmse.nmse_mean_est, mmse.nmse_single))
    assert np.isfinite(mmse.nmse_mean_est).all()
    assert mean_db[-1] <= single_db[-1], (mean_db, single_db)
    rate = n_chains / sec
    print(f"# eval mmse (init ls, coef_cap auto, stop steps "
          f"{stop.tolist()}, {MMSE_AVG} samples x {len(MMSE_SNRS)} SNRs x "
          f"{MMSE_CHANNELS} channels = {n_chains} chains, f32 network, "
          f"{cut}): "
          f"{sec:.2f} s, {rate:.1f} est/s on the cut schedule "
          f"({rate * EVAL_LEVELS / 2311:.4f} full-schedule); NMSE dB of the "
          f"average {rounded(mean_db, 5)}, of one sample "
          f"{rounded(single_db, 5)} at {MMSE_SNRS.tolist()}; "
          f"launches {n}")
    out["mmse"] = dict(seconds=sec, est_per_s=rate,
                       est_per_s_full=rate * EVAL_LEVELS / 2311,
                       **vs_plain,
                       mean_db=rounded(mean_db, 6),
                       single_db=rounded(single_db, 6))
    _, out["mmse_ref"] = card_vs_cpu(
        "mmse", lambda fn, dev: run_mmse_estimation(
            fn, config, snr_range=MMSE_SNRS, num_channels=len(REF_CHANNELS),
            mmse_avg=2, init="ls", stop_step=stop, coef_cap="auto",
            beta_noise=0.0, device=dev),
        lambda r: np.stack([r.nmse_mean_est, r.nmse_single]))

    # -- lmmse --cov analytic (host solves, measurements on the card) --------
    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        lm_out = os.path.join(tmp, "lmmse.npz")
        with contextlib.redirect_stdout(buf):
            _, sec = timed(lambda: lmmse_main([
                "--cov", "analytic", "--train", "CDL-C", "--snr", "0", "10",
                "--num_channels", "10", "--output", lm_out]))
        with np.load(lm_out) as f:
            lm_db = 10 * np.log10(f["nmse"].mean(-1))
            pred_db = 10 * np.log10(f["predicted"])
    assert np.isfinite(lm_db).all() and np.all(np.abs(lm_db - pred_db) < 3)
    print(f"# eval lmmse --cov analytic (CDL-C, 10 channels): {sec:.2f} s; "
          f"NMSE dB {rounded(lm_db)} (predicted {rounded(pred_db)}) at "
          f"[0, 10]")
    out["lmmse"] = dict(seconds=sec, nmse_db=rounded(lm_db, 6),
                        predicted_db=rounded(pred_db, 6))
    return out


def max_rel(got, want):
    """max|got - want| / max|want| of two tensors or arrays, on the host."""
    got, want = (torch.as_tensor(np.asarray(t.cpu() if torch.is_tensor(t)
                                            else t)).double()
                 for t in (got, want))
    return ((got - want).abs().max() / want.abs().max()).item()


ARCH_TRAIN_BATCH = 32
ARCH_EST_STRIDE = 256   # every 256th level of the 2311: 10 levels


def archs_phase(deepest_convs, deepest_norms, g):
    """Phase 9: NCSNv2 and NCSNv2Deeper at the config's ngf 32 from a seed:
    each conv and norm shape that NCSNv2-Deepest's census lacks, held
    against its plain version at batch 256 in f32 and bf16 and timed
    beside cuDNN; the kernel forward against the plain CPU forward at
    batch 16 with its launch counts; `ScoreTrainer` with
    arch="ncsnv2_deeper" (one epoch at batch 32) and `run_estimation`
    from its checkpoint on every 256th level."""
    from score_based_channels_torch import kernels
    from score_based_channels_torch.config import (
        ModelConfig, TrainingConfig, default_score_config,
    )
    from score_based_channels_torch.eval.estimate import (
        load_score_fn, run_estimation,
    )
    from score_based_channels_torch.models import make_score_model
    from score_based_channels_torch.train import ScoreTrainer

    out = {}
    for arch in ("ncsnv2", "ncsnv2_deeper"):
        model = make_score_model(ModelConfig(arch=arch), device="cuda",
                                 generator=g)
        convs, norms = census(model)
        n_conv, n_norm = sum(convs.values()), sum(norms.values())
        new_c = {k: v for k, v in convs.items() if k not in deepest_convs}
        new_n = {k: v for k, v in norms.items() if k not in deepest_norms}
        n_params = sum(p.numel() for p in model.parameters())
        print(f"# {arch}: {n_params} parameters; {n_conv} convs and "
              f"{n_norm} norms a forward; shapes new to the kernels: "
              f"{len(new_c)} conv, {len(new_n)} norm", flush=True)
        conv_rows = check_convs(new_c, g)
        norm_rows = check_norms(new_n, g, summary=False)
        x = torch.randn(16, 64, 16, 2, generator=g)
        sig = torch.rand(16, generator=g) * 2 + 0.05
        cpu = make_score_model(ModelConfig(arch=arch), device="cpu")
        cpu.load_state_dict(model.state_dict())
        with torch.no_grad():
            want = cpu(x, sig)
            kernels.reset_counts()
            got = model(x.cuda(), sig.cuda())
            n = kernels.counts()
        err = max_rel(got, want)
        print(f"# {arch} forward, kernels on the card vs plain on the CPU, "
              f"batch 16, f32: max rel err {err:.2e} (tol 2e-4); launches "
              f"{n}")
        assert err < 2e-4, (arch, err)
        assert n["conv2d_taps"] == {"launches": n_conv, "plain": 0}, n
        assert n["instance_norm_plus"] == {"launches": n_norm, "plain": 0}, n
        out[arch] = dict(params=n_params, convs=n_conv, norms=n_norm,
                         conv_rows=conv_rows, norm_rows=norm_rows,
                         forward_rel_err=err, forward_counts=n)

    arch = "ncsnv2_deeper"
    n_conv, n_norm = out[arch]["convs"], out[arch]["norms"]
    cfg = default_score_config("CDL-C")
    cfg = cfg.replace(model=ModelConfig(arch=arch), training=TrainingConfig(
        batch_size=ARCH_TRAIN_BATCH, n_epochs=1, log_every_steps=6))
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "deeper.npz")
        kernels.reset_counts()
        t0 = time.perf_counter()
        state, logs = ScoreTrainer(cfg, device="cuda").train(
            checkpoint_path=ck, log_fn=lambda s: print("# " + s))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        n, ng = kernels.counts(), kernels.grad_counts()
        steps, n_val = state.step, len(logs["val_loss"])
        print(f"# train-score arch {arch}, batch {ARCH_TRAIN_BATCH}, f32: "
              f"{steps} steps + {n_val} validation in {train_s:.2f} s "
              f"(data generation included); launches {n}; gradient work "
              f"{ng}")
        assert steps == 200 // ARCH_TRAIN_BATCH, steps
        assert np.isfinite(logs["train_loss"]).all()
        assert ng["conv2d_taps"] == {"functions": n_conv * steps,
                                     "dgrad": (n_conv - 1) * steps}, ng
        assert n["conv2d_taps"] == {
            "launches": (2 * n_conv - 1) * steps + n_conv * n_val,
            "plain": 0}, n
        assert n["instance_norm_plus"] == {
            "launches": n_norm * (steps + n_val), "plain": 0}, n
        train_counts = n
        config, score_fn = load_score_fn(ck, "cuda", torch.bfloat16)
        assert config.model.arch == arch
        calls = [0]
        kernels.reset_counts()
        reset_stats()
        t0 = time.perf_counter()
        res = run_estimation(counting(score_fn, calls), config,
                             snr_range=np.array([0., 20.]), num_channels=32,
                             level_stride=ARCH_EST_STRIDE, init="noise",
                             chunk_size=64, device="cuda")
        torch.cuda.synchronize()
        est_s = time.perf_counter() - t0
        n = kernels.counts()
        nfe = graph_forwards(calls[0], runs=1)
    print(f"# estimate from the {arch} checkpoint (level_stride "
          f"{ARCH_EST_STRIDE}, 32 CDL-C channels, bf16): {nfe} forwards "
          f"in {est_s:.2f} s; best NMSE dB "
          f"{np.round(res.best_nmse_db().ravel(), 2).tolist()}; launches {n}")
    assert np.isfinite(res.nmse_log).all()
    assert n["conv2d_taps"] == {"launches": n_conv * nfe, "plain": 0}, n
    assert n["instance_norm_plus"] == {"launches": n_norm * nfe,
                                       "plain": 0}, n
    out["train"] = dict(arch=arch, steps=steps, seconds=train_s,
                        counts=train_counts, grad_counts=ng,
                        train_loss=logs["train_loss"].tolist())
    out["estimate"] = dict(forwards=nfe, seconds=est_s, counts=n,
                           best_nmse_db=res.best_nmse_db().ravel().tolist())
    return out


SAMPLER_LEVELS = 4       # sigma 39.15, 1.93, 0.095, 0.0047 ...
SAMPLER_EVERY = 600      # ... every 600th level of the schedule
SAMPLER_STEPS = 2
SAMPLER_GRAPH_STEPS = 10  # steps a level of the graph-vs-eager runs
SAMPLER_BATCH = 64
SAMPLER_RTOL = 1e-3


def samplers_phase(model, g):
    """Phase 10: the unconditional, inpainting and interpolation samplers
    on the full-width NCSNv2-Deepest (f32) on the card, 4 levels x 2 steps
    at 64 chains each, with their launch counts; each again on a 2-sample
    slice on the card and on the CPU, fed the same draws (noise_fn), held
    within SAMPLER_RTOL of max|CPU|; then `sampler_graph_check`."""
    from score_based_channels_torch import kernels
    from score_based_channels_torch.config import ModelConfig
    from score_based_channels_torch.diffusion import (
        annealed_langevin_inpainting, annealed_langevin_interpolation,
        annealed_langevin_unconditional, get_sigmas,
    )
    from score_based_channels_torch.eval.estimate import score_fn_from_params
    from score_based_channels_torch.models import make_score_model

    mc = ModelConfig()
    sig = get_sigmas(mc.sigma_begin, mc.sigma_end, mc.num_classes)[
        ::SAMPLER_EVERY][:SAMPLER_LEVELS].float()
    card_fn = score_fn_from_params(model)
    cpu = make_score_model(mc, device="cpu")
    cpu.load_state_dict(model.state_dict())
    cpu_fn = score_fn_from_params(cpu)
    refer = torch.randn(SAMPLER_BATCH, 64, 16, 2, generator=g)
    mask = torch.zeros(1, 64, 16, 1)
    mask[:, :, :8] = 1.0  # the known half of every channel
    S = SAMPLER_STEPS
    runs = {
        "unconditional": (lambda fn, x, steps=S, **k:
                          annealed_langevin_unconditional(
                              fn, x, sig, n_steps_each=steps, **k), 1, 1),
        "inpainting": (lambda fn, x, steps=S, **k: annealed_langevin_inpainting(
            fn, x, refer[:x.shape[0]].to(x.device), mask.to(x.device), sig,
            n_steps_each=steps, **k), 2, 1),
        "interpolation": (lambda fn, x, steps=S, **k:
                          annealed_langevin_interpolation(
                              fn, x, sig,
                              n_interpolations=8 if x.shape[0] > 1 else 2,
                              n_steps_each=steps, **k), 2, 8),
    }
    out = {}
    for name, (run, n_draws, ni) in runs.items():
        x0 = torch.randn(SAMPLER_BATCH // ni, 64, 16, 2, generator=g)
        kernels.reset_counts()
        t0 = time.perf_counter()
        y = run(card_fn, x0.cuda(),
                generator=torch.Generator(device="cuda").manual_seed(5))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = kernels.counts()
        nfe = SAMPLER_LEVELS * SAMPLER_STEPS + (name == "unconditional")
        assert y.shape == (SAMPLER_BATCH, 64, 16, 2) and torch.isfinite(y).all()
        assert n["conv2d_taps"] == {"launches": 113 * nfe, "plain": 0}, n
        assert n["instance_norm_plus"] == {"launches": 25 * nfe,
                                           "plain": 0}, n
        # a 2-sample slice (1 row x 2 for the interpolation), same draws
        xs = x0[:2 if ni == 1 else 1]
        rows = 2 if ni == 1 else 1
        draws = {(lvl, i): tuple(torch.randn(rows, 64, 16, 2, generator=g)
                                 for _ in range(n_draws))
                 for lvl in range(SAMPLER_LEVELS)
                 for i in range(SAMPLER_STEPS)}
        noise_fn = lambda lvl, i: draws[(lvl, i)]
        got = run(card_fn, xs.cuda(), noise_fn=noise_fn).cpu()
        want = run(cpu_fn, xs, noise_fn=noise_fn)
        err = max_rel(got, want)
        print(f"# sampler {name}: {SAMPLER_BATCH} chains x "
              f"{SAMPLER_LEVELS} levels x {SAMPLER_STEPS} steps on the card "
              f"in {secs:.2f} s, launches {n}; 2-sample slice card vs CPU "
              f"on the same draws: max rel err {err:.2e} (tol "
              f"{SAMPLER_RTOL})", flush=True)
        assert err <= SAMPLER_RTOL, (name, err)
        out[name] = dict(seconds=secs, counts=n, forwards=nfe,
                         slice_rel_err=err,
                         graph=sampler_graph_check(name, run, n_draws,
                                                   x0.cuda(), card_fn))
    return out


def sampler_graph_check(name, run, n_draws, x0, score):
    """One sampler (in phase 10) at SAMPLER_LEVELS x SAMPLER_GRAPH_STEPS
    on the phase's chains through its captured step and through its eager
    loop, fed the same generator's draws (noise_fn drawing what the step
    draws): equal bits; whole runs in turns (eager, graph, graph, eager)
    as steps/s; the busy share of a whole run in a profiler window each
    way (the graph's run holds its eager step 0 and its capture)."""
    steps = SAMPLER_GRAPH_STEPS
    shape = tuple(x0.shape)
    gen = lambda: torch.Generator(device="cuda").manual_seed(5)

    def eager():
        g = gen()
        return run(score, x0, steps, noise_fn=lambda lvl, i: tuple(
            torch.randn(shape, generator=g, device="cuda")
            for _ in range(n_draws)))

    graph = lambda: run(score, x0, steps, generator=gen())
    caps = []
    with captures_made(caps):
        got = graph()
    same = same_bits(got, eager())
    print(f"#   {name} through its captured step, {SAMPLER_LEVELS} levels x "
          f"{steps} steps, {x0.shape[0]} draws a step: bit-equal to the "
          f"eager loop {same}; capture {rounded([c.seconds for c in caps], 4)}"
          f" s, pool {rounded([c.pool_bytes / 2**20 for c in caps], 1)} MB",
          flush=True)
    assert same and len(caps) == 1, (name, same, caps)
    n_steps = SAMPLER_LEVELS * steps
    secs, _ = in_turns(eager, graph, f"{name}, eager loop and graph")
    rate = {k: [n_steps / v for v in vs] for k, vs in secs.items()}
    windows = {}
    for way, fn in (("eager", eager), ("graph", graph)):
        wall, busy, top = busy_window(fn)
        windows[way] = dict(wall_ms=wall, busy_ms=busy, top=top)
    print(f"#   steps/s: eager {rounded(rate['plain'])}, graph "
          f"{rounded(rate['graph'])}; busy share of a run: eager "
          f"{100 * windows['eager']['busy_ms'] / windows['eager']['wall_ms']:.1f}"
          f"%, graph "
          f"{100 * windows['graph']['busy_ms'] / windows['graph']['wall_ms']:.1f}"
          f"% ({windows['graph']['busy_ms'] / n_steps:.3f} ms of card time "
          f"a step)")
    return dict(bit_equal=same, capture_seconds=[c.seconds for c in caps],
                pool_bytes=[c.pool_bytes for c in caps], seconds=secs,
                steps_per_s=rate, windows=windows)


LDAMP_STEPS = 4      # epochs of one step: 200 realizations, batch 128
LDAMP_SNR = 10.0


def ldamp_phase(card):
    """Phase 11: `train_ldamp_snr` at the JAX package's defaults (10
    unrolls, chans 16, 3 pools, batch 128, alpha 0.6) at one SNR on CDL-C
    made on the host, with its launch counts (conv2d_taps forward and
    dgrad, 0 plain); the card's gradient against the plain CPU gradient at
    batch 4 at the initial parameters with the same divergence directions
    and the card's LeakyReLU branches replayed (1e-3 of each tensor's
    max|g|, the train phase's bar); ms per step (forward, backward,
    optimizer) and steps/s; `run_ldamp_eval` from the saved checkpoint;
    the `pilot_eigmax` launches of both (one a step, one an SNR) and
    `eigmax_check`."""
    from score_based_channels_torch import kernels
    from score_based_channels_torch.config import default_score_config
    from score_based_channels_torch.data import ChannelDataset
    from score_based_channels_torch.eval.estimate import derive_seed
    from score_based_channels_torch.eval.ldamp import run_ldamp_eval
    from score_based_channels_torch.train.ldamp import (
        LDAMPTrainConfig, checkpoint_name, ldamp_batch, ldamp_inputs,
        ldamp_losses, ldamp_train_step, make_ldamp_model,
        make_ldamp_optimizer, train_ldamp_snr,
    )

    cfg = default_score_config("CDL-C")
    tc = LDAMPTrainConfig()
    unet_convs = 15  # per denoiser apply at 3 pools (tests count them)
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_counts()
        t0 = time.perf_counter()
        model, logs = train_ldamp_snr(
            cfg, LDAMP_SNR, tc, n_epochs=LDAMP_STEPS, device="cuda",
            checkpoint_path=checkpoint_name(tmp, "CDL-C", LDAMP_SNR,
                                            tc.alpha),
            log_fn=lambda s: print("# " + s))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        n, ng = kernels.counts(), kernels.grad_counts()
        fwd = tc.max_unrolls * unet_convs  # applies under grad, per step
        print(f"# train-ldamp CDL-C SNR {LDAMP_SNR}, {tc.max_unrolls} "
              f"unrolls, chans {tc.chans}, batch {tc.batch_size}, f32: "
              f"{LDAMP_STEPS} steps in {train_s:.2f} s (data generation "
              f"included); launches {n}; gradient work {ng}")
        assert np.isfinite(logs["loss_log"]).all(), logs["loss_log"]
        # the first unroll's first conv sees no input that requires grad
        assert ng["conv2d_taps"] == {"functions": fwd * LDAMP_STEPS,
                                     "dgrad": (fwd - 1) * LDAMP_STEPS}, ng
        assert n["conv2d_taps"] == {"launches": (3 * fwd - 1) * LDAMP_STEPS,
                                    "plain": 0}, n
        assert n["instance_norm_plus"] == {"launches": 0, "plain": 0}, n
        # each step's drawn batch assembled in the step, eig1 by the kernel
        assert n["pilot_eigmax"] == {"launches": LDAMP_STEPS,
                                     "plain": 0}, n
        train_counts, train_grad_counts = n, ng
        eig = eigmax_check(tc)

        # card vs CPU gradient at the initial parameters, batch 4
        ds = ChannelDataset(1234, dataclasses.replace(
            cfg.data, noise_std=float(10 ** (-LDAMP_SNR / 20) * 8),
            num_pilots=int(64 * tc.alpha)), norm="global")
        gb = torch.Generator().manual_seed(21)
        b4 = ldamp_inputs(ldamp_batch(ds, gb, 4, "cpu"))
        dirs = [torch.randn(4, 64, 16, 2, generator=gb)
                for _ in range(tc.max_unrolls)]
        init = lambda dev: make_ldamp_model(tc, dev, torch.Generator()
                                            .manual_seed(derive_seed(tc.seed,
                                                                     0)))
        # LeakyReLU is piecewise: a pre-activation within rounding of 0
        # takes slope 1 in one run and 0.2 in another, and over 10 unrolls
        # a few such flips move the f32 gradient ~5e-2 off float64 on the
        # CPU alone. The CPU run replays the card's branches.
        masks, free_masks, losses, grads = [], [], {}, {}
        for tag, dev, kw in (("card", "cuda", dict(record=masks)),
                             ("cpu", "cpu", dict(replay=masks)),
                             ("free", "cpu", dict(record=free_masks))):
            m = init(dev)
            with leaky_branches(**kw):
                mse, _ = ldamp_losses(m, {k: v.to(dev) for k, v in
                                          b4.items()}, directions=dirs)
                mse.backward()
            losses[tag] = mse.item()
            grads[tag] = [(nm, p.grad.cpu()) for nm, p in m.named_parameters()]
        flips = sum(int((a.cpu() != b).sum()) for a, b in
                    zip(masks, free_masks))
        worst = max((max_rel(a, b), nm) for (nm, a), (_, b) in
                    zip(grads["card"], grads["cpu"]))
        free_worst = max(max_rel(a, b) for (_, a), (_, b) in
                         zip(grads["card"], grads["free"]))
        loss_rel = abs(losses["card"] - losses["cpu"]) / losses["cpu"]
        n_masks = sum(x.numel() for x in masks)
        print(f"# LDAMP gradient at the initial parameters, card (kernels) "
              f"vs CPU (plain, replaying the card's {n_masks} LeakyReLU "
              f"branches), batch 4, same directions: loss rel err "
              f"{loss_rel:.2e}; worst parameter {worst[1]} at {worst[0]:.2e} "
              f"of its max|g| (tol 1e-3) over {len(grads['cpu'])} tensors; "
              f"a free CPU run takes {flips} other branches and is "
              f"{free_worst:.2e} off the card")
        assert loss_rel < 2e-4 and worst[0] <= 1e-3, (loss_rel, worst)

        # ms per step: forward, backward, optimizer (synchronised)
        opt = make_ldamp_optimizer(model, tc, 1)
        gen = torch.Generator(device="cuda").manual_seed(3)
        batch = ldamp_inputs(ldamp_batch(ds, gb, tc.batch_size, "cuda"))
        phases = {"forward": [], "backward": [], "optimizer": []}
        for i in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mse, _ = ldamp_losses(model, batch, gen)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            opt.zero_grad()
            mse.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            opt.step()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            if i >= 2:
                phases["forward"].append((t1 - t0) * 1e3)
                phases["backward"].append((t2 - t1) * 1e3)
                phases["optimizer"].append((t3 - t2) * 1e3)
        med = {k: float(np.median(v)) for k, v in phases.items()}
        reps = 5
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            ldamp_train_step(model, opt, batch, gen)
        torch.cuda.synchronize()
        steps_per_s = reps / (time.perf_counter() - t0)
        print(f"# LDAMP train step, batch {tc.batch_size} f32, ms (median of "
              f"6, synchronised): forward {med['forward']:.2f}, backward "
              f"{med['backward']:.2f}, optimizer {med['optimizer']:.2f}; "
              f"{steps_per_s:.2f} steps/s unsynchronised; on {card}")

        kernels.reset_counts()
        res = run_ldamp_eval(cfg, snr_range=[LDAMP_SNR], model_dir=tmp,
                             num_channels=100, device="cuda")
        n = kernels.counts()
    print(f"# eval-ldamp from the saved checkpoint, 100 channels: NMSE "
          f"{res.avg_db().round(2).tolist()} dB; launches {n}")
    assert np.isfinite(res.nmse).all()
    assert n["conv2d_taps"] == {"launches": 2 * tc.max_unrolls * unet_convs,
                                "plain": 0}, n
    assert n["pilot_eigmax"] == {"launches": 1, "plain": 0}, n  # one SNR
    graph = ldamp_graph_phase(card)
    return dict(steps=LDAMP_STEPS, seconds=train_s, counts=train_counts,
                eigmax=eig,
                grad_counts=train_grad_counts, graph=graph,
                loss_log=logs["loss_log"].tolist(), grad_check_worst=worst,
                grad_check_loss_rel=loss_rel, grad_check_flips=flips,
                grad_check_free_worst=free_worst, phase_ms=med,
                steps_per_s=steps_per_s, eval_nmse_db=res.avg_db().tolist(),
                eval_counts=n)


EIGMAX_TOL = 1e-5  # relative, against the plain version and float64


def eigmax_check(tc):
    """`pilot_eigmax` (in phase 11) on card pilots at LDAMP's recipe, batch
    x (64, alpha 64): against its plain version on the same card tensor
    and against float64 eigvalsh (EIGMAX_TOL relative), every sample's
    sweeps under the cap; ms a call of the kernel, the plain version and
    eigvalsh of the Grams alone, and its bound."""
    from score_based_channels_torch import cplx
    from score_based_channels_torch.kernels import eigmax

    P = cplx.qpsk_pilots(torch.Generator().manual_seed(29), tc.batch_size,
                         64, int(64 * tc.alpha)).to("cuda")
    m = eigmax.measure(P)
    m.update(ops_ms=m["operations"] / PEAK_OPS[torch.float32] * 1e3,
             bytes_ms=m["bytes"] / PEAK_BYTES * 1e3)
    print(f"# pilot_eigmax {tuple(P.shape[:3])}: {m['kernel_ms']:.4f} ms "
          f"(plain {m['plain_ms']:.4f}, eigvalsh of the Grams "
          f"{m['library_ms']:.4f}; bound {max(m['ops_ms'], m['bytes_ms']):.4f}"
          f"); against the plain version {m['kernel_vs_plain']:.2e}, float64 "
          f"{m['kernel_err']:.2e} (tol {EIGMAX_TOL:g}); sweeps "
          f"{m['sweeps_min']}-{m['sweeps_max']} of at most "
          f"{m['max_sweeps']}")
    assert m["kernel_vs_plain"] <= EIGMAX_TOL, m
    assert m["kernel_err"] <= EIGMAX_TOL, m
    assert m["sweeps_max"] < m["max_sweeps"], m
    return m


LDAMP_DECAY_EPOCHS = 2   # the bit-for-bit runs: the rate drops after step 2
LDAMP_TURN_STEPS = 8     # steps a timed run, each way


def ldamp_graph_phase(card):
    """The LDAMP graph (in phase 11), at the JAX package's defaults (10
    unrolls, chans 16, 3 pools, batch 128, f32): LDAMP_STEPS steps through
    the runner's captured step and through its eager loop from one seed,
    one run an epoch as `train_ldamp_snr` runs them, the rate x0.1 after
    LDAMP_DECAY_EPOCHS: equal bit for bit under deterministic algorithms
    in parameters, Adam moments, count and every (mse, nmse) row, and
    their largest difference without. Then on one model, runs of
    LDAMP_TURN_STEPS steps in turns (eager, graph, graph, eager) with the
    batches made on the host each step, as `train_ldamp_snr` makes them,
    and two graph runs with the batches already on the card; runs in
    turns with the host batches staged (the runner's pinned buffers and
    copies that do not wait) or copied by blocking copies; the host's
    time a replay with the card held by a spin kernel; the device busy
    share of a 3-step profiler window each way and the top device ops a
    step under the graph; the capture's seconds and the graph pool's MB;
    and `train_ldamp_snr` at the recipe (24 epochs of one step) through
    the graph and the eager loop: wall seconds and the logs' largest
    difference."""
    from score_based_channels_torch import _graph
    from score_based_channels_torch.config import default_score_config
    from score_based_channels_torch.data import ChannelDataset
    from score_based_channels_torch.eval.estimate import derive_seed
    from score_based_channels_torch.kernels.launch_cost import spin_cycles
    from score_based_channels_torch.train.ldamp import (
        LDAMPStepRunner, LDAMPTrainConfig, ldamp_batch, make_ldamp_model,
        make_ldamp_optimizer, train_ldamp_snr,
    )

    cfg = default_score_config("CDL-C")
    tc = LDAMPTrainConfig(decay_epochs=LDAMP_DECAY_EPOCHS)
    ds = ChannelDataset(1234, dataclasses.replace(
        cfg.data, noise_std=float(10 ** (-LDAMP_SNR / 20) * 8),
        num_pilots=int(64 * tc.alpha)), norm="global")

    def host_batch(s):
        return ldamp_batch(ds, torch.Generator().manual_seed(
            derive_seed(tc.seed, 1, s)), tc.batch_size, "cpu")

    def steps_run(runner, steps, batch=host_batch):
        return runner.run((batch(s) for s in steps),
                          [derive_seed(tc.seed, 2, s) for s in steps])

    def eager_run(runner, steps, batch=host_batch):
        with _graph.eager():
            return steps_run(runner, steps, batch)

    def runner_for(model, opt, rows, updates):
        return LDAMPStepRunner(model, opt, torch.Generator(device="cuda"),
                               rows, updates)

    def seeded_run(eager):
        model = make_ldamp_model(tc, "cuda")
        opt = make_ldamp_optimizer(model, tc, 1)
        runner = runner_for(model, opt, 1, LDAMP_STEPS)
        run = eager_run if eager else steps_run
        rows = torch.cat([run(runner, [s]).clone()
                          for s in range(LDAMP_STEPS)])
        return model, opt, rows

    @torch.no_grad()
    def differ(a, b):
        pairs = list(zip(a[0].parameters(), b[0].parameters())) + [
            (p, q) for k in ("mu", "nu")
            for p, q in zip(a[1].moments[k], b[1].moments[k])]
        same = (all(torch.equal(p, q) for p, q in pairs)
                and a[1].count == b[1].count and torch.equal(a[2], b[2]))
        norm = max(float(torch.linalg.norm(p - q) / torch.linalg.norm(q))
                   for p, q in pairs if torch.linalg.norm(q) > 0)
        return same, norm, max_rel(a[2], b[2])

    with deterministic_algorithms():
        det = differ(seeded_run(False), seeded_run(True))
    eager_once = seeded_run(True)
    free = differ(seeded_run(False), eager_once)
    spread = differ(seeded_run(True), eager_once)
    print(f"# LDAMP graph vs eager loop, {LDAMP_STEPS} steps of batch "
          f"{tc.batch_size}, rate x{tc.decay_gamma} after step "
          f"{LDAMP_DECAY_EPOCHS}: under deterministic algorithms bit-equal "
          f"{det[0]} (parameters, moments, count, losses; largest norm-wise "
          f"{det[1]:.2e}); without, largest norm-wise difference "
          f"{free[1]:.2e}, losses {free[2]:.2e}; two eager runs "
          f"{spread[1]:.2e}, losses {spread[2]:.2e}", flush=True)
    assert det[0], det

    # in turns on one model: the runners share its optimizer table
    model = make_ldamp_model(tc, "cuda")
    opt = make_ldamp_optimizer(model, tc, 1)
    n = LDAMP_TURN_STEPS

    # the staging's yardstick: host batches by blocking copies, which wait
    # for the previous replay before the host launches the next
    class Blocking(LDAMPStepRunner):
        def _stage(self, batch):
            for k, v in batch.items():
                self.buf[k].copy_(v)

    graph = runner_for(model, opt, n, 40 * n)
    eager = runner_for(model, opt, n, 40 * n)
    blocking = Blocking(model, opt, torch.Generator(device="cuda"), n, 40 * n)
    _graph.reset_stats()
    _, first_s = timed(lambda: steps_run(graph, range(n)))
    stats = dict(graph.stats, **_graph.STATS)
    rec, rec_grad = graph.replayer.cap.launches, graph.replayer.cap.grad
    print(f"#   first graph run of {n} steps {first_s:.3f} s (step 0 eager, "
          f"capture {stats['capture_seconds']:.3f} s, graph pool "
          f"{stats['pool_bytes'] / 2**20:.1f} MB); a replay records "
          f"{rec['conv2d_taps']} conv launches, gradient work "
          f"{rec_grad['conv2d_taps']}", flush=True)
    assert rec["conv2d_taps"] == 449, rec
    runs = {"eager": lambda: eager_run(eager, range(n)),
            "graph": lambda: steps_run(graph, range(n))}
    secs = {"eager": [], "graph": []}
    for way in ("eager", "graph", "graph", "eager"):
        secs[way].append(timed(runs[way])[1])
    sps = {k: [n / v for v in vs] for k, vs in secs.items()}
    on_card = {s: {k: v.cuda() for k, v in host_batch(s).items()}
               for s in range(n)}
    card_s = [timed(lambda: steps_run(graph, range(n), on_card.get))[1]
              for _ in range(2)]
    print(f"#   steps/s in turns (eager, graph, graph, eager), {n} steps a "
          f"run, batches made on the host each step, synchronised: eager "
          f"{rounded(sps['eager'], 3)}, graph {rounded(sps['graph'], 3)}; "
          f"graph with the batches on the card "
          f"{rounded([n / v for v in card_s], 3)} steps/s "
          f"({rounded([v * 1e3 / n for v in card_s], 2)} ms a step) on "
          f"{card}")

    staged = {"blocking": blocking, "staged": graph}
    steps_run(blocking, range(n))  # its step 0 and capture
    stage_s, stage_win = {"staged": [], "blocking": []}, {}
    for way in ("staged", "blocking", "blocking", "staged"):
        stage_s[way].append(timed(lambda: steps_run(staged[way],
                                                    range(n)))[1])
    for way, runner in staged.items():
        wall, busy, _ = busy_window(lambda: steps_run(runner, range(n)))
        stage_win[way] = dict(wall_ms=wall, busy_ms=busy)
    print(f"#   host batches staged (pinned, non-blocking) or blocking, "
          f"{n} steps a run in turns (staged, blocking, blocking, staged): "
          f"steps/s staged {rounded([n / v for v in stage_s['staged']], 3)},"
          f" blocking {rounded([n / v for v in stage_s['blocking']], 3)}; "
          f"{n}-step windows busy staged {stage_win['staged']['busy_ms']:.1f}"
          f" of {stage_win['staged']['wall_ms']:.1f} ms, blocking "
          f"{stage_win['blocking']['busy_ms']:.1f} of "
          f"{stage_win['blocking']['wall_ms']:.1f} ms")

    # the host's time a one-step graph run with the card held by a spin
    # (batches on the card: a copy from the host would wait for the spin)
    cycles = spin_cycles(GRAPH_HOLD_MS)
    host, held = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        times = []
        for i in range(n):
            t0 = time.perf_counter()
            steps_run(graph, [i], on_card.get)
            times.append(time.perf_counter() - t0)
        held.append(not torch.cuda.current_stream().query())
        host.append(times)
        torch.cuda.synchronize()
    queued = [next((i for i, t in enumerate(ts) if t > QUEUE_WAIT_S),
                   len(ts)) for ts in host]
    us_step = [float(np.median(ts[:q])) * 1e6 if q else None
               for ts, q in zip(host, queued)]
    print(f"#   host time a one-step graph run, card held "
          f"({GRAPH_HOLD_MS:.0f} ms spin; held after the runs {held}): "
          f"median {us_step} us over the {queued} runs before the first "
          f"that waited for the launch queue (of {n}); each run in us "
          f"{[[round(t * 1e6, 1) for t in ts] for ts in host]}")
    assert all(held), held

    windows = {}
    for way, run, runner in (("eager", eager_run, eager),
                             ("graph", steps_run, graph)):
        wall, busy, top = busy_window(lambda: run(runner, range(3)))
        windows[way] = dict(wall_ms=wall, busy_ms=busy, top=top)
        print(f"#   profile, 3 steps, {way} (batches made on the host): wall "
              f"{wall:.1f} ms, device busy {busy:.1f} ms "
              f"({100 * busy / wall:.1f}%)")
    for name, ms in windows["graph"]["top"]:
        print(f"#     {ms / 3:9.3f} ms a step  {name[:90]}")

    # the recipe: 24 epochs of one step, each way
    recipe = {}
    for way in ("graph", "eager"):
        lines = []
        with eager_if(way == "eager"):
            (model_r, logs), sec = timed(lambda: train_ldamp_snr(
                cfg, LDAMP_SNR, device="cuda", log_fn=lines.append))
        recipe[way] = dict(seconds=sec, last_log=lines[-1], logs=logs)
        print(f"#   train_ldamp_snr at the recipe ({len(logs['loss_log'])} "
              f"steps, data generation included), {way}: {sec:.2f} s; "
              f"{lines[-1]}")
    gap = max(float(np.max(np.abs(recipe["graph"]["logs"][k]
                                  - recipe["eager"]["logs"][k])
                           / np.abs(recipe["eager"]["logs"][k])))
              for k in ("loss_log", "nmse_log"))
    print(f"#   recipe logs, graph vs eager: largest relative difference "
          f"{gap:.2e} (not under deterministic algorithms)")
    for r in recipe.values():
        r["logs"] = {k: v.tolist() for k, v in r["logs"].items()}
    return dict(bit_equal_deterministic=det[0], det_norm=det[1],
                free_norm=free[1], free_loss=free[2], eager_spread_norm=
                spread[1], eager_spread_loss=spread[2], first_run_seconds=
                first_s, stats=stats, recorded=rec,
                recorded_grad=rec_grad, seconds=secs,
                steps_per_s=sps, card_batch_seconds=card_s,
                staging_seconds=stage_s, staging_windows=stage_win,
                host_seconds_held=host, host_us_per_step_held=us_step,
                held=held, replays_queued=queued, windows=windows,
                recipe=recipe, recipe_log_gap=gap)


WGAN_EPOCHS = 2          # generator steps, each after 100 boosted D steps
WGAN_RESTARTS = 2
WGAN_CHANNELS = 8
WGAN_STEPS = 100
WGAN_RTOL = 1e-3         # card vs CPU on the traces' first WGAN_HELD steps
WGAN_HELD = 25
WGAN_GAP_DB = 0.01       # on the slice's best NMSE
WGAN_CHUNK = 4096        # chains of the timed inversion step


@contextlib.contextmanager
def relu_branches(record=None, replay=None):
    """models/dcgan.py's ReLUs while the block runs, appending each call's
    branch mask (pre-activation > 0) to `record`, or taking the branches
    from `replay`'s masks in order."""
    from score_based_channels_torch.models import dcgan

    calls = iter(replay or [])

    class Functional:
        def __getattr__(self, name):
            return getattr(F, name)

        @staticmethod
        def relu(y):
            if replay is not None:
                keep = next(calls).to(y.device)
            else:
                keep = y > 0
                record.append(keep)
            return torch.where(keep, y, torch.zeros((), dtype=y.dtype,
                                                    device=y.device))

    saved = dcgan.F
    dcgan.F = Functional()
    try:
        yield
    finally:
        dcgan.F = saved


@contextlib.contextmanager
def float64_generator():
    """`run_wgan_eval` with its generator in float64 (fed float64 draws,
    the inversion runs in float64)."""
    from score_based_channels_torch.eval import wgan

    saved = wgan.load_generator
    wgan.load_generator = lambda *args: saved(*args).double()
    try:
        yield
    finally:
        wgan.load_generator = saved


def wgan_phase(card):
    """Phase 12: `train_wgan` at the JAX package's defaults (nz 60, ngf
    128, ndf 64, one extra layer, batch 200) for 2 generator iterations of
    100 boosted critic steps, with ms per D and G step; `run_wgan_eval`
    from its checkpoint on a reduced grid (1 lambda x 1 lr x 2 SNR x 8
    channels x 2 restarts, 100 steps) on the card, held against the CPU on
    the same z0, channels, pilots and noise on 2 channels: rtol 1e-3 on
    the NMSE traces' first 25 steps; over all 100 steps with the card's
    ReLU branches replayed (`relu_branches`), rtol 1e-3 against the CPU
    and against float64 on the card, 0.01 dB on the best NMSE; each free
    f32 run's drift from float64 by quarter. One inversion step timed at a
    chunk of 4,096 chains; one D, one G and one inversion step in one
    profiler window, for their device busy share."""
    from score_based_channels_torch import cplx
    from score_based_channels_torch.config import default_score_config
    from score_based_channels_torch.data import ChannelDataset
    from score_based_channels_torch.eval.wgan import (
        load_generator, run_wgan_eval, wgan_invert,
    )
    from score_based_channels_torch.train.wgan import (
        WGANTrainConfig, train_wgan, wgan_d_step, wgan_g_step,
    )

    cfg = default_score_config("CDL-C")
    tc = WGANTrainConfig()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "wgan.npz")
        t0 = time.perf_counter()
        state, logs = train_wgan(cfg, tc, checkpoint_path=ck,
                                 n_epochs=WGAN_EPOCHS, device="cuda",
                                 log_fn=lambda s: print("# " + s))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        assert state.gen_iterations == WGAN_EPOCHS
        assert np.isfinite(logs["d_log"]).all()
        assert np.isfinite(logs["g_log"]).all()
        train_ds = ChannelDataset(1234, cfg.data, norm="entrywise")
        H = cplx.as_c2(torch.from_numpy(train_ds.normalized())).cuda()
        z = torch.randn(tc.batch_size, tc.nz, device="cuda")
        ms = {"d_step": [], "g_step": []}
        for i in range(12):
            for key, fn in (("d_step", lambda: wgan_d_step(
                    state, H[:tc.batch_size], z, tc.clamp)),
                            ("g_step", lambda: wgan_g_step(state, z))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                if i >= 2:
                    ms[key].append((time.perf_counter() - t0) * 1e3)
        med = {k: float(np.median(v)) for k, v in ms.items()}
        print(f"# train-wgan, nz {tc.nz} ngf {tc.ngf} ndf {tc.ndf}, batch "
              f"{tc.batch_size}, f32: {WGAN_EPOCHS} generator steps after "
              f"{tc.d_iters_boost} critic steps each in {train_s:.2f} s "
              f"(data generation included); D step {med['d_step']:.2f} ms, G "
              f"step {med['g_step']:.2f} ms (median of 10, synchronised) on "
              f"{card}", flush=True)

        # the reduced grid, card, and CPU on 2 of its channels
        g = torch.Generator().manual_seed(7)
        C, R, S, Np = WGAN_CHANNELS, WGAN_RESTARTS, 2, 38
        val_ds = ChannelDataset(4321, cfg.data,
                                norm=list(train_ds.norm_stats),
                                num_pilots=Np)
        z_init = torch.randn(R, C, tc.nz, generator=g)
        X2 = cplx.as_c2(torch.from_numpy(val_ds.normalized()[:C]))
        P2 = cplx.qpsk_pilots(g, C, 64, Np)
        w = cplx.randn(g, (S * C, 16, Np))
        kw = dict(snr_range=np.array([0.0, 10.0]), l2lam_range=(1.0,),
                  lr_range=(0.01,), num_steps=WGAN_STEPS, restarts=R)
        t0 = time.perf_counter()
        card_res = run_wgan_eval(cfg, ck, num_channels=C, device="cuda",
                                 _draws=(z_init, [(X2, P2, w)]), **kw)
        eval_s = time.perf_counter() - t0
        ws = w.view(S, C, 16, Np, 2)[:, :2].reshape(S * 2, 16, Np, 2)
        d32 = (z_init[:, :2], [(X2[:2], P2[:2], ws)])
        d64 = (d32[0].double(), [tuple(t.double() for t in d32[1][0])])
        slice_log = lambda dev, draws: run_wgan_eval(
            cfg, ck, num_channels=2, device=dev, _draws=draws,
            **kw).oracle_log
        t0 = time.perf_counter()
        cpu_free = slice_log("cpu", d32)
        cpu_s = time.perf_counter() - t0
        # the per-sample Adam is chaotic: where f32 and float64 (or two
        # f32 runs) take the other side of one of the generator's ReLUs,
        # their chains part, faster step by step. So the free runs are
        # held over their first WGAN_HELD steps only, and the whole run
        # with the card's ReLU branches replayed: the CPU's f32 and the
        # card's float64 on the branches the card's f32 took
        masks = []
        with relu_branches(record=masks):
            card_rec = slice_log("cuda", d32)
        with relu_branches(replay=masks):
            cpu_rep = slice_log("cpu", d32)
        with float64_generator():
            with relu_branches(replay=masks):
                f64_rep = slice_log("cuda", d64)
            f64_free = slice_log("cuda", d64)
        del masks
        q = WGAN_STEPS // 4
        rel = lambda a, b: np.abs(a - b) / np.abs(b)  # (.., steps, chans)
        quarters = lambda r: [float(r[..., i:i + q, :].max())
                              for i in range(0, WGAN_STEPS, q)]
        best_db = lambda log: 10 * np.log10(log.mean(-1).min(-1))
        card_free = card_res.oracle_log[..., :2]
        free = rel(card_free, cpu_free)
        err = float(free[..., :WGAN_HELD, :].max())
        err_rep = float(rel(card_rec, cpu_rep).max())
        err_f64 = float(rel(card_rec, f64_rep).max())
        gap = float(np.abs(best_db(card_rec) - best_db(cpu_rep)).max())
        drift = {"card": quarters(rel(card_free, f64_free)),
                 "cpu": quarters(rel(cpu_free, f64_free))}
        best = np.round(card_res.best_nmse_db().ravel(), 3).tolist()
        fmt = lambda v: ["%.2e" % x for x in v]
        print(f"# eval-wgan from the checkpoint, 1 x 1 x 2 SNR x {C} "
              f"channels x {R} restarts, {WGAN_STEPS} steps: {eval_s:.2f} s "
              f"(CPU slice {cpu_s:.2f} s); best NMSE dB {best}; NMSE traces "
              f"on 2 channels, max rel err: card vs CPU {err:.2e} over the "
              f"first {WGAN_HELD} steps (tol {WGAN_RTOL}), by quarter "
              f"{fmt(quarters(free))}; on the card's ReLU branches over all "
              f"{WGAN_STEPS} steps: card vs CPU {err_rep:.2e}, card vs "
              f"float64 {err_f64:.2e} (tol {WGAN_RTOL}), best NMSE gap "
              f"{gap:.2e} dB (tol {WGAN_GAP_DB}); free f32 vs float64 by "
              f"quarter: card {fmt(drift['card'])}, CPU {fmt(drift['cpu'])}")
        assert np.isfinite(card_res.oracle_log).all()
        assert err <= WGAN_RTOL, err
        assert max(err_rep, err_f64) <= WGAN_RTOL, (err_rep, err_f64)
        assert gap <= WGAN_GAP_DB, gap

        # one inversion step at a chunk of 4,096 chains
        gen = load_generator(ck, cfg, "cuda")
        B = WGAN_CHUNK
        idx = torch.arange(B) % C
        args = (torch.randn(B, tc.nz, generator=g).cuda(), P2[idx].cuda(),
                cplx.matmul(X2[idx], P2[idx]).cuda(), 1.0, 0.01)
        torch.cuda.reset_peak_memory_stats()
        wgan_invert(gen, *args, num_steps=1, oracle2=X2[idx].cuda())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wgan_invert(gen, *args, num_steps=5, oracle2=X2[idx].cuda())
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / 5
        print(f"# wgan_invert at {B} chains: {step_ms:.2f} ms a step "
              f"(mean of 5, synchronised; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB)")
        # is the card busy through the steps a graph would replay? One D
        # step, one G step and one inversion step in one profiler window
        wall, busy, top = busy_window(lambda: (
            wgan_d_step(state, H[:tc.batch_size], z, tc.clamp),
            wgan_g_step(state, z),
            wgan_invert(gen, *args, num_steps=1, oracle2=X2[idx].cuda())))
        print(f"# wgan busy share, one D step + one G step (batch "
              f"{tc.batch_size}) + one inversion step ({B} chains): wall "
              f"{wall:.2f} ms, device busy {busy:.2f} ms "
              f"({100 * busy / wall:.1f}%) on {card}")
        for k, ms in top[:8]:
            print(f"#   {ms:9.3f} ms  {k[:80]}")
        out["busy_window"] = dict(wall_ms=wall, busy_ms=busy, top=top)
    out.update(seconds=train_s, step_ms=med, d_log=logs["d_log"].tolist(),
               g_log=logs["g_log"].tolist(), eval_seconds=eval_s,
               eval_best_nmse_db=card_res.best_nmse_db().ravel().tolist(),
               eval_card_vs_cpu_rel_err=err,
               eval_rel_err_by_quarter=quarters(free),
               eval_replayed_rel_err=err_rep,
               eval_replayed_f64_rel_err=err_f64,
               eval_best_gap_db=gap, eval_cpu_seconds=cpu_s,
               eval_f32_drift_by_quarter=drift, invert_chunk=B,
               invert_step_ms=step_ms)
    return out


def native_phase():
    """Phase 13: `generate-data --backend native` (the g++-built host
    generator) for one small file, its moments against the torch
    generator's within the bars of tests/test_cdl_native.py:29-44."""
    from score_based_channels_torch.data.cdl import generate_cdl_channels
    from score_based_channels_torch.data.generate import main as gen_main

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        gen_main(["--profiles", "CDL-C", "--seeds", "3", "--num_channels",
                  "64", "--out_dir", tmp, "--backend", "native"])
        secs = time.perf_counter() - t0
        with np.load(os.path.join(
                tmp, "CDL-C_Nt64_Nr16_ULA0.50_seed3.npz")) as f:
            Hn = f["output_h"]
    Ht = generate_cdl_channels(seed=3, profile="CDL-C", num_channels=64)
    pn, pt = (np.mean(np.abs(h[:, 0]) ** 2) for h in (Hn, Ht))

    def tx_cov(h):
        x = h[:, 0].reshape(-1, h.shape[-1])
        c = x.conj().T @ x / x.shape[0]
        return c / np.trace(c).real

    cn, ct = tx_cov(Hn), tx_cov(Ht)
    corr = float(np.abs(np.vdot(cn, ct))
                 / (np.linalg.norm(cn) * np.linalg.norm(ct)))
    print(f"# generate-data --backend native: 64 CDL-C channels in "
          f"{secs:.2f} s (build included); power {pn:.3f} vs torch {pt:.3f} "
          f"(tol 25%), tx covariance correlation {corr:.3f} (> 0.9)")
    assert Hn.shape == (64, 10, 16, 64)
    assert abs(pn - pt) / pt < 0.25 and corr > 0.9, (pn, pt, corr)
    return dict(seconds=secs, power=float(pn), power_torch=float(pt),
                tx_cov_corr=corr)


VARIANTS = [("elu", "InstanceNorm++"),  # the default: the launch counts
            ("relu", "InstanceNorm++"), ("lrelu", "InstanceNorm++"),
            ("swish", "InstanceNorm++"), ("elu", "InstanceNorm"),
            ("elu", "VarianceNorm"), ("elu", "None")]
VARIANT_CPU_ROWS = 8      # of the card's 256, run again on the CPU
VARIANT_TOL = 2e-4        # f32, relative to max|CPU| (the full-width bar)


def variants_phase(g):
    """NCSNv2Deepest at full width (ngf 32, batch 256, f32) with each
    config-chosen activation and norm: the kernel forward on the card
    against the plain CPU forward of the same parameters on the batch's
    first VARIANT_CPU_ROWS rows, its launch counts (113 conv whatever the
    variant; InstanceNorm++ only where the norm is, 1 otherwise: the final
    normalizer), and its device ms a forward."""
    from score_based_channels_torch import kernels
    from score_based_channels_torch.config import ModelConfig
    from score_based_channels_torch.models import make_score_model

    x = torch.randn(BATCH, 64, 16, 2, generator=g)
    sig = torch.rand(BATCH, generator=g) * 2 + 0.05
    xc, sc = x.cuda(), sig.cuda()
    rows = []
    for act, norm in VARIANTS:
        cfg = ModelConfig(nonlinearity=act, normalization=norm)
        model = make_score_model(cfg, device="cuda",
                                 generator=torch.Generator().manual_seed(5))
        cpu = make_score_model(cfg, device="cpu")
        cpu.load_state_dict(model.state_dict())
        kernels.reset_counts()
        with torch.no_grad():
            got = model(xc, sc)
        torch.cuda.synchronize()
        c = kernels.counts()
        with torch.no_grad():
            want = cpu(x[:VARIANT_CPU_ROWS], sig[:VARIANT_CPU_ROWS])
        err = ((got[:VARIANT_CPU_ROWS].cpu() - want).abs().max()
               / want.abs().max()).item()
        n_norm = 25 if norm == "InstanceNorm++" else 1
        assert c["conv2d_taps"] == {"launches": 113, "plain": 0}, c
        assert c["instance_norm_plus"] == {"launches": n_norm, "plain": 0}, c
        assert torch.isfinite(got).all() and err <= VARIANT_TOL, (act, norm,
                                                                   err)
        with torch.no_grad():
            ms = cuda_ms(lambda: model(xc, sc), reps=5)
        rows.append(dict(act=act, norm=norm, max_rel_err=err, ms=ms,
                         conv2d_taps=c["conv2d_taps"]["launches"],
                         instance_norm_plus=c["instance_norm_plus"][
                             "launches"]))
        print(f"# variant {act:5s} {norm:14s}: launches conv2d_taps "
              f"{rows[-1]['conv2d_taps']}, instance_norm_plus "
              f"{rows[-1]['instance_norm_plus']} a forward; max rel err vs "
              f"CPU {err:.2e} (tol {VARIANT_TOL:g}); {ms:.3f} ms a forward "
              "(f32, batch 256, device)", flush=True)
        del model, cpu
    return dict(rows=rows)


DIST_STEPS = 2
DIST_BATCH = 32           # the reference recipe (train_score.py:54)
DIST_STRIDE = 100         # the sweep chunk: every 100th level of the 2311
DIST_TOL = 1e-6           # tests/test_torch_train.py's bar


@contextlib.contextmanager
def deterministic_algorithms():
    """torch.use_deterministic_algorithms(True) while the block runs. Two
    training runs differ by default (the bilinear resize's backward and
    cuDNN's weight gradient accumulate in no fixed order: up to 1.1e-5
    norm-wise on a parameter after 2 steps on an H100); with it they
    are equal bit for bit, so a difference left is the code's."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])


WIDE_BATCH = 8  # the FFHQ cell's rows
WIDE_LEVELS = 2  # levels of the short inpainting run (3 steps each)


def wide_phase(g):
    """Phase 15: the wide bf16 route of conv2d_taps and the two-pass route
    of instance_norm_plus at every conv and norm shape of NCSNv2-Deepest
    at its published FFHQ widths (ngf 128, 256x256x3: the shape table
    perfbench/shapes/ncsnv2_deepest_ffhq256.json) at batch WIDE_BATCH in
    bf16: each against its plain version on the card, timed (CUDA events,
    median) beside its plain version, its bound and, for a conv, cuDNN's
    F.conv2d; the sums over one forward. Then `annealed_langevin_inpainting`
    on that model in bf16 (WIDE_LEVELS levels x 3 steps, WIDE_BATCH rows,
    the left half known), through its captured step: every conv and norm
    of every forward launched on the new routes, none plain. Returns the
    rows, the per-forward sums and the run's counts."""
    import dataclasses

    from score_based_channels_torch import kernels
    from score_based_channels_torch.config import ModelConfig
    from score_based_channels_torch.diffusion import (
        annealed_langevin_inpainting, get_sigmas)
    from score_based_channels_torch.eval.estimate import score_fn_from_params
    from score_based_channels_torch.kernels import conv, instance_norm
    from score_based_channels_torch.models.ncsnv2 import NCSNv2Deepest

    table = json.loads((ROOT / "perfbench" / "shapes" /
                        "ncsnv2_deepest_ffhq256.json").read_text())
    dt, B, rows = torch.bfloat16, WIDE_BATCH, []
    for H, W, Cin, Cout, k, d, bias, per_fwd in table["convs"]:
        T = len(conv.live_taps(k, d, H, W))
        bound = 1.0 / np.sqrt(Cin * k * k)
        x = torch.randn(B, Cin, H, W, generator=g).to(
            "cuda", dt).contiguous(memory_format=torch.channels_last)
        w = conv.kernel_layout(((torch.rand(Cout, Cin, k, k, generator=g)
                                 * 2 - 1) * bound).to("cuda", dt))
        b = (((torch.rand(Cout, generator=g) * 2 - 1) * bound).to("cuda", dt)
             if bias else None)
        got = conv.conv2d(x, w, b, d)
        want = conv.conv2d_plain(x, w, b, d)
        err = float((got.float() - want.float()).norm()
                    / want.float().norm())
        assert err < 8e-3 and torch.equal(got, conv.conv2d(x, w, b, d)), (
            (H, W, Cin, Cout, k, d), err)
        abs_err = float((got.float() - want.float()).abs().max())
        pad = d * (k // 2)
        nbytes = (x.numel() + T * Cin * Cout + B * H * W * Cout
                  + (Cout if bias else 0)) * 2
        flops = 2 * B * H * W * T * Cin * Cout
        rows.append(dict(
            kind="conv", shape=[H, W, Cin, Cout, k, d], bias=bool(bias),
            per_forward=per_fwd, rel_err=err, max_abs_err=abs_err,
            route=type(conv._launch_args(B, H, W, Cin, Cout, k, d,
                                          True)[0]).__name__,
            ms=cuda_ms(lambda: conv.conv2d(x, w, b, d)),
            plain_ms=cuda_ms(lambda: conv.conv2d_plain(x, w, b, d)),
            library_ms=cuda_ms(lambda: F.conv2d(x, w, b, padding=pad,
                                                dilation=d)),
            bytes_ms=nbytes / PEAK_BYTES * 1e3, ops_ms=flops / 989e9))
        r = rows[-1]
        print(f"wide conv {H}x{W} {Cin}->{Cout} k{k} d{d} x{per_fwd:<2d} "
              f"{r['route']:8s} rel_err {err:.2e}  {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f}  cudnn {r['library_ms']:.4f}  bound {r['ops_ms']:.4f} (ops; bytes "
              f"{r['bytes_ms']:.4f})", flush=True)
    for H, W, C, per_fwd in table["norms"]:
        x = (torch.randn(B, C, H, W, generator=g) * 2 + 0.5).to(
            "cuda", dt).contiguous(memory_format=torch.channels_last)
        a, gm, bt = ((torch.randn(C, generator=g) * 0.1 + 1).to("cuda", dt)
                     for _ in range(3))
        got = instance_norm.instance_norm_plus(x, a, gm, bt, True)
        want = instance_norm.instance_norm_plus_plain(x, a, gm, bt, True)
        err = float((got.float() - want.float()).norm()
                    / want.float().norm())
        assert err < 8e-3 and torch.equal(
            got, instance_norm.instance_norm_plus(x, a, gm, bt, True)), (
                (H, W, C), err)
        nbytes = (2 * B * H * W * C + 3 * C) * 2
        rows.append(dict(
            kind="norm", shape=[H, W, C], per_forward=per_fwd, rel_err=err,
            max_abs_err=float((got.float() - want.float()).abs().max()),
            route=type(instance_norm.launch_plan(B, H, W, C, dt)).__name__,
            ms=cuda_ms(lambda: instance_norm.instance_norm_plus(
                x, a, gm, bt, True)),
            device_ms=profiled_ms(lambda: instance_norm.instance_norm_plus(
                x, a, gm, bt, True), "instance_norm_plus"),
            plain_ms=cuda_ms(lambda: instance_norm.instance_norm_plus_plain(
                x, a, gm, bt, True)),
            bytes_ms=nbytes / PEAK_BYTES * 1e3))
        r = rows[-1]
        print(f"wide norm {H}x{W}x{C} x{per_fwd} {r['route']} rel_err "
              f"{err:.2e}  {r['ms']:.4f} ms (device {r['device_ms']:.4f})  "
              f"plain {r['plain_ms']:.4f}  bound {r['bytes_ms']:.4f} (bytes)",
              flush=True)
    sums = {}
    for kind in ("conv", "norm"):
        sel = [r for r in rows if r["kind"] == kind]
        tot = lambda k: sum(r[k] * r["per_forward"] for r in sel)
        ops = sum(r.get("ops_ms", 0.0) * r["per_forward"] for r in sel)
        sums[kind] = dict(
            ms=tot("ms"), plain_ms=tot("plain_ms"),
            library_ms=tot("library_ms") if kind == "conv" else None,
            bound_ms=sum(max(r["bytes_ms"], r.get("ops_ms", 0.0))
                         * r["per_forward"] for r in sel),
            bound_by="bytes" if tot("bytes_ms") >= ops else "operations",
            max_abs_err=max(r["max_abs_err"] for r in sel),
            routes=sorted({r["route"] for r in sel}))
        f = sums[kind]
        print(f"# wide {kind}s of one forward at batch {B}: {f['ms']:.3f} ms,"
              f" bound {f['bound_ms']:.3f} ms "
              f"({100 * f['bound_ms'] / f['ms']:.1f}%), plain "
              f"{f['plain_ms']:.3f} ms"
              + (f", cuDNN {f['library_ms']:.3f} ms" if kind == "conv"
                 else ""), flush=True)
    assert sums["conv"]["routes"] == ["WidePlan"], sums["conv"]["routes"]
    assert sums["norm"]["routes"] == ["TwoPassPlan"], sums["norm"]["routes"]

    # the model itself, through the inpainting sampler's captured step
    n_conv = sum(r[-1] for r in table["convs"])
    n_norm = sum(r[-1] for r in table["norms"])
    model = NCSNv2Deepest(dataclasses.replace(ModelConfig(), ngf=128), 3)
    model.init_parameters(g)
    model = model.cuda()
    score = score_fn_from_params(model, dt)
    sig = get_sigmas(348.0, 0.01, 2311)[::32][:WIDE_LEVELS].float()  # ffhq.yml
    refer = torch.rand(B, 256, 256, 3, generator=g).cuda()
    mask = torch.zeros(1, 1, 256, 1, device="cuda")
    mask[:, :, :128] = 1.0  # the left half known, as in the FFHQ cell
    x0 = torch.rand(B, 256, 256, 3, generator=g).cuda()
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    y = annealed_langevin_inpainting(
        score, x0, refer, mask, sig, n_steps_each=3, step_lr=9e-7 * 32,
        generator=torch.Generator(device="cuda").manual_seed(5))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = kernels.counts()
    nfe = WIDE_LEVELS * 3
    assert torch.isfinite(y).all() and y.shape == x0.shape
    want = {"conv2d_taps": {"launches": n_conv * nfe, "plain": 0},
            "conv2d_taps.wide": {"launches": n_conv * nfe},
            "instance_norm_plus": {"launches": n_norm * nfe, "plain": 0},
            "instance_norm_plus.two_pass": {"launches": n_norm * nfe},
            "max_pool_5x5": {"launches": 12 * nfe, "plain": 0,
                             "autograd": 0},
            "mean_pool_2x2": {"launches": 6 * nfe, "autograd": 0,
                              "plain": 0}}
    assert {k: n[k] for k in want} == want, n
    print(f"# wide inpainting: NCSNv2-Deepest ngf 128, {B} rows of "
          f"256x256x3, {WIDE_LEVELS} levels x 3 steps in {secs:.2f} s "
          f"(capture included); launches {({k: n[k] for k in want})}",
          flush=True)
    del model, score
    return dict(rows=rows, sums=sums,
                inpaint=dict(seconds=secs, forwards=nfe,
                             counts={k: n[k] for k in want}))


WIDE_TRAIN_BATCH = 16   # the FFHQ training cell's rows a card
WIDE_TRAIN_REPS = 5


def ffhq_train_config(batch: int):
    """The port's `Config` of the FFHQ recipe's training half
    (ermongroup/ncsnv2 configs/ffhq.yml): NCSNv2-Deepest ngf 128 on 3
    channels, sigmas geometric 348 -> 0.01 over 2311, Adam 1e-4 eps 1e-8,
    EMA 0.999, f32 (TF32 off), `batch` rows."""
    import dataclasses

    from score_based_channels_torch.config import default_score_config

    c = default_score_config("CDL-C")
    return c.replace(
        model=dataclasses.replace(
            c.model, ngf=128, sigma_begin=348.0, num_classes=2311,
            sigma_rate=(0.01 / 348.0) ** (1.0 / 2310), ema_rate=0.999),
        optim=dataclasses.replace(c.optim, lr=1e-4, eps=1e-8),
        training=dataclasses.replace(c.training, batch_size=batch,
                                     anneal_power=2.0,
                                     matmul_precision="highest"),
        data=dataclasses.replace(c.data, channels=3))


def wide_train_phase(g):
    """Phase 15b: the FFHQ model's training path in f32 (TF32 off). Every
    forward and input-gradient conv shape of one training step
    (`conv_f32_bench.step_launches`, the model's census) at the cell's
    batch of WIDE_TRAIN_BATCH, through the conv's autograd Function
    against `conv2d_plain` and autograd through it (1e-5 of max|plain|),
    each kernel launch, forward and dgrad, twice for equal bits; each
    timed (CUDA events, median) beside `conv2d_plain`, cuDNN and the
    bound, summed per step over the wide route's launches. Every FFHQ norm
    shape through the norm's Function (two-pass forward, closed-form
    backward) against the plain autograd at batch 2; then three DSM steps
    at batch 2 through `TrainChunkRunner` with the launch counts of every
    route and the card ms of a replayed step."""
    from score_based_channels_torch import kernels
    from score_based_channels_torch.kernels import conv, instance_norm
    from score_based_channels_torch.kernels.conv_f32_bench import (
        bound_ms, step_launches)
    from score_based_channels_torch.train.score import TrainChunkRunner

    dev, B, reps = torch.device("cuda"), WIDE_TRAIN_BATCH, WIDE_TRAIN_REPS
    gc = torch.Generator(device=dev).manual_seed(15)
    worst = {"conv": 0.0, "dgrad": 0.0, "norm": 0.0}
    rows, fwd = [], [r for r in step_launches("ffhq", "cuda")
                     if r[-1] == "fwd"]
    for H, W, Cin, Cout, k, d, bias, n, _ in fwd:
        pad = d * (k // 2)
        x = torch.randn(B, Cin, H, W, generator=gc, device=dev).contiguous(
            memory_format=torch.channels_last)
        w = conv.kernel_layout(torch.randn(Cout, Cin, k, k, generator=gc,
                                           device=dev) / (k * k * Cin) ** 0.5)
        b = torch.randn(Cout, generator=gc, device=dev) if bias else None
        gout = torch.randn(B, Cout, H, W, generator=gc, device=dev)
        xa, xb = (x.clone().requires_grad_() for _ in range(2))
        got, want = conv.conv2d(xa, w, b, d, True), conv.conv2d_plain(
            xb, w, b, d, True)
        got.backward(gout)
        want.backward(gout)
        e = [float((a - c).abs().max() / c.abs().max())
             for a, c in ((got, want), (xa.grad, xb.grad))]
        a_err = [float((a - c).abs().max())
                 for a, c in ((got, want), (xa.grad, xb.grad))]
        assert max(e) <= 1e-5, ((H, W, Cin, Cout, k, d), e)
        del got, want, xa, xb
        g_cl = gout.contiguous(memory_format=torch.channels_last)
        wt = conv.transposed_weight(w)
        assert torch.equal(conv.conv2d(x, w, b, d, True),
                           conv.conv2d(x, w, b, d, True))
        assert torch.equal(conv.conv2d(g_cl, wt, None, d),
                           conv.conv2d(g_cl, wt, None, d))
        worst["conv"], worst["dgrad"] = (max(worst["conv"], e[0]),
                                         max(worst["dgrad"], e[1]))
        T = len(conv.live_taps(k, d, H, W))
        m = 0 if Cin == 3 else n  # the conv reading the data: no dgrad
        for kind, count, ci, co, err, fn, plain, lib in (
                ("fwd", n, Cin, Cout, a_err[0],
                 lambda: conv.conv2d(x, w, b, d, True),
                 lambda: conv.conv2d_plain(x, w, b, d, True),
                 lambda: F.conv2d(x, w, b, padding=pad, dilation=d)),
                ("dgrad", m, Cout, Cin, a_err[1],
                 lambda: conv.conv2d(g_cl, wt, None, d),
                 lambda: conv.conv2d_plain(g_cl, wt, None, d),
                 lambda: torch.ops.aten.convolution_backward(
                     g_cl, x, w, None, [1, 1], [pad, pad], [d, d], False,
                     [0, 0], 1, [True, False, False]))):
            if not count:
                continue
            rows.append(dict(
                kind=kind, shape=[H, W, ci, co, k, d], count=count,
                wide=conv.takes_wide(W, ci, co), max_abs_err=err,
                ms=cuda_ms(fn, reps), plain_ms=cuda_ms(plain, reps),
                library_ms=cuda_ms(lib, reps),
                bound_ms=bound_ms(B, H, W, ci, co, T,
                                  bias and kind == "fwd"),
                ops_ms=2 * B * H * W * T * ci * co / 67e12 * 1e3,
                bytes_ms=4 * (B * H * W * (ci + co) + T * ci * co + co)
                / PEAK_BYTES * 1e3))
            r = rows[-1]
            print(f"f32 {kind:5s} {H}x{W} {ci}->{co} k{k} d{d} x{count:<2d} "
                  f"{'wide' if r['wide'] else 'resident'} {r['ms']:.4f} ms "
                  f"plain {r['plain_ms']:.4f} cudnn {r['library_ms']:.4f} "
                  f"bound {r['bound_ms']:.4f}", flush=True)
        del x, w, b, gout, g_cl, wt
    torch.cuda.empty_cache()
    launches = {kind: sum(r["count"] for r in rows
                          if r["kind"] == kind and r["wide"])
                for kind in ("fwd", "dgrad")}
    assert launches == {"fwd": 104, "dgrad": 103}, launches
    wide = [r for r in rows if r["wide"]]
    step = {key: sum(r[key] * r["count"] for r in wide)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                        "ops_ms", "bytes_ms")}
    step["bound_by"] = ("bytes" if step["bytes_ms"] >= step["ops_ms"]
                        else "operations")
    step.update({f"{kind}_{key}": sum(r[key] * r["count"] for r in wide
                                      if r["kind"] == kind)
                 for kind in ("fwd", "dgrad")
                 for key in ("ms", "library_ms", "bound_ms")})
    step["max_abs_err"] = max(r["max_abs_err"] for r in wide)
    print(f"# wide_train: the f32 wide route's {launches['fwd']} forward + "
          f"{launches['dgrad']} dgrad launches of an FFHQ training step at "
          f"batch {B}: {step['ms']:.3f} ms (forward {step['fwd_ms']:.3f}, "
          f"dgrad {step['dgrad_ms']:.3f}), cuDNN {step['library_ms']:.3f} "
          f"(forward {step['fwd_library_ms']:.3f}, dgrad "
          f"{step['dgrad_library_ms']:.3f}), plain {step['plain_ms']:.3f}, "
          f"bound {step['bound_ms']:.3f} ms ({step['bound_by']}, "
          f"{100 * step['bound_ms'] / step['ms']:.1f}%); worst rel err "
          f"{worst}", flush=True)

    table = json.loads((ROOT / "perfbench" / "shapes" /
                        "ncsnv2_deepest_ffhq256.json").read_text())
    for H, W, C, _ in table["norms"]:
        x = (torch.randn(2, C, H, W, generator=g) * 2 + 0.5).to(
            dev).contiguous(memory_format=torch.channels_last)
        ps = [(torch.randn(C, generator=g) * 0.1 + 1).to(dev)
              for _ in range(3)]
        gout = torch.randn(x.shape, generator=g).to(dev)
        leaves = [t.clone().requires_grad_() for t in [x] + ps]
        ref = [t.clone().requires_grad_() for t in [x] + ps]
        instance_norm.instance_norm_plus(*leaves, elu=True).backward(gout)
        instance_norm.instance_norm_plus_plain(*ref, elu=True).backward(gout)
        for a, c in zip(leaves, ref):  # sums over up to 65,536 pixels
            e = float((a.grad - c.grad).abs().max() / c.grad.abs().max())
            assert e <= 1e-4 and float((a.grad - c.grad).norm()
                                       / c.grad.norm()) <= 1e-5, (H, W, C)
            worst["norm"] = max(worst["norm"], e)
    print(f"# wide_train: two-pass norm under grad at batch 2: worst rel "
          f"err {worst['norm']:.2e}", flush=True)

    from score_based_channels_torch.diffusion.ema import ema_init
    from score_based_channels_torch.models.ncsnv2 import NCSNv2Deepest
    from score_based_channels_torch.train.score import (
        ScoreTrainer, ScoreTrainState, make_optimizer)

    cfg = ffhq_train_config(2)
    model = NCSNv2Deepest(cfg.model, 3)
    model.init_parameters(g)
    model = model.to(dev)
    state = ScoreTrainState(model=model, ema=ema_init(model),
                            opt=make_optimizer(model, cfg.optim), step=0)
    trainer = ScoreTrainer(cfg, device=dev)
    x_all = torch.rand(4, 256, 256, 3, generator=g).to(dev)
    runner = TrainChunkRunner(trainer.update, state, x_all, 2, 3,
                              torch.Generator(device=dev), 10)
    kernels.reset_counts()
    losses = runner.run(torch.tensor([[0, 1], [2, 3], [1, 2]]), [1, 2, 3])
    n = kernels.counts()
    assert torch.isfinite(losses).all()
    assert n["conv2d_taps"] == {"launches": 3 * 225, "plain": 0}, n
    assert n["conv2d_taps.f32_wide"] == {"launches": 3 * 104}, n
    assert n["conv2d_taps.f32_wide.dgrad"] == {"launches": 3 * 103}, n
    assert n["instance_norm_plus"] == {"launches": 75, "plain": 0}, n
    assert n["instance_norm_plus.two_pass"] == {"launches": 75}, n
    routes = {k: n[k] for k in ("conv2d_taps", "conv2d_taps.f32_wide",
                                "conv2d_taps.f32_wide.dgrad",
                                "instance_norm_plus",
                                "instance_norm_plus.two_pass")}
    ms = cuda_ms(lambda: runner.run(torch.tensor([[0, 1]]), [4]), reps=3)
    print(f"# wide_train: 3 FFHQ DSM steps at batch 2 through the runner, "
          f"launches {routes}; a replayed step {ms:.1f} ms (card, events)",
          flush=True)
    del runner, state, trainer, model
    torch.cuda.empty_cache()
    return dict(rows=rows, step=step, batch=B, worst_rel_err=worst,
                counts=routes, replay_ms=ms, losses=losses.tolist())


def distributed_phase():
    """parallel/mp_smoke.run_smoke on NCCL at world size 1 (tcp on
    127.0.0.1): DIST_STEPS data-parallel DSM steps of the full-width
    network in f32 at batch 32, rank 0's checkpoint restored bit for bit,
    a sweep chunk (every 100th level) from the restored EMA; then the same
    run with no process group, held to it: losses, each parameter and EMA
    tensor norm-wise, and the traces, to DIST_TOL. Both runs take
    deterministic algorithms (`deterministic_algorithms`)."""
    import socket

    import torch.distributed as dist

    from score_based_channels_torch import _graph, kernels
    from score_based_channels_torch.config import ModelConfig
    from score_based_channels_torch.diffusion import sampling
    from score_based_channels_torch.diffusion.sigmas import (
        sigmas_from_config, subsample_schedule,
    )
    from score_based_channels_torch.models.convert import tree_leaves
    from score_based_channels_torch.parallel import multihost
    from score_based_channels_torch.parallel.mp_smoke import run_smoke

    from score_based_channels_torch.train import score as train_score

    mcfg = ModelConfig()
    sig, scale = subsample_schedule(sigmas_from_config(mcfg), DIST_STRIDE)
    train_cfg = train_graph_config(data_parallel=True)
    # the WGAN phase's inversion leaves ~76 GiB in the caching allocator;
    # NCCL allocates its buffers outside it, and fails on a full card
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(device="cuda", ngf=mcfg.ngf, num_classes=mcfg.num_classes,
                  batch=DIST_BATCH, steps=DIST_STEPS, sigmas=sig,
                  alpha_step=3e-11 * scale)
        with deterministic_algorithms():
            backend = multihost.initialize(f"127.0.0.1:{port}", 1, 0,
                                           device="cuda")
            assert backend == "nccl" and dist.get_backend() == "nccl"
            try:
                kernels.reset_counts()
                reset_stats()
                t0 = time.perf_counter()
                dp = run_smoke(ckpt_path=os.path.join(tmp, "dp.npz"), **kw)
                torch.cuda.synchronize()
                dp_s = time.perf_counter() - t0
                launches = kernels.counts()
                grads = kernels.grad_counts()
                sweep = dict(sampling.STATS, **_graph.STATS)
                # ScoreTrainer.train on the group: the gradients' all-reduce
                # inside the captured step
                train_score.reset_stats()
                _graph.reset_stats()
                t0 = time.perf_counter()
                train_dp = train_run(train_cfg)
                train_dp_s = time.perf_counter() - t0
                train_stats = dict(train_score.STATS, **_graph.STATS)
            finally:
                dist.destroy_process_group()
            t0 = time.perf_counter()
            one = run_smoke(ckpt_path=os.path.join(tmp, "one.npz"), **kw)
            one_s = time.perf_counter() - t0
            train_same = train_runs_differ(train_dp, train_run(train_cfg))
    for k in ("conv2d_taps", "instance_norm_plus"):
        assert launches[k]["launches"] > 0 and launches[k]["plain"] == 0, \
            launches
    assert grads["conv2d_taps"]["dgrad"] > 0, grads
    # the sweep chunk: one capture, level 0 eager, the others replayed
    assert sweep["captures"] == 1, sweep
    assert sweep["levels"] == sig.shape[0], sweep
    assert sweep["replays"] == sig.shape[0] - 1, sweep
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(dp["losses"],
                                                      one["losses"]))
    par_err = max(float(np.linalg.norm(a - b) / np.linalg.norm(b))
                  for name in ("params", "ema")
                  for a, b in zip(tree_leaves(dp[name]), tree_leaves(one[name])))
    trace_err = float(np.abs(dp["trace"] - one["trace"]).max()
                      / np.abs(one["trace"]).max())
    print(f"# distributed (NCCL, world 1): {DIST_STEPS} steps at batch "
          f"{DIST_BATCH} f32 + checkpoint round trip ({dp['ckpt']}) + sweep "
          f"chunk of {sig.shape[0]} levels: {dp_s:.2f} s (no group "
          f"{one_s:.2f} s); losses {np.round(dp['losses'], 3).tolist()}, "
          f"NMSE {dp['nmse_db']:.2f} dB; vs no group: loss {loss_err:.1e}, "
          f"params {par_err:.1e}, trace {trace_err:.1e} (tol {DIST_TOL:g}); "
          f"launches {launches}; sweep through the graph: {sweep}",
          flush=True)
    assert np.isfinite(dp["trace"]).all()
    assert max(loss_err, par_err, trace_err) <= DIST_TOL
    print(f"# distributed ScoreTrainer.train (NCCL, world 1, the all-reduce "
          f"in the captured step): {train_dp[0].step} steps in "
          f"{train_dp_s:.2f} s, the runner {train_stats}; bit-equal to no "
          f"group: {train_same[0]} (largest norm-wise {train_same[1]:.2e})",
          flush=True)
    assert train_stats["captures"] == 1, train_stats
    assert train_same[0], train_same
    return dict(train_seconds=train_dp_s, train_runner=train_stats,
                train_bit_equal=train_same[0],
                seconds=dp_s, seconds_no_group=one_s, losses=dp["losses"],
                nmse_db=dp["nmse_db"], loss_err=loss_err, param_err=par_err,
                trace_err=trace_err, levels=int(sig.shape[0]),
                launches=launches, grad_counts=grads, sweep=sweep)


def trace_phase(model):
    """Two bench forwards (bf16, batch 256) under torch.profiler, the
    chrome trace exported and read by utils/trace_analysis.summarize: its
    device total against the profiler's own key_averages within 1%, the
    two kernels under their names, its top 5 lines."""
    import io

    from torch.profiler import ProfilerActivity, profile

    from score_based_channels_torch import kernels
    from score_based_channels_torch.eval.estimate import score_fn_from_params
    from score_based_channels_torch.utils import trace_analysis

    g = torch.Generator().manual_seed(11)
    x = torch.randn(BATCH, 64, 16, 2, generator=g).cuda()
    sig = (torch.rand(BATCH, generator=g) + 0.1).cuda()
    score = score_fn_from_params(model, torch.bfloat16)
    score(x, sig)
    torch.cuda.synchronize()
    kernels.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            score(x, sig)
        torch.cuda.synchronize()
    launches = kernels.counts()
    assert launches["conv2d_taps"] == {"launches": 226, "plain": 0}, launches
    assert launches["instance_norm_plus"] == {"launches": 50, "plain": 0}
    prof_ms = sum(device_ms_by_name(prof).values())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bench_forward.pt.trace.json")
        prof.export_chrome_trace(path)
        summary = trace_analysis.summarize(tmp, top=5, out=io.StringIO())
    names = list(summary["by_name"])
    share = {k: sum(r["share"] for n, r in summary["by_name"].items()
                    if k in n) for k in ("conv2d_taps", "instance_norm_plus")}
    top = trace_analysis.top_lines(summary, 5)
    print(f"# trace: 2 bf16 forwards at batch 256, trace_analysis device "
          f"total {summary['total_ms']:.3f} ms in {summary['events']} events, "
          f"profiler key_averages {prof_ms:.3f} ms; shares {share}")
    for line in top:
        print("#   " + line)
    assert prof_ms > 0
    assert abs(summary["total_ms"] - prof_ms) <= 0.01 * prof_ms
    assert all(any(k in n for n in names) for k in share), names[:20]
    return dict(total_ms=summary["total_ms"], profiler_ms=prof_ms,
                events=summary["events"], shares=share, top=top,
                by_category=summary["by_category"], launches=launches)


GRAPH_HOLD_MS = 2000.0  # the spin that holds the card while the host runs


def graph_phase(score, A, Y, X, x0, noise_power, sigmas, card):
    """The graph phase (in phase 4): the bench workload (batch 256, 38
    pilots, 10 dB, bf16 network, f32 state) on `sigmas`, through the
    posterior runner's graph and through the same runner under
    `_graph.eager()`. The first graph run (eager level 0, the capture, the
    replays) against the eager run: equal bits, or within 1e-5 of
    max|eager|; a second run that replays every level gives the first
    run's bits; the card's ms per level and per forward with graph runs
    back to back (CUDA events); the device busy share of a profiler
    window of 2 levels under the graph; the capture's seconds and the
    graph pool's MB. The `deepest.estimate.bf16` benchmark cell times
    this path end to end."""
    from torch.profiler import ProfilerActivity, profile

    from score_based_channels_torch import _graph
    from score_based_channels_torch.diffusion.sampling import PosteriorRunner

    levels = sigmas.shape[0]
    sigmas = sigmas.cuda()
    noise_power, alpha, beta = (torch.tensor(v, device="cuda") for v in
                                (noise_power, 3e-11, 0.01))
    kw = dict(alpha_step=alpha, beta_noise=beta, oracle=X)

    def graph_runner(sig=sigmas):
        runner = PosteriorRunner(score, sig, torch.Generator(device="cuda"),
                                 steps_each=3)

        def run():
            runner.generator.manual_seed(2)
            return runner.run(A, Y, noise_power, x0, **kw)
        return runner, run

    reset_stats()
    runner, graph = graph_runner()
    (xg, tg), first_s = timed(graph)  # eager level 0, capture, replays
    xg, tg = xg.clone(), tg.clone()
    stats = dict(_graph.STATS)
    with _graph.eager():
        xe, te = graph_runner()[1]()
    same = bool(torch.equal(xg, xe) and torch.equal(tg, te))
    err = max(max_rel(xg, xe), max_rel(tg, te))
    rec = runner.replayer.cap.launches
    print(f"# graph phase, bench workload ({BATCH} x {levels} levels, bf16 "
          f"network): first graph run {first_s:.3f} s (capture "
          f"{stats['capture_seconds']:.3f} s, graph pool "
          f"{stats['pool_bytes'] / 2**20:.1f} MB, {rec['conv2d_taps']} conv "
          f"+ {rec['instance_norm_plus']} norm launches a replay); x_final "
          f"and trace bit-equal to the eager runner: {same} (max rel diff "
          f"{err:.2e}, tol 1e-5) on {card}", flush=True)
    assert err <= 1e-5, err
    assert rec["conv2d_taps"] == 113 * 3 and rec["instance_norm_plus"] == 75
    graph()
    rerun_same = bool(torch.equal(runner.x, xg)
                      and torch.equal(runner.trace, tg))
    print(f"#   a run that replays every level gives the first run's bits: "
          f"{rerun_same}")
    assert rerun_same

    # the card's time with graph runs back to back
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reps = 3
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph()
    end.record()
    torch.cuda.synchronize()
    card_ms_level = start.elapsed_time(end) / (reps * levels)
    print(f"#   card time under the graph, {reps} runs back to back: "
          f"{card_ms_level:.4f} ms per level, {card_ms_level / 3:.4f} ms per "
          f"forward (the level's sampler ops included)")

    # a profiler window of 2 levels: the graph replays both
    _, graph2 = graph_runner(sigmas[:2])
    graph2()
    graph2()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        graph2()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_ms_by_name(prof)
    busy = sum(by_name.values())
    window = dict(wall_ms=wall_ms, busy_ms=busy, by_name=by_name)
    print(f"#   profile, 2 levels (6 forwards), graph: wall {wall_ms:.1f} ms, "
          f"device busy {busy:.1f} ms ({100 * busy / wall_ms:.1f}%)" if busy
          else "#   profile, 2 levels, graph: no device time reported (not "
          "measured)")
    return dict(levels=levels, first_run_seconds=first_s, stats=stats,
                bit_equal=same, max_rel_diff=err, rerun_bit_equal=rerun_same,
                card_ms_per_level=card_ms_level,
                card_ms_per_forward=card_ms_level / 3, recorded=rec,
                windows={"graph": window})


def per_forward(rows, dtype):
    """Sum over one bf16 (or f32) forward's calls of each timing."""
    sel = [r for r in rows if r["dtype"] == dtype]
    tot = lambda k: sum(r[k] * r["per_forward"] for r in sel)
    lib = (None if any(r["library_ms"] is None for r in sel)
           else tot("library_ms"))
    bound = sum(max(r["bytes_ms"], r["ops_ms"]) * r["per_forward"]
                for r in sel)
    return dict(ms=tot("ms"), plain_ms=tot("plain_ms"), library_ms=lib,
                bound_ms=bound, bound_by="bytes"
                if tot("bytes_ms") >= tot("ops_ms") else "operations")


def write_channels(data_dir, seed, n, rng):
    """Channel file in the reference naming: (n, 1 subcarrier, Nr, Nt),
    spatially correlated so the LMMSE warm start has structure to use."""
    corr_t = np.exp(-0.3 * np.abs(np.subtract.outer(np.arange(64),
                                                    np.arange(64))))
    lt = np.linalg.cholesky(corr_t + 1e-6 * np.eye(64))
    g = (rng.standard_normal((n, 16, 64))
         + 1j * rng.standard_normal((n, 16, 64))) / np.sqrt(2)
    h = (g @ lt.T)[:, None].astype(np.complex64)
    np.savez(os.path.join(data_dir, f"CDL-C_Nt64_Nr16_ULA0.50_seed{seed}.npz"),
             output_h=h)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs on the card")
    from score_based_channels_torch import cplx, kernels, physics
    from score_based_channels_torch.config import Config, DataConfig, ModelConfig
    from score_based_channels_torch.diffusion.sampling import (
        annealed_langevin_posterior_c2,
    )
    from score_based_channels_torch.diffusion.sigmas import get_sigmas
    from score_based_channels_torch.comms.link import main as link_main
    from score_based_channels_torch.eval.estimate import (
        run_estimation, score_fn_from_params,
    )
    from score_based_channels_torch.kernels import _build
    from score_based_channels_torch.models import make_score_model

    t_start = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"# device: {torch.cuda.get_device_name(0)} "
          f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(card, flush=True)

    # -- build --------------------------------------------------------------
    _build.library()
    print(f"# build: {_build.build_seconds:.1f} s" if _build.build_seconds
          is not None else "# build: library already built for these sources")
    for line in build_summary(_build.build_log):
        print("#   " + line)

    # -- kernels at every main-path shape -------------------------------------
    g = torch.Generator().manual_seed(0)
    model = make_score_model(ModelConfig(), device="cuda", generator=g)
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == 5_890_082, n_params
    convs, norms = census(model)
    n_conv, n_norm = sum(convs.values()), sum(norms.values())
    print(f"# census of one forward: {n_conv} convs in "
          f"{len({k[:6] for k in convs})} shapes, {n_norm} norms in "
          f"{len(norms)} shapes")
    assert (n_conv, n_norm) == (113, 25), (n_conv, n_norm)
    conv_rows = check_convs(convs, g)
    norm_rows = check_norms(norms, g)
    ldpc_rows = check_ldpc(g)
    pools = check_pools()

    # -- main path ------------------------------------------------------------
    x = torch.randn(16, 64, 16, 2, generator=g)
    sig = torch.rand(16, generator=g) * 2 + 0.05
    cpu_model = make_score_model(ModelConfig(), device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = cpu_model(x, sig)
        got32 = model(x.cuda(), sig.cuda()).cpu()
    got16 = score_fn_from_params(model, torch.bfloat16)(x.cuda(), sig.cuda())
    fwd_err32 = ((got32 - want).abs().max() / want.abs().max()).item()
    fwd_err16 = (torch.linalg.norm(got16.cpu() - want)
                 / torch.linalg.norm(want)).item()
    print(f"# forward, kernels on the card vs plain on the CPU, batch 16: f32 "
          f"max rel err {fwd_err32:.2e} (tol 2e-4), bf16 rel norm err "
          f"{fwd_err16:.2e} (tol 5e-2)")
    assert fwd_err32 < 2e-4 and fwd_err16 < 5e-2
    assert got16.dtype == torch.float32 and torch.isfinite(got16).all()

    score_bf16 = score_fn_from_params(model, torch.bfloat16)
    calls = [0]

    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(0)
        write_channels(tmp, 1234, 1200, rng)  # train: stats, full-rank cov
        write_channels(tmp, 4321, 32, rng)    # test channels
        cfg = Config(data=DataConfig(source="file", data_dir=tmp))
        stride = 64
        kernels.reset_counts()
        reset_stats()
        t0 = time.perf_counter()
        chan = os.path.join(tmp, "channels.npz")
        res = run_estimation(counting(score_bf16, calls), cfg,
                             snr_range=np.array([0., 20.]),
                             num_channels=32, level_stride=stride, init="auto",
                             sigma_start=0.05, chunk_size=64, device="cuda",
                             save_channels_to=chan)
        torch.cuda.synchronize()
        est_s = time.perf_counter() - t0
        launches = kernels.counts()
        nfe = graph_forwards(calls[0], runs=1)
        # the `link` command on the saved estimates, on the card by default
        link_out = os.path.join(tmp, "link.npz")
        link_main(["--channels", chan, "--output", link_out])
        with np.load(link_out) as f:
            assert f["ber_est"].shape == (2,)
            assert np.isfinite(f["ber_est"]).all()
            assert np.isfinite(f["ber_ideal"]).all()
    n_levels = len(get_sigmas(39.15, cfg.model.sigma_end, 2311)[::stride]) + 1
    print(f"# run_estimation: {res.nmse_log.shape} trace, {nfe} forwards "
          f"at batch 64 in {est_s:.1f} s; best NMSE dB "
          f"{np.round(res.best_nmse_db().ravel(), 2).tolist()}; launches "
          f"{launches}")
    assert res.nmse_log.shape == (1, 1, 2, n_levels * 3, 32)
    assert np.isfinite(res.nmse_log).all()
    assert nfe == n_levels * 3
    assert launches["conv2d_taps"] == {"launches": 113 * nfe, "plain": 0}
    assert launches["instance_norm_plus"] == {"launches": 25 * nfe,
                                              "plain": 0}
    assert launches["max_pool_5x5"] == {"launches": 12 * nfe, "plain": 0,
                                        "autograd": 0}, launches
    assert launches["mean_pool_2x2"] == {"launches": 6 * nfe, "autograd": 0,
                                         "plain": 0}, launches

    # bench.py workload on a truncated schedule: its launch counts (the
    # deepest.estimate.bf16 benchmark cell times this path)
    levels = 24
    mcfg = ModelConfig(num_classes=levels)
    sigmas = get_sigmas(mcfg.sigma_begin, mcfg.sigma_end, levels)
    gb = torch.Generator().manual_seed(1)
    X = cplx.randn(gb, (BATCH, 64, 16)).cuda()
    A = cplx.conj_transpose(cplx.qpsk_pilots(gb, BATCH, 64, 38)).cuda()
    noise_power = float(physics.snr_to_noise_power(10.0, 64))
    Y = physics.measure_c2(gb, A.cpu(), X.cpu(), noise_power).cuda()
    x0 = cplx.randn(gb, (BATCH, 64, 16)).cuda()

    def bench(sig_sched, score=score_bf16):
        return annealed_langevin_posterior_c2(
            score, A, Y, sig_sched, noise_power, x0,
            generator=torch.Generator(device="cuda").manual_seed(2),
            alpha_step=3e-11, beta_noise=0.01, steps_each=3, oracle=X)

    bench(sigmas[:2])  # warm-up
    kernels.reset_counts()
    reset_stats()
    calls = [0]
    _, trace = bench(sigmas, counting(score_bf16, calls))
    bench_counts = kernels.counts()
    fw = graph_forwards(calls[0], runs=1)
    assert fw == levels * 3 and torch.isfinite(trace).all()
    assert bench_counts["conv2d_taps"] == {"launches": 113 * fw,
                                           "plain": 0}, bench_counts
    assert bench_counts["instance_norm_plus"] == {"launches": 25 * fw,
                                                  "plain": 0}
    assert bench_counts["max_pool_5x5"] == {
        "launches": 12 * fw, "plain": 0, "autograd": 0}, bench_counts
    assert bench_counts["mean_pool_2x2"] == {
        "launches": 6 * fw, "autograd": 0, "plain": 0}, bench_counts
    print(f"# bench workload: {BATCH} estimates x {levels} levels, {fw} "
          f"forwards; launches {bench_counts}")

    graph = graph_phase(score_bf16, A, Y, X, x0, noise_power, sigmas, card)
    win = graph["windows"]["graph"]
    by_name, busy, wall_ms = win["by_name"], win["busy_ms"], win["wall_ms"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print("# profile under the graph, top kernels of the 2-level window:")
    for name, ms in top:
        print(f"#   {ms:9.3f} ms  {name[:90]}")
    # each kernel's device time inside the path, per forward (6 in the window)
    path_ms = {k: sum(ms for n, ms in by_name.items() if k in n) / 6
               for k in ("conv2d_taps", "instance_norm_plus")}
    print(f"# in-path ms per forward: {path_ms}")

    # -- link path ------------------------------------------------------------
    link_res = link_phase(card)

    # -- conv probe -----------------------------------------------------------
    probe = conv_probe_phase(convs, conv_rows, model, g)

    # -- train path, then the comparison side from its checkpoint -------------
    with tempfile.TemporaryDirectory() as tmp:
        ck_path = os.path.join(tmp, "final_model.npz")
        train = train_phase(convs, norms, card, g, ck_path)
        t0 = time.perf_counter()
        evals = eval_phase(ck_path, card)
        evals["seconds"] = time.perf_counter() - t0
        print(f"# eval phase: {evals['seconds']:.1f} s")

    # -- the other score models and samplers, LDAMP, WGAN, native CDL ---------
    later = {}
    for name, run in (("archs", lambda: archs_phase(convs, norms, g)),
                      ("samplers", lambda: samplers_phase(model, g)),
                      ("ldamp", lambda: ldamp_phase(card)),
                      ("wgan", lambda: wgan_phase(card)),
                      ("native_cdl", native_phase),
                      ("variants", lambda: variants_phase(g)),
                      ("wide", lambda: wide_phase(g)),
                      ("wide_train", lambda: wide_train_phase(g)),
                      ("distributed", distributed_phase),
                      ("trace", lambda: trace_phase(model))):
        t0 = time.perf_counter()
        later[name] = run()
        later[name]["phase_seconds"] = time.perf_counter() - t0
        print(f"# {name} phase: {later[name]['phase_seconds']:.1f} s",
              flush=True)

    kernel_json = []
    for name, rows in (("conv2d_taps", conv_rows),
                       ("instance_norm_plus", norm_rows)):
        src, rep = SOURCES[name]
        pf = per_forward(rows, "bfloat16")
        kernel_json.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launches[name]["launches"],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=pf["ms"], plain_ms=pf["plain_ms"], bound_ms=pf["bound_ms"],
            bound_by=pf["bound_by"], library_ms=pf["library_ms"]))
    # the wide routes: summed over one FFHQ forward at batch 8 (phase 15)
    for name, kind, src in (
            ("conv2d_taps.wide", "conv",
             "score_based_channels_torch/csrc/conv2d_taps_wide.cu"),
            ("instance_norm_plus.two_pass", "norm",
             "score_based_channels_torch/csrc/instance_norm_wide.cu")):
        f = later["wide"]["sums"][kind]
        kernel_json.append(dict(
            name=name, route="cuda", source=src,
            replaces=SOURCES[name.split(".")[0]][1],
            launches=later["wide"]["inpaint"]["counts"][name]["launches"],
            max_abs_err=f["max_abs_err"], ms=f["ms"],
            plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
            bound_by=f["bound_by"], library_ms=f["library_ms"]))
    # the f32 wide route: its launches of one FFHQ training step at batch
    # 16, forward and dgrad (phase 15b)
    f = later["wide_train"]["step"]
    kernel_json.append(dict(
        name="conv2d_taps.f32_wide", route="cuda",
        source=SOURCES["conv2d_taps"][0], replaces=SOURCES["conv2d_taps"][1],
        launches=(later["wide_train"]["counts"]["conv2d_taps.f32_wide"]
                  ["launches"]
                  + later["wide_train"]["counts"]
                  ["conv2d_taps.f32_wide.dgrad"]["launches"]),
        max_abs_err=f["max_abs_err"], ms=f["ms"], plain_ms=f["plain_ms"],
        bound_ms=f["bound_ms"], bound_by=f["bound_by"],
        library_ms=f["library_ms"]))
    big = ldpc_rows[-1]  # the link path's 256 packets
    kernel_json.append(dict(
        name="ldpc_minsum", route="cuda", source=SOURCES["ldpc_minsum"][0],
        replaces=SOURCES["ldpc_minsum"][1],
        launches=link_res["counts"]["ldpc_minsum"]["launches"],
        max_abs_err=max(r["max_abs_err"] for r in ldpc_rows), ms=big["ms"],
        plain_ms=big["plain_ms"],
        bound_ms=max(big["bytes_ms"], big["ops_ms"]),
        bound_by="bytes" if big["bytes_ms"] >= big["ops_ms"] else "operations",
        library_ms=None))
    # conv_im2col: per bf16 forward at the main path's shapes, as conv2d_taps
    pf = per_forward(probe["im2col_rows"], "bfloat16")
    kernel_json.append(dict(
        name="conv_im2col", route="cuda", source=SOURCES["conv_im2col"][0],
        replaces=SOURCES["conv_im2col"][1],
        launches=probe["harness_counts"]["conv_im2col"]["launches"],
        max_abs_err=max(r["max_abs_err"] for r in
                        probe["im2col_rows"] + probe["probe_rows"]),
        ms=pf["ms"], plain_ms=pf["plain_ms"], bound_ms=pf["bound_ms"],
        bound_by=pf["bound_by"], library_ms=pf["library_ms"]))
    # conv_chain: the probe's n = 8, d 1 chain in bf16; no single library
    # call computes a chain (the n-call one is library_chain_ms)
    ch = next(r for r in probe["chain_rows"]
              if (r["n"], r["d"], r["dtype"]) == (8, 1, "bfloat16"))
    kernel_json.append(dict(
        name="conv_chain", route="cuda", source=SOURCES["conv_chain"][0],
        replaces=SOURCES["conv_chain"][1],
        launches=probe["harness_counts"]["conv_chain"]["launches"],
        max_abs_err=max([r["max_abs_err"] for r in probe["chain_rows"]]
                        + [r["max_abs_err"] for r in
                           ch["by_cluster"].values()]),
        ms=ch["ms"], plain_ms=ch["plain_ms"],
        bound_ms=max(ch["bytes_ms"], ch["ops_ms"]),
        bound_by="bytes" if ch["bytes_ms"] >= ch["ops_ms"] else "operations",
        library_ms=None, library_chain_ms=ch["library_chain_ms"],
        cluster=ch["cluster"]))

    eig = later["ldamp"]["eigmax"]
    kernel_json.append(dict(
        name="pilot_eigmax", route="cuda", source=SOURCES["pilot_eigmax"][0],
        replaces=SOURCES["pilot_eigmax"][1],
        launches=later["ldamp"]["counts"]["pilot_eigmax"]["launches"],
        max_rel_err=max(eig["kernel_vs_plain"], eig["kernel_err"]),
        ms=eig["kernel_ms"], plain_ms=eig["plain_ms"],
        bound_ms=max(eig["ops_ms"], eig["bytes_ms"]),
        bound_by=("bytes" if eig["bytes_ms"] >= eig["ops_ms"]
                  else "operations"),
        library_ms=eig["library_ms"]))

    # the max pool: per bf16 forward at batch 256 and per FFHQ forward at
    # batch 8 (`ffhq_*`); its plain version is F.max_pool2d itself, and
    # check_pools held it equal (max_abs_err 0)
    pb, pf = pools["max.ngf32.bfloat16"], pools["max.ngf128.bfloat16"]
    kernel_json.append(dict(
        name="max_pool_5x5", route="cuda", source=SOURCES["max_pool_5x5"][0],
        replaces=SOURCES["max_pool_5x5"][1],
        launches=launches["max_pool_5x5"]["launches"], max_abs_err=0.0,
        ms=pb["kernel_ms"], plain_ms=pb["library_ms"],
        bound_ms=pb["bound_ms"], bound_by="bytes",
        library_ms=pb["library_ms"], ffhq_ms=pf["kernel_ms"],
        ffhq_bound_ms=pf["bound_ms"], ffhq_library_ms=pf["library_ms"],
        ffhq_launches=later["wide"]["inpaint"]["counts"]["max_pool_5x5"][
            "launches"]))
    # the mean pool, the same way; its plain version is F.avg_pool2d
    pb, pf = pools["mean.ngf32.bfloat16"], pools["mean.ngf128.bfloat16"]
    kernel_json.append(dict(
        name="mean_pool_2x2", route="cuda",
        source=SOURCES["mean_pool_2x2"][0],
        replaces=SOURCES["mean_pool_2x2"][1],
        launches=launches["mean_pool_2x2"]["launches"], max_abs_err=0.0,
        ms=pb["kernel_ms"], plain_ms=pb["library_ms"],
        bound_ms=pb["bound_ms"], bound_by="bytes",
        library_ms=pb["library_ms"], ffhq_ms=pf["kernel_ms"],
        ffhq_bound_ms=pf["bound_ms"], ffhq_library_ms=pf["library_ms"],
        ffhq_launches=later["wide"]["inpaint"]["counts"]["mean_pool_2x2"][
            "launches"]))

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, torch=torch.__version__, cuda=torch.version.cuda,
        build_seconds=_build.build_seconds, kernels=kernel_json,
        per_forward_f32={n: per_forward(r, "float32") for n, r in
                         (("conv2d_taps", conv_rows),
                          ("instance_norm_plus", norm_rows),
                          ("conv_im2col", probe["im2col_rows"]))},
        rows=conv_rows + norm_rows, ldpc_rows=ldpc_rows, link=link_res,
        pools=pools,
        conv_probe=probe,
        forward_rel_err_f32=fwd_err32,
        forward_rel_err_bf16=fwd_err16, estimation_seconds=est_s,
        estimation_forwards=nfe, estimation_best_nmse_db=
        res.best_nmse_db().ravel().tolist(), bench_counts=bench_counts,
        bench_levels=levels, graph=graph,
        profile_wall_ms=wall_ms, profile_busy_ms=busy, profile_top=top,
        profile_ms_per_forward=path_ms, train=train, eval=evals,
        **later,
        total_seconds=time.perf_counter() - t_start), indent=1))
    print(f"# total {time.perf_counter() - t_start:.1f} s; details in "
          f"chiprun_out/chip_smoke.json")
    print(json.dumps({"kernels": kernel_json}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
