"""The port's CUDA kernels and main path on the card, against their plain
PyTorch versions. Skipped without a card; on the card, run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py sets up JAX, which the card's machine
need not have; this file imports no JAX).
"""

import contextlib
import ctypes
import dataclasses
import gc
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import numpy as np

from score_based_channels_torch import _graph, cplx, physics
from score_based_channels_torch.comms.ldpc import make_wifi_ldpc, minsum_decode
from score_based_channels_torch.config import ModelConfig
from score_based_channels_torch.diffusion import sampling
from score_based_channels_torch.diffusion.sampling import (
    PosteriorRunner, annealed_langevin_posterior_c2,
)
from score_based_channels_torch.diffusion.sigmas import get_sigmas
from score_based_channels_torch.eval.estimate import (
    derive_seed, langevin_chunked, score_fn_from_params,
)
from score_based_channels_torch.kernels import (
    conv, conv_chain, conv_im2col, counts, grad_counts, instance_norm,
    ldpc_minsum, reset_counts,
)
from score_based_channels_torch.kernels.fused_forward import fused_forward
from score_based_channels_torch.models import make_score_model
from score_based_channels_torch.utils import spans

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("H,W,Cin,Cout,k,d,bias,elu,B", [
    (64, 16, 32, 32, 3, 1, True, False, 32),
    (8, 2, 128, 128, 3, 4, True, False, 32),
    (16, 4, 64, 64, 3, 1, False, True, 32),
    (64, 16, 32, 64, 1, 1, True, False, 32),
    (64, 16, 32, 2, 3, 1, True, False, 32),  # the end conv: N = 8 tile
    (8, 2, 64, 128, 3, 2, True, False, 32),
    (64, 16, 2, 32, 3, 1, True, True, 32),   # the begin conv: K padded to 16
    (8, 2, 64, 64, 3, 2, True, True, 3),     # ragged batch: 3 of 4 samples
    (16, 4, 32, 32, 3, 4, False, False, 3),  # dilation 4, 3 live taps
    (12, 5, 24, 40, 3, 1, True, True, 3),    # 60 of a 64-pixel tile
    (16, 4, 3, 5, 3, 1, True, True, 5),      # odd channels: plain loads
    (8, 2, 128, 128, 3, 1, True, True, 256)])  # 2 chunks, 18 stages
def test_conv_kernel_matches_plain(card, H, W, Cin, Cout, k, d, bias, elu, B,
                                   dtype, tol):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, Cin, H, W, generator=g).to(card, dtype).contiguous(
        memory_format=torch.channels_last)
    w = conv.kernel_layout((torch.randn(Cout, Cin, k, k, generator=g)
                            / (k * k * Cin) ** 0.5).to(card, dtype))
    b = torch.randn(Cout, generator=g).to(card, dtype) if bias else None
    got = conv.conv2d(x, w, b, d, elu)
    want = conv.conv2d_plain(x, w, b, d, elu)
    assert got.is_contiguous(memory_format=torch.channels_last)
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err <= tol


# -- the f32 route's plans --------------------------------------------------


def _f32_forced(B, H, W, Cin, Cout, k, d, forced):
    """The shape's f32 plan with `forced` fields replaced (BM through
    conv.f32_config, which derives the threads and the tile) and the
    derived chunk count, tiles and shared bytes made to match."""
    taps = conv.live_taps(k, d, H, W)
    dy, dx = [t[2] for t in taps], [t[3] for t in taps]
    p = conv.plan(B, H, W, Cin, Cout, dy, dx)
    if "BM" in forced:
        p = conv.f32_config(B, H, W, Cin, Cout, dy, dx, p.BN, forced["BM"],
                            p.BK)
    p = dataclasses.replace(p, **{k: v for k, v in forced.items()
                                  if k != "BM"})
    return dataclasses.replace(
        p, nchunks=-(-Cin // p.BK),
        tiles=(-(-H // p.TH), -(-B // p.SB), -(-Cout // p.BN)),
        smem=conv.f32_smem(p.SB, p.TH + 2 * p.py, W + 2 * p.px, len(taps),
                           p.BM, p.BN, p.BK, p.stages))


def _f32_case(card, B, H, W, Cin, Cout, k, bias, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, Cin, H, W, generator=g).to(card).contiguous(
        memory_format=torch.channels_last)
    w = conv.kernel_layout((torch.randn(Cout, Cin, k, k, generator=g)
                            / (k * k * Cin) ** 0.5).to(card))
    b = torch.randn(Cout, generator=g).to(card) if bias else None
    return x, w, b


@pytest.mark.parametrize("B,H,W,Cin,Cout,k,d,bias,elu,forced", [
    # each cluster size at the training batch's 8x2 c128 layer
    (32, 8, 2, 128, 128, 3, 1, True, True, dict(CL=1)),
    (32, 8, 2, 128, 128, 3, 1, True, False, dict(CL=2)),
    (32, 8, 2, 128, 128, 3, 1, False, True, dict(CL=4)),
    (32, 8, 2, 128, 128, 3, 1, True, False, dict(CL=8)),
    (256, 8, 2, 128, 128, 3, 4, True, False, dict(CL=2)),
    (32, 64, 16, 32, 2, 3, 1, True, False, dict(CL=2)),  # end conv, BN 4
    # 4-byte copies: Cin 2 (the begin conv), even and odd counts
    (5, 64, 16, 2, 32, 3, 1, True, True, dict(stages=2)),
    (5, 64, 16, 2, 32, 3, 1, True, True, dict(BM=64, stages=4)),
    (3, 16, 4, 3, 5, 3, 1, True, True, dict(stages=4)),
    (4, 8, 2, 6, 12, 3, 1, False, True, {}),
    (3, 12, 5, 24, 40, 3, 1, True, True, dict(CL=2)),  # a partial tile
    # ragged last tiles: rows, a sample group, a tile larger than its pixels
    (5, 16, 4, 16, 32, 3, 1, True, False, dict(BM=32, TH=6)),
    (5, 8, 2, 16, 32, 3, 2, True, True, dict(BM=64, SB=3)),
    (2, 8, 2, 16, 8, 3, 1, False, False, dict(BM=128)),
    # every chunk size, and a ring of four
    (32, 32, 8, 16, 16, 3, 1, True, False, dict(BK=4, CL=4)),
    (32, 16, 4, 64, 64, 1, 1, True, False, dict(BK=16, CL=4, stages=4)),
])
def test_f32_conv_takes_every_forced_plan(card, B, H, W, Cin, Cout, k, d, bias,
                                          elu, forced):
    """f32 plans the main path does not take, through _launch with a
    replaced plan, within 1e-5 of max|plain|."""
    p = _f32_forced(B, H, W, Cin, Cout, k, d, forced)
    x, w, b = _f32_case(card, B, H, W, Cin, Cout, k, bias)
    got = conv._launch(x, w, b, d, elu, p)
    want = conv.conv2d_plain(x, w, b, d, elu)
    torch.cuda.synchronize()
    err = (got - want).abs().max() / want.abs().max()
    assert err <= 1e-5, (float(err), p)


@pytest.mark.parametrize("B,H,W,Cin,Cout,k,d,forced", [
    (32, 8, 2, 128, 128, 3, 1, {}), (32, 8, 2, 128, 128, 3, 1, dict(CL=2)),
    (256, 8, 2, 64, 64, 3, 2, dict(CL=4)), (32, 64, 16, 32, 32, 3, 1, {}),
    (256, 64, 16, 32, 64, 3, 1, dict(CL=1))])
def test_f32_conv_launches_give_equal_bits(card, B, H, W, Cin, Cout, k, d,
                                           forced):
    """No atomics: two launches of a plan, split over a cluster or not,
    give the same bits (the distributed phase compares runs bit for bit)."""
    x, w, b = _f32_case(card, B, H, W, Cin, Cout, k, True, seed=4)
    p = _f32_forced(B, H, W, Cin, Cout, k, d, forced)
    first = conv._launch(x, w, b, d, True, p)
    assert torch.equal(first, conv._launch(x, w, b, d, True, p))


def test_f32_conv_refuses_a_plan_it_cannot_take(card):
    """A cluster size, a chunk split or a 16-byte copy that the kernel or
    the pointers cannot take raises; nothing falls back."""
    x, w, b = _f32_case(card, 32, 8, 2, 128, 128, 3, True)
    p = conv._launch_args(32, 8, 2, 128, 128, 3, 1)[0]
    for bad in (dict(CL=16), dict(CL=3), dict(threads=p.threads + 32),
                dict(smem=p.smem - 16)):
        with pytest.raises(RuntimeError, match="conv2d_taps"):
            conv._launch(x, w, b, 1, False, dataclasses.replace(p, **bad))
    xs = torch.randn(32 * 8 * 2 * 128 + 1, device=card)[1:].view(
        32, 8, 2, 128).permute(0, 3, 1, 2)  # 4-byte aligned, not 16
    assert xs.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(RuntimeError, match="misaligned"):
        conv._launch(xs, w, b, 1, False, p)


NORM_SHAPES = [(64, 16, 32), (32, 8, 64), (16, 4, 64), (8, 2, 64),
               (8, 2, 128)]  # the five of one NCSNv2-Deepest forward


def _norm_inputs(card, B, C, H, W, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(B, C, H, W, generator=g) * 2 + 0.5).to(
        card, dtype).contiguous(memory_format=torch.channels_last)
    a, gm, bt = (1 + 0.1 * torch.randn(3, C, generator=g)).to(card, dtype)
    return x, a, gm, bt


def _norm_close(got, want, dtype):
    """chip_smoke's bars: f32 rtol 2e-4 / atol 2e-5, bf16 2e-2 of
    max|plain|."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
    else:
        err = (got.float() - want.float()).abs().max()
        assert err <= 2e-2 * want.float().abs().max(), float(err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("elu", [False, True])
@pytest.mark.parametrize("B", [32, 257])  # 257: 1 past a whole wave
@pytest.mark.parametrize("H,W,C", NORM_SHAPES)
def test_norm_kernel_matches_plain(card, H, W, C, B, elu, dtype):
    x, a, gm, bt = _norm_inputs(card, B, C, H, W, dtype)
    reset_counts()
    got = instance_norm.instance_norm_plus(x, a, gm, bt, elu=elu)
    want = instance_norm.instance_norm_plus_plain(x, a, gm, bt, elu=elu)
    assert counts()["instance_norm_plus"] == {"launches": 1, "plain": 1}
    assert got.is_contiguous(memory_format=torch.channels_last)
    _norm_close(got, want, dtype)


@pytest.mark.parametrize("H,W,C,B,dtype,route,forced", [
    (64, 16, 32, 3, torch.bfloat16, ("bulk", 1), dict(chunks=1)),
    (64, 16, 32, 3, torch.float32, ("bulk", 1), dict(chunks=3)),  # ragged
    (48, 16, 32, 5, torch.float32, ("bulk", 1), {}),  # an empty 4th chunk
    (40, 30, 8, 3, torch.bfloat16, ("bulk", 1), {}),  # past the registers
    (64, 16, 64, 5, torch.float32, ("bulk", 2), {}),  # a sample, 2 blocks
    (64, 16, 128, 3, torch.float32, ("bulk", 4), {}),
    (128, 32, 64, 2, torch.float32, ("bulk", 8), {}),
    (100, 100, 12, 3, torch.bfloat16, ("bulk", 2), {}),  # C = 12, 2 halves
    (99, 101, 12, 2, torch.bfloat16, ("element", 2), {}),  # ragged halves
    (8, 2, 12, 7, torch.float32, ("bulk", 1), {}),  # a channel a thread
    (5, 3, 3, 6, torch.float32, ("element", 1), {}),  # 180 B a sample
    (64, 16, 2, 5, torch.bfloat16, ("bulk", 1), {}),  # C = 2
    (12, 10, 24, 3, torch.float32, ("vector", 1), {})])  # 3 ragged rows
def test_norm_kernel_takes_every_plan(card, H, W, C, B, dtype, route, forced):
    """Routes the main path does not reach: clusters for samples too
    large for one block, element copies, one channel a thread, ragged and
    other chunk counts (a plan with its chunks replaced)."""
    p = dataclasses.replace(instance_norm.plan(B, H, W, C, dtype), **forced)
    assert (p.copy, p.cluster) == route
    x, a, gm, bt = _norm_inputs(card, B, C, H, W, dtype, seed=2)
    for elu in (False, True):
        got = instance_norm._launch(x, a, gm, bt, elu, p)
        _norm_close(got, instance_norm.instance_norm_plus_plain(
            x, a, gm, bt, elu), dtype)


def test_norm_elu_near_zero_matches_expm1(card):
    """f32 ELU is expm1f, as F.elu. Each channel holds +-k * 2^-20, k = 1
    .. 512, so every sum of its mean is exact (mean 0 in both versions) and
    the normalized values run from 3e-4 to 0.15: near 0, where exp(y) - 1
    loses its relative accuracy, the kernel stays within 1e-5 of the plain
    version relative to the value."""
    B, C, H, W = 4, 32, 64, 16
    g = torch.Generator().manual_seed(8)
    k = torch.cat([torch.arange(1, 513), -torch.arange(1, 513)]).float()
    x = torch.stack([k[torch.randperm(H * W, generator=g)]
                     for _ in range(B * C)]) * 2.0 ** -20
    x = x.view(B, C, H, W).to(card).contiguous(
        memory_format=torch.channels_last)
    zero, one = torch.zeros(C, device=card), torch.ones(C, device=card)
    got = instance_norm.instance_norm_plus(x, zero, one, zero, elu=True)
    want = instance_norm.instance_norm_plus_plain(x, zero, one, zero, elu=True)
    near = want.abs() < 1e-2
    assert near.sum() > 1000
    rel = ((got - want).abs() / want.abs())[near]
    assert rel.max() <= 1e-5, float(rel.max())


@pytest.mark.parametrize("H,W,form", [(64, 16, "bulk"), (8, 2, "vector")])
def test_norm_refuses_a_bulk_copy_it_cannot_take(card, H, W, form):
    """A channels-last x 2 bytes off a 16-byte boundary: the plan says bulk
    copies (or 16-byte loads), the pointer cannot take them, and the launch
    raises (no element copy instead)."""
    B, C = 2, 32
    buf = torch.randn(B * H * W * C + 1, device=card).to(torch.bfloat16)
    x = buf[1:].view(B, H, W, C).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    assert instance_norm.plan(B, H, W, C, x.dtype).copy == form
    ones = torch.ones(C, device=card, dtype=x.dtype)
    with pytest.raises(RuntimeError, match="misaligned"):
        instance_norm.instance_norm_plus(x, ones, ones, ones)


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    x = torch.randn(2, 8, 8, 2, device=card)  # NCHW contiguous, not NHWC
    w = conv.kernel_layout(torch.randn(4, 8, 3, 3, device=card))
    with pytest.raises(ValueError, match="channels-last"):
        conv.conv2d(x, w)
    xl = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="kernel_layout"):
        conv.conv2d(xl, w.contiguous())
    with pytest.raises(TypeError):
        conv.conv2d(xl.half().contiguous(memory_format=torch.channels_last),
                    w.half())
    with pytest.raises(TypeError):
        conv.conv2d(xl.bfloat16().contiguous(memory_format=torch.channels_last),
                    w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_see_parameters_changed_in_place(card, dtype):
    """The kernels read the parameters themselves (the bf16 kernel through
    tensor maps made at each launch): an update through .data (the
    optimizer / EMA idiom) shows in the next launch."""
    model = make_score_model(ModelConfig(ngf=8), device=card).to(dtype)
    cpu = make_score_model(ModelConfig(ngf=8), device="cpu")
    x = torch.randn(4, 64, 16, 2)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        model(x.to(card, dtype), 0.7)
        for (name, p), q in zip(model.named_parameters(), cpu.parameters()):
            new = (q + 0.05 * torch.randn(q.shape, generator=g)).to(dtype)
            q.data.copy_(new)
            p.data.copy_(new.to(card))
        got = model(x.to(card, dtype), 0.7).float().cpu()
        want = cpu(x.to(dtype).float(), 0.7)
    if dtype == torch.float32:
        assert (got - want).abs().max() / want.abs().max() < 2e-4
    else:
        assert torch.linalg.norm(got - want) / torch.linalg.norm(want) < 5e-2


def test_bf16_model_forward_matches_the_cpu(card):
    """An ngf = 8 network in bf16 on the card (every conv on the wgmma
    kernel) against the plain f32 forward on the CPU, within 5% (the bar of
    tests/test_bf16.py)."""
    model = make_score_model(ModelConfig(ngf=8), device="cpu")
    score = score_fn_from_params(model.to(card), torch.bfloat16)
    x = torch.randn(6, 64, 16, 2)
    sig = torch.tensor([0.3, 0.7, 1.0, 2.0, 5.0, 20.0])
    reset_counts()
    got = score(x.to(card), sig.to(card)).cpu()
    assert counts()["conv2d_taps"] == {"launches": 113, "plain": 0}
    with torch.no_grad():
        want = model.cpu()(x, sig)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert torch.linalg.norm(got - want) / torch.linalg.norm(want) < 5e-2


@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
def test_conv_kernels_take_an_f32_or_bf16_bias(card, bias_dtype):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(8, 32, 16, 4, generator=g).to(card, torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    w = conv.kernel_layout((torch.randn(48, 32, 3, 3, generator=g) / 17).to(
        card, torch.bfloat16))
    b = torch.randn(48, generator=g).to(card, bias_dtype)
    want = conv.conv2d_plain(x, w, b, 1, True)
    _close_to_plain(conv.conv2d(x, w, b, 1, True), want, torch.bfloat16)
    _close_to_plain(conv_im2col.conv2d_im2col(x, w, b, 1, True), want,
                    torch.bfloat16)


def _last_launch():
    """(blocks along the tile axis, tiles, channel tiles, SMs, blocks per SM
    of the kernel asked afresh) of the last bf16 conv launch."""
    from score_based_channels_torch.kernels import _build

    out = (ctypes.c_int * 5)()
    _build.check("sbc_conv_last_launch",
                 _build.library().sbc_conv_last_launch(out))
    return tuple(out)


@pytest.mark.parametrize("entry", ["conv2d_taps", "conv_im2col"])
def test_persistent_grid_follows_each_kernels_occupancy(card, entry):
    """Launches of more (kernel, threads, shared bytes) combinations than a
    small fixed cache would hold, in several orders: each grid is the one a
    fresh occupancy query of its own kernel gives, over the plan's tiles."""
    g = torch.Generator().manual_seed(6)
    shapes = [(H, W, Cin, Cout, d, B)
              for Cin, Cout in ((2, 32), (32, 2), (16, 16), (32, 64),
                                (64, 64), (64, 128), (128, 128), (128, 32))
              for H, W, d, B in ((8, 2, 1, 5), (16, 4, 2, 3), (64, 16, 1, 2))]
    shapes += shapes[::-3]  # revisit some once the cache holds them all
    for H, W, Cin, Cout, d, B in shapes:
        x = torch.randn(B, Cin, H, W, generator=g).to(
            card, torch.bfloat16).contiguous(memory_format=torch.channels_last)
        w = conv.kernel_layout((torch.randn(Cout, Cin, 3, 3, generator=g)
                                / (9 * Cin) ** 0.5).to(card, torch.bfloat16))
        if entry == "conv2d_taps":
            got = conv.conv2d(x, w, None, d, True)
            p = conv._launch_args(B, H, W, Cin, Cout, 3, d, True)[0]
            tiles, ct = p.tiles[0] * p.tiles[1], p.tiles[2]
        else:
            got = conv_im2col.conv2d_im2col(x, w, None, d, True)
            T = len(conv.live_taps(3, d, H, W))
            tiles, ct = conv_im2col.plan(B, H, W, Cin, Cout, T,
                                         torch.bfloat16).grid
        blocks, c_tiles, c_ct, sms, per_sm = _last_launch()
        assert (c_tiles, c_ct) == (tiles, ct)
        assert blocks == min(tiles, -(-sms * per_sm // ct)), (
            (H, W, Cin, Cout, d, B), blocks, tiles, ct, sms, per_sm)
        _close_to_plain(got, conv.conv2d_plain(x, w, None, d, True),
                        torch.bfloat16)


def test_forward_and_sampler_on_the_card(card):
    model = make_score_model(ModelConfig(ngf=8), device=card)
    cpu = make_score_model(ModelConfig(ngf=8), device="cpu")
    x = torch.randn(4, 64, 16, 2)
    reset_counts()
    with torch.no_grad():
        got = model(x.to(card), 0.7).cpu()
        want = cpu(x, 0.7)
    assert counts()["conv2d_taps"]["launches"] == 113
    assert counts()["instance_norm_plus"]["launches"] == 25
    assert (got - want).abs().max() / want.abs().max() < 2e-4
    A = torch.randn(4, 38, 64, 2, device=card) * 0.7
    X = torch.randn(4, 64, 16, 2, device=card) * 0.7
    Y = torch.zeros(4, 38, 16, 2, device=card)
    xf, tr = annealed_langevin_posterior_c2(
        score_fn_from_params(model, torch.bfloat16), A, Y,
        get_sigmas(39.15, 1.0, 4), 0.64, torch.zeros_like(X),
        generator=torch.Generator(device=card).manual_seed(0), oracle=X)
    assert xf.shape == X.shape and tr.shape == (12, 4)
    assert torch.isfinite(tr).all()


def _ldpc_inputs(B, card, seed=0):
    code = make_wifi_ldpc()
    rng = np.random.default_rng(seed)
    cw = code.encode(rng.integers(0, 2, (B, code.k), np.uint8))
    llr = torch.from_numpy((1 - 2 * cw.astype(np.float32)) * 2.0 + 1.5
                           * rng.standard_normal(cw.shape).astype(np.float32))
    return code, llr.to(card), torch.as_tensor(code.H, dtype=torch.float32,
                                               device=card)


@pytest.mark.parametrize("start", ["zeros", "random"])
@pytest.mark.parametrize("B", [1, 3, 5, 100, 256, 257])
def test_ldpc_kernel_matches_plain_bitexact(card, B, start):
    """Both add each column in ascending row order: equal after every
    iteration (torch.equal, under which -0.0 equals +0.0)."""
    code, llr, mask = _ldpc_inputs(B, card)
    t = ldpc_minsum.edge_tables(mask)
    g = torch.Generator().manual_seed(B)
    ck = cp = (torch.zeros(B, code.m, code.n, device=card) if start == "zeros"
               else torch.randn(B, code.m, code.n, generator=g).to(card)
               * 3.0 * mask)
    reset_counts()
    for _ in range(25):
        ck = ldpc_minsum.bp_iteration(ck, llr, mask, 0.75, t)
        cp = ldpc_minsum.bp_iteration_plain(cp, llr, mask, 0.75, t)
        torch.cuda.synchronize()
        assert torch.equal(ck, cp)
    assert counts()["ldpc_minsum"] == {"launches": 25, "plain": 25}
    assert torch.equal(ldpc_minsum.column_sums(ck, t),
                       ldpc_minsum.column_sums(cp, t))
    assert (ck[:, mask == 0] == 0).all()


@pytest.mark.parametrize("copy,R", [("bulk", None), ("bulk", 7),
                                    ("element", None)])
def test_ldpc_store_forms_match_plain_bitexact(card, copy, R):
    """Both band store forms and a ragged last band (324 rows in bands of
    7; a plan with its band replaced), 3 iterations from random
    messages."""
    code, llr, mask = _ldpc_inputs(37, card, seed=2)
    t = ldpc_minsum.edge_tables(mask)
    E, dr = t.num_edges, t.max_row_degree
    p = ldpc_minsum.plan(37, t.m, t.n, E, dr)
    R = R or p.rows_per_band
    p = dataclasses.replace(p, copy=copy, rows_per_band=R,
                            lanes_per_row=ldpc_minsum._lanes(dr, R),
                            smem=ldpc_minsum.smem_bytes(t.m, t.n, E, R))
    g = torch.Generator().manual_seed(5)
    ck = cp = torch.randn(37, code.m, code.n, generator=g).to(card) * mask
    for _ in range(3):
        ck = ldpc_minsum._launch(ck, llr, t, 0.75, p)
        cp = ldpc_minsum.bp_iteration_plain(cp, llr, mask, 0.75, t)
        assert torch.equal(ck, cp)


def test_ldpc_refuses_a_bulk_copy_it_cannot_take(card):
    """Packed tables 4 bytes off a 16-byte boundary: their one bulk copy
    cannot take them, and the launch raises (no element copy instead)."""
    code, llr, mask = _ldpc_inputs(2, card)
    t = ldpc_minsum.edge_tables(mask)
    buf = torch.zeros(t.packed.numel() + 1, dtype=torch.int32, device=card)
    buf[1:] = t.packed
    odd = dataclasses.replace(t, packed=buf[1:])
    c2v = torch.zeros(2, code.m, code.n, device=card)
    with pytest.raises(RuntimeError, match="misaligned"):
        ldpc_minsum.bp_iteration(c2v, llr, mask, 0.75, odd)


def test_ldpc_kernel_takes_any_code(card):
    """A random mask with rows of 1 to 40 edges, n not a multiple of 4
    (element stores), bit for bit against the plain version."""
    rng = np.random.default_rng(7)
    m, n = 37, 103
    H = np.zeros((m, n), np.float32)
    for i in range(m):
        H[i, rng.choice(n, size=1 + i % 40, replace=False)] = 1
    mask = torch.from_numpy(H).to(card)
    t = ldpc_minsum.edge_tables(mask)
    assert ldpc_minsum.plan(4, m, n, t.num_edges, 40).copy == "element"
    llr = torch.from_numpy(rng.standard_normal((4, n)).astype(np.float32)
                           ).to(card)
    ck = cp = torch.from_numpy(rng.standard_normal((4, m, n)).astype(
        np.float32)).to(card) * mask
    for _ in range(3):
        ck = ldpc_minsum.bp_iteration(ck, llr, mask, 0.75, t)
        cp = ldpc_minsum.bp_iteration_plain(cp, llr, mask, 0.75, t)
        assert torch.equal(ck, cp)


def test_minsum_decode_on_the_card_matches_the_cpu(card):
    code, llr, _ = _ldpc_inputs(64, card, seed=1)
    reset_counts()
    bits, post = minsum_decode(llr, code.H, num_iters=25)
    assert counts()["ldpc_minsum"] == {"launches": 25, "plain": 0}
    cbits, cpost = minsum_decode(llr.cpu(), code.H, num_iters=25)
    assert torch.equal(bits.cpu(), cbits)
    torch.testing.assert_close(post.cpu(), cpost, rtol=0, atol=1e-5)


def test_ldpc_wrapper_refuses_what_the_kernel_does_not_take(card):
    code, llr, mask = _ldpc_inputs(2, card)
    c2v = torch.zeros(2, code.m, code.n, device=card)
    with pytest.raises(TypeError):
        ldpc_minsum.bp_iteration(c2v.double(), llr.double(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        ldpc_minsum.bp_iteration(c2v.transpose(1, 2).contiguous()
                                 .transpose(1, 2), llr, mask)
    with pytest.raises(ValueError, match="one device"):
        ldpc_minsum.bp_iteration(c2v, llr, mask,
                                 tables=ldpc_minsum.edge_tables(code.H))
    with pytest.raises(ValueError):
        ldpc_minsum.bp_iteration(c2v[:, :10], llr, mask)


def _close_to_plain(got, want, dtype):
    """f32 within 1e-5 of max|plain|, bf16 within 2e-2 (chip_smoke TOL)."""
    err = (got.float() - want.float()).abs().max()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert err <= tol * want.float().abs().max(), float(err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,Cin,Cout,k,d,bias,act,B", [
    (64, 16, 32, 32, 3, 1, True, False, 16),
    (8, 2, 128, 128, 3, 4, True, True, 16),
    (16, 4, 8, 16, 3, 2, False, True, 16),
    (64, 16, 32, 64, 1, 1, True, False, 16),
    (64, 16, 32, 2, 3, 1, True, False, 16),   # the end conv: N = 8 tile
    (64, 16, 2, 32, 3, 1, True, True, 16),    # the begin conv: one K = 18 stage
    (8, 2, 64, 128, 3, 2, False, False, 16),
    (5, 3, 16, 24, 3, 1, True, True, 16),
    (8, 2, 64, 64, 3, 4, True, True, 3),      # ragged batch, dilation 4
    (16, 4, 3, 5, 3, 1, True, True, 3),       # odd channels: plain loads
    (8, 2, 128, 128, 3, 1, True, True, 256)])  # 18 stages through the ring
def test_im2col_kernel_matches_plain(card, H, W, Cin, Cout, k, d, bias, act,
                                     B, dtype):
    """The (S, B, C) entry point, with an f32 bias as the harness passes
    it, and the channels-last entry point with a bias in x's dtype."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(H * W, B, Cin, generator=g).to(card, dtype)
    w = (torch.randn(k, k, Cin, Cout, generator=g)
         / (k * k * Cin) ** 0.5).to(card, dtype)
    b = torch.randn(Cout, generator=g).to(card) if bias else None
    reset_counts()
    got = conv_im2col.conv_im2col(x, w, b, H, W, d, act)
    want = conv_im2col.conv_im2col_plain(x, w, b, H, W, d, act)
    assert got.shape == (H * W, B, Cout) and got.dtype == dtype
    _close_to_plain(got, want, dtype)
    xc = torch.randn(B, Cin, H, W, generator=g).to(card, dtype).contiguous(
        memory_format=torch.channels_last)
    weight = w.permute(3, 2, 0, 1)
    bx = b.to(dtype) if bias else None
    got = conv_im2col.conv2d_im2col(xc, weight, bx, d, act)
    assert got.is_contiguous(memory_format=torch.channels_last)
    _close_to_plain(got, conv.conv2d(xc, weight, bx, d, act), dtype)
    assert counts()["conv_im2col"] == {"launches": 2, "plain": 1}


def _chain_inputs(card, H, W, C, B, n, dtype):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(H * W, B, C, generator=g).to(card, dtype)
    ws = (torch.randn(n, 3, 3, C, C, generator=g) / (9 * C) ** 0.5).to(
        card, dtype)
    bs = (0.1 * torch.randn(n, C, generator=g)).to(card)
    return x, ws, bs


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,C,B,n,d", [(8, 2, 128, 256, 4, 1),
                                         (8, 2, 128, 40, 2, 2),
                                         (8, 2, 16, 8, 3, 1),
                                         (8, 2, 64, 300, 2, 1),
                                         (4, 4, 24, 5, 2, 1)])
def test_chain_kernel_matches_plain(card, H, W, C, B, n, d, dtype, cluster):
    """The wrapper's own plan, and on the tensor-core route the plan with
    its cluster replaced (B = 300 and 5 pad the grid to whole clusters)."""
    x, ws, bs = _chain_inputs(card, H, W, C, B, n, dtype)
    p = conv_chain.plan(B, H, W, C, dtype)
    if p.route == conv_chain.MMA:
        p = dataclasses.replace(p, cluster=cluster)
    reset_counts()
    got = conv_chain.conv_chain(x, ws, bs, H, W, d)
    forced = conv_chain._launch(x, ws, bs, H, W, d, p)
    want = conv_chain.conv_chain_plain(x, ws, bs, H, W, d)
    assert counts()["conv_chain"] == {"launches": 2, "plain": 1}
    for y in (got, forced):
        assert y.dtype == dtype and y.shape == x.shape
        if dtype == torch.float32:
            torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-5)
        else:
            err = (y.float() - want.float()).abs().max()
            assert err <= 2e-2 * want.float().abs().max(), float(err)


@pytest.mark.parametrize("cluster", [3, 16])
def test_chain_cluster_the_card_cannot_launch_raises(card, cluster):
    """A cluster that does not divide the channels (3) or passes the
    portable size (16) is refused: the wrapper raises and launches
    nothing else in its place."""
    x, ws, bs = _chain_inputs(card, 8, 2, 128, 256, 2, torch.bfloat16)
    p = dataclasses.replace(conv_chain.plan(256, 8, 2, 128, torch.bfloat16),
                            cluster=cluster)
    reset_counts()
    with pytest.raises(RuntimeError, match="conv_chain: CUDA error"):
        conv_chain._launch(x, ws, bs, 8, 2, 1, p)
    assert counts()["conv_chain"] == {"launches": 0, "plain": 0}
    torch.cuda.synchronize()  # nothing was left running or faulted


def test_new_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = torch.randn(16, 2, 8, device=card)
    with pytest.raises(ValueError, match="kernel_layout"):
        conv_im2col.conv2d_im2col(
            x.view(8, 2, 2, 8).permute(2, 3, 0, 1),
            torch.randn(4, 8, 3, 3, device=card))
    with pytest.raises(TypeError):
        conv_im2col.conv_im2col(x.double(), torch.randn(
            3, 3, 8, 4, device=card, dtype=torch.float64), None, 8, 2)
    with pytest.raises(ValueError, match="channels"):
        conv_chain.conv_chain(torch.randn(16, 2, 160, device=card),
                              torch.randn(1, 3, 3, 160, 160, device=card),
                              torch.zeros(1, 160, device=card), 8, 2)
    with pytest.raises(ValueError):
        conv_chain.conv_chain(x, torch.randn(2, 3, 3, 8, 4, device=card),
                              torch.zeros(2, 8, device=card), 8, 2)


def test_fused_forward_on_the_card_matches_the_module(card):
    model = make_score_model(ModelConfig(ngf=8), device=card)
    x = torch.randn(4, 64, 16, 2, device=card)
    sig = torch.tensor([0.5, 1.0, 2.0, 4.0], device=card)
    with torch.no_grad():
        want = model(x, sig)
        reset_counts()
        got = fused_forward(model.state_dict(), x, sig)
        n = counts()
        # the converter's plain (O, I, k, k) weights are laid out first
        flat = {k: v.contiguous() for k, v in model.state_dict().items()}
        again = fused_forward(flat, x, sig)
    assert n["conv2d_taps"] == {"launches": 113, "plain": 0}
    assert n["instance_norm_plus"] == {"launches": 25, "plain": 0}
    assert torch.equal(got, want) and torch.equal(again, want)


# -- gradients (score training) ------------------------------------------------

# every conv variant of one NCSNv2-Deepest forward at ngf = 32:
# (H, W, Cin, Cout, k, dilation, bias, elu)
TRAIN_CONVS = [
    (8, 2, 64, 64, 3, 1, False, False), (8, 2, 64, 64, 3, 1, False, True),
    (8, 2, 64, 64, 3, 1, True, False), (8, 2, 64, 64, 3, 2, True, False),
    (8, 2, 64, 128, 3, 2, True, False), (8, 2, 128, 64, 3, 1, True, False),
    (8, 2, 128, 128, 3, 1, False, False), (8, 2, 128, 128, 3, 1, False, True),
    (8, 2, 128, 128, 3, 2, True, False), (8, 2, 128, 128, 3, 4, True, False),
    (16, 4, 64, 32, 3, 1, True, False), (16, 4, 64, 64, 1, 1, True, False),
    (16, 4, 64, 64, 3, 1, False, False), (16, 4, 64, 64, 3, 1, False, True),
    (16, 4, 64, 64, 3, 1, True, False), (32, 8, 32, 32, 3, 1, False, False),
    (32, 8, 32, 32, 3, 1, False, True), (32, 8, 32, 32, 3, 1, True, False),
    (32, 8, 64, 32, 3, 1, True, False), (32, 8, 64, 64, 1, 1, True, False),
    (32, 8, 64, 64, 3, 1, False, False), (32, 8, 64, 64, 3, 1, False, True),
    (32, 8, 64, 64, 3, 1, True, False), (64, 16, 2, 32, 3, 1, True, False),
    (64, 16, 32, 2, 3, 1, True, False), (64, 16, 32, 32, 3, 1, False, False),
    (64, 16, 32, 32, 3, 1, False, True), (64, 16, 32, 32, 3, 1, True, False),
    (64, 16, 32, 64, 1, 1, True, False), (64, 16, 32, 64, 3, 1, True, False)]


@pytest.mark.parametrize("H,W,Cin,Cout,k,d,bias,elu", TRAIN_CONVS)
def test_conv_gradients_match_cudnn_autograd(card, H, W, Cin, Cout, k, d,
                                             bias, elu):
    """The conv Function's dgrad (the kernel on the transposed weight),
    wgrad and bias grad against autograd through F.conv2d (TF32 off), f32,
    batch 32, within 1e-5 of max|ref| each; the begin conv's input takes no
    gradient, so its dgrad is skipped."""
    g = torch.Generator().manual_seed(9)
    x0 = torch.randn(32, Cin, H, W, generator=g).to(card).contiguous(
        memory_format=torch.channels_last)
    w0 = conv.kernel_layout((torch.randn(Cout, Cin, k, k, generator=g)
                             / (k * k * Cin) ** 0.5).to(card))
    b0 = torch.randn(Cout, generator=g).to(card) if bias else None
    gout = torch.randn(32, Cout, H, W, generator=g).to(card)  # NCHW strides
    for x_grad in (True, False):
        leaves = [x0.clone().requires_grad_(x_grad), w0.clone().requires_grad_()]
        if bias:
            leaves.append(b0.clone().requires_grad_())
        ref = [t.detach().clone().requires_grad_(t.requires_grad)
               for t in leaves]
        reset_counts()
        out = conv.conv2d(*leaves[:2], leaves[2] if bias else None, d, elu)
        want = conv.conv2d_plain(*ref[:2], ref[2] if bias else None, d, elu)
        # autograd may hand the backward a gradient in any strides
        out.backward(gout)
        want.backward(gout)
        n = grad_counts()["conv2d_taps"]
        assert n == {"functions": 1, "dgrad": int(x_grad)}, n
        assert counts()["conv2d_taps"] == {"launches": 1 + int(x_grad),
                                           "plain": 1}
        for a, b in zip(leaves, ref):
            if not b.requires_grad:
                assert a.grad is None
                continue
            err = (a.grad - b.grad).abs().max() / b.grad.abs().max()
            assert err <= 1e-5, (float(err), tuple(a.shape))
        assert conv.has_kernel_layout(leaves[1].grad)


@pytest.mark.parametrize("elu", [False, True])
@pytest.mark.parametrize("H,W,C", NORM_SHAPES)
def test_norm_gradients_match_plain_autograd(card, H, W, C, elu):
    """The norm Function (kernel forward, closed-form backward) against
    autograd through the plain version, f32, rtol 2e-4 / atol 2e-5."""
    x, a, gm, bt = _norm_inputs(card, 32, C, H, W, torch.float32, seed=3)
    leaves = [t.clone().requires_grad_() for t in (x, a, gm, bt)]
    ref = [t.clone().requires_grad_() for t in (x, a, gm, bt)]
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(4)).to(
        card)
    reset_counts()
    instance_norm.instance_norm_plus(*leaves, elu=elu).backward(g)
    instance_norm.instance_norm_plus_plain(*ref, elu=elu).backward(g)
    assert grad_counts()["instance_norm_plus"] == {"functions": 1,
                                                   "backward": 1}
    assert counts()["instance_norm_plus"] == {"launches": 1, "plain": 1}
    for p, q in zip(leaves, ref):
        torch.testing.assert_close(p.grad, q.grad, rtol=2e-4, atol=2e-5)


def test_no_autograd_function_under_no_grad(card):
    """The sampler's path (no_grad) and a forward on parameters that take
    no gradient launch directly; with grad, every conv and norm of a
    forward builds its Function and a backward runs 112 dgrads (not the
    begin conv's) and 25 norm backwards."""
    model = make_score_model(ModelConfig(ngf=8), device=card)
    x = torch.randn(4, 64, 16, 2, device=card)
    reset_counts()
    with torch.no_grad():
        model(x, 0.7)
    score_fn_from_params(model, torch.bfloat16)(x, 0.7)
    frozen = make_score_model(ModelConfig(ngf=8), device=card).requires_grad_(
        False)
    frozen(x, 0.7)
    assert grad_counts() == {"conv2d_taps": {"functions": 0, "dgrad": 0},
                             "instance_norm_plus": {"functions": 0,
                                                    "backward": 0}}
    assert counts()["conv2d_taps"]["launches"] == 3 * 113
    reset_counts()
    model(x, 0.7).square().sum().backward()
    assert grad_counts() == {"conv2d_taps": {"functions": 113, "dgrad": 112},
                             "instance_norm_plus": {"functions": 25,
                                                    "backward": 25}}
    assert counts()["conv2d_taps"] == {"launches": 113 + 112, "plain": 0}
    assert counts()["instance_norm_plus"] == {"launches": 25, "plain": 0}


def test_train_step_gradients_match_the_cpu(card):
    """One DSM step's gradient at ngf = 8 on the card against the plain
    step on the CPU (same parameters, batch, labels and noise), within
    1e-3 of each tensor's max|g|; then an optimizer and EMA step."""
    from score_based_channels_torch.config import Config
    from score_based_channels_torch.diffusion.dsm import anneal_dsm_loss
    from score_based_channels_torch.diffusion.sigmas import sigmas_from_config
    from score_based_channels_torch.train import ScoreTrainer

    cfg = Config(model=ModelConfig(ngf=8, num_classes=50))
    g = torch.Generator().manual_seed(5)
    x = torch.randn(8, 64, 16, 2, generator=g)
    labels = torch.randint(0, 50, (8,), generator=g)
    noise = torch.randn(x.shape, generator=g)
    sig = sigmas_from_config(cfg.model)
    cpu = make_score_model(cfg.model, device="cpu")
    anneal_dsm_loss(cpu, x, sig, labels=labels, noise=noise).backward()
    trainer = ScoreTrainer(cfg, device=card)
    state = trainer.init_state(0)
    state.model.load_state_dict(cpu.state_dict())
    state.ema.load_state_dict(cpu.state_dict())
    loss = anneal_dsm_loss(state.model, x.to(card), sig.to(card),
                           labels=labels.to(card), noise=noise.to(card))
    loss.backward()
    for (name, p), q in zip(state.model.named_parameters(), cpu.parameters()):
        err = (p.grad.cpu() - q.grad).abs().max() / q.grad.abs().max()
        assert err <= 1e-3, (name, float(err))
    reset_counts()
    # a batch in other strides (as a data set's view may come) is taken
    x_t = x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3).to(card)
    assert not x_t.is_contiguous()
    trainer.train_step(state, x_t, torch.Generator(card).manual_seed(1))
    assert state.step == 1 and torch.isfinite(torch.stack(
        [p.abs().max() for p in state.model.parameters()])).all()
    assert any((p - e).abs().max() > 0 for p, e in
               zip(state.model.parameters(), state.ema.parameters()))
    assert counts()["conv2d_taps"]["plain"] == 0
    assert all(conv.has_kernel_layout(m.weight) for m in state.model.modules()
               if hasattr(m, "dilation") and hasattr(m, "weight"))


# -- the comparison side: baselines and the tuner on the card -----------------

# noise powers 0.5 (the CPU parity test's, tests/test_torch_baselines.py)
# to 6.4: the regularized LS block's condition number stays below ~200, so
# f32 round-off in two summation orders stays below 1e-4 of max|h|
NOISE = torch.linspace(0.5, 6.4, 6)


def _baseline_inputs(B=6, Np=38, seed=7):
    from score_based_channels_torch import cplx, physics

    g = torch.Generator().manual_seed(seed)
    A = cplx.conj_transpose(cplx.qpsk_pilots(g, B, 64, Np))
    X = cplx.randn(g, (B, 64, 16))
    Y = physics.measure_c2(g, A, X, NOISE)
    return A, X, Y


def test_ls_estimate_on_the_card_matches_the_cpu(card):
    from score_based_channels_torch.baselines.ls import ls_estimate

    A, X, Y = _baseline_inputs()
    npow = NOISE
    want = ls_estimate(A, Y, npow)
    got = ls_estimate(A.to(card), Y.to(card), npow.to(card))
    assert got.device.type == "cuda"
    assert (got.cpu() - want).abs().max() <= 1e-4 * want.abs().max()
    with pytest.raises(torch.linalg.LinAlgError):
        ls_estimate(A.to(card), Y.to(card), -100.0)
    # at noise 0.064 (20 dB without the Nt factor, as `ls` runs it) against
    # float64 normal equations, at the JAX package's bar
    # (tests/test_baselines.py:24-42)
    from score_based_channels_torch import cplx

    got = cplx.to_complex(ls_estimate(A.to(card), Y.to(card), 0.064))
    Ac = cplx.to_complex(A).astype(np.complex128)
    Yc = cplx.to_complex(Y).astype(np.complex128)
    for b in range(A.shape[0]):
        G = Ac[b].conj().T @ Ac[b] + 0.064 * np.eye(64)
        want = np.linalg.solve(G, Ac[b].conj().T @ Yc[b])
        np.testing.assert_allclose(got[b], want, rtol=2e-2, atol=2e-3)


def test_fista_on_the_card_matches_the_cpu(card):
    from score_based_channels_torch import cplx
    from score_based_channels_torch.baselines.lasso import (
        fista_l1_lifted, lifted_fourier_dicts,
    )

    A, X, Y = _baseline_inputs()
    L2, R2 = (cplx.from_complex(d) for d in lifted_fourier_dicts(64, 16, 4))
    want, wtr = fista_l1_lifted(A, Y, L2, R2, 0.3, 3e-3, num_iters=50,
                                oracle2=X)
    got, gtr = fista_l1_lifted(*(t.to(card) for t in (A, Y, L2, R2)), 0.3,
                               3e-3, num_iters=50, oracle2=X.to(card))
    assert (got.cpu() - want).abs().max() <= 1e-4 * want.abs().max()
    assert torch.allclose(gtr.cpu(), wtr, rtol=1e-4)


def test_em_bg_amp_on_the_card_matches_the_cpu(card):
    from score_based_channels_torch import cplx
    from score_based_channels_torch.baselines.amp import em_bg_amp
    from score_based_channels_torch.baselines.lasso import lifted_fourier_dicts

    A, X, Y = _baseline_inputs()
    L2, R2 = (cplx.from_complex(d) for d in lifted_fourier_dicts(64, 16, 4))
    want, wtr = em_bg_amp(A, Y, L2, R2, num_iters=20, oracle2=X)
    got, gtr = em_bg_amp(*(t.to(card) for t in (A, Y, L2, R2)),
                         num_iters=20, oracle2=X.to(card))
    db = 10 * torch.log10(gtr[-1].cpu() / wtr[-1]).abs()
    assert db.max() <= 0.01, db
    assert (got.cpu() - want).abs().max() <= 1e-3 * X.abs().max()


def test_hparam_search_on_the_card_runs_the_kernels(card):
    """The tuner on a tiny network: every forward launches 113 convs and
    25 norms, no plain call, and the selection is the argmin of its log.
    The forwards are the posterior runner's: its graph runs the score
    function in Python only for the eager level 0 and the capture."""
    from score_based_channels_torch.config import Config, DataConfig
    from score_based_channels_torch.eval.tune import run_hparam_search

    cfg = Config(model=ModelConfig(ngf=8, num_classes=4, sigma_rate=0.3),
                 data=DataConfig(num_channels=8))
    model = make_score_model(cfg.model, device=card,
                             generator=torch.Generator().manual_seed(2))
    calls = [0]
    score = score_fn_from_params(model)

    def counted(x, s):
        calls[0] += 1
        return score(x, s)

    reset_counts()
    sampling.reset_stats()
    res = run_hparam_search(counted, cfg, snr_range=np.array([0.0, 20.0]),
                            alpha_step_range=(1e-5, 1e-4),
                            beta_noise_range=(0.01, 0.001), num_channels=3,
                            chunk_size=16, device=card)
    nfe = sampling.STATS["forwards"]
    assert nfe == 2 * 4 * 3  # two chunks (24 rows), 4 levels x 3 steps
    assert calls[0] == 2 * 3  # level 0 and the capture; the rest replayed
    assert counts()["conv2d_taps"] == {"launches": 113 * nfe, "plain": 0}
    assert counts()["instance_norm_plus"] == {"launches": 25 * nfe,
                                              "plain": 0}
    assert np.isfinite(res.nmse_log).all()
    s = int(np.argmin(res.avg_nmse.reshape(-1, 2, 12)[:, 1].min(-1)))
    assert res.best_alpha_snr[1] == (1e-5, 1e-5, 1e-4, 1e-4)[s]


# the conv and norm shapes of NCSNv2Deeper and NCSNv2 (ngf 32) that an
# NCSNv2-Deepest forward lacks (tests/test_torch_archs.py counts them)
OTHER_ARCH_CONVS = [
    (16, 4, 64, 64, 3, 2, True, False), (16, 4, 64, 128, 3, 2, True, False),
    (16, 4, 128, 64, 3, 1, True, False), (16, 4, 128, 128, 3, 1, False, False),
    (16, 4, 128, 128, 3, 1, False, True), (16, 4, 128, 128, 3, 2, True, False),
    (16, 4, 128, 128, 3, 4, True, False),  # Deeper's res5: 3 live taps
    (32, 8, 64, 64, 3, 2, True, False), (32, 8, 64, 64, 3, 4, True, False)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B", [256, 3])
@pytest.mark.parametrize("H,W,Cin,Cout,k,d,bias,elu", OTHER_ARCH_CONVS)
def test_other_arch_convs_match_plain(card, H, W, Cin, Cout, k, d, bias, elu,
                                      B, dtype, tol):
    test_conv_kernel_matches_plain(card, H, W, Cin, Cout, k, d, bias, elu, B,
                                   dtype, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("elu", [False, True])
@pytest.mark.parametrize("B", [32, 257])
def test_deeper_norm_shape_matches_plain(card, B, elu, dtype):
    """NCSNv2Deeper's 16x4 c128 stage, the one norm shape Deepest lacks."""
    test_norm_kernel_matches_plain(card, 16, 4, 128, B, elu, dtype)


@pytest.mark.parametrize("H,W,Cin,Cout,k,d,bias,elu", OTHER_ARCH_CONVS)
def test_other_arch_conv_gradients_match_cudnn_autograd(card, H, W, Cin, Cout,
                                                        k, d, bias, elu):
    test_conv_gradients_match_cudnn_autograd(card, H, W, Cin, Cout, k, d,
                                             bias, elu)


# the convs of one LDAMP denoiser (FlippedNormUnet, chans 16, 3 pools)
UNET_CONVS = [
    (64, 16, 2, 16, 3, 1, False, False), (64, 16, 16, 16, 3, 1, False, False),
    (32, 8, 16, 32, 3, 1, False, False), (32, 8, 32, 32, 3, 1, False, False),
    (16, 4, 32, 64, 3, 1, False, False), (16, 4, 64, 64, 3, 1, False, False),
    (8, 2, 64, 128, 3, 1, False, False), (8, 2, 128, 128, 3, 1, False, False),
    (16, 4, 128, 64, 3, 1, False, False), (32, 8, 64, 32, 3, 1, False, False),
    (64, 16, 32, 16, 3, 1, False, False), (64, 16, 16, 2, 1, 1, True, False)]


@pytest.mark.parametrize("B", [128, 4])
@pytest.mark.parametrize("H,W,Cin,Cout,k,d,bias,elu", UNET_CONVS)
def test_unet_convs_match_plain(card, H, W, Cin, Cout, k, d, bias, elu, B):
    test_conv_kernel_matches_plain(card, H, W, Cin, Cout, k, d, bias, elu, B,
                                   torch.float32, 1e-5)


@pytest.mark.parametrize("H,W,Cin,Cout,k,d,bias,elu", UNET_CONVS)
def test_unet_conv_gradients_match_cudnn_autograd(card, H, W, Cin, Cout, k, d,
                                                  bias, elu):
    """The Unet's forward and dgrad in f32 (the 2->16 conv's dgrad too:
    inside LDAMP its input takes a gradient from the second unroll on)."""
    test_conv_gradients_match_cudnn_autograd(card, H, W, Cin, Cout, k, d,
                                             bias, elu)


@pytest.mark.parametrize("arch,convs,norms", [("ncsnv2", 75, 17),
                                              ("ncsnv2_deeper", 94, 21)])
def test_other_archs_forward_on_the_card_match_the_cpu(card, arch, convs,
                                                       norms):
    cfg = ModelConfig(arch=arch)
    model = make_score_model(cfg, device=card,
                             generator=torch.Generator().manual_seed(4))
    cpu = make_score_model(cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    g = torch.Generator().manual_seed(5)
    x = torch.randn(4, 64, 16, 2, generator=g)
    sig = torch.rand(4, generator=g) + 0.1
    with torch.no_grad():
        want = cpu(x, sig)
        reset_counts()
        got = model(x.to(card), sig.to(card)).cpu()
    assert counts()["conv2d_taps"] == {"launches": convs, "plain": 0}
    assert counts()["instance_norm_plus"] == {"launches": norms, "plain": 0}
    assert (got - want).abs().max() <= 2e-4 * want.abs().max()


def test_ldamp_gradient_on_the_card_matches_the_cpu(card):
    """A small LDAMP (2 unrolls, chans 16, 3 pools) at batch 4 with the
    same directions: loss and every parameter's gradient within 1e-3 of
    its max|g| (the train phase's bar), the dgrads on the kernel."""
    from score_based_channels_torch.models.ldamp import LDAMP

    g = torch.Generator().manual_seed(6)
    Y = torch.randn(4, 38, 16, 2, generator=g)
    P = torch.sign(torch.randn(4, 38, 64, 2, generator=g)) * 0.5 ** 0.5
    eig = torch.full((4,), 100.0)
    dirs = [torch.randn(4, 64, 16, 2, generator=g) for _ in range(2)]
    H = torch.randn(4, 64, 16, 2, generator=g)
    grads = {}
    for dev in (card, "cpu"):
        m = LDAMP(max_unrolls=2)
        m.init_parameters(torch.Generator().manual_seed(7))
        m.to(dev)
        reset_counts()
        h = m(Y.to(dev), P.to(dev), eig.to(dev), directions=dirs)
        ((h - H.to(dev)) ** 2).sum().backward()
        grads[str(dev)] = [p.grad.cpu() for p in m.parameters()]
        if dev != "cpu":
            assert grad_counts()["conv2d_taps"] == {"functions": 30,
                                                    "dgrad": 29}
            assert counts()["conv2d_taps"] == {"launches": 89, "plain": 0}
    for a, b in zip(grads[str(card)], grads["cpu"]):
        assert (a - b).abs().max() <= 1e-3 * b.abs().max()


@pytest.mark.parametrize("act,norm,norms", [("relu", "InstanceNorm++", 25),
                                            ("elu", "VarianceNorm", 1)])
def test_variant_forward_on_the_card_matches_the_cpu(card, act, norm, norms):
    """A config-chosen activation or norm: the convs (and the IN++ norms)
    still launch the kernels, with ELU off where the activation is not
    ELU; the forward matches the CPU's at the full-width bar."""
    cfg = ModelConfig(nonlinearity=act, normalization=norm)
    model = make_score_model(cfg, device=card,
                             generator=torch.Generator().manual_seed(8))
    cpu = make_score_model(cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    g = torch.Generator().manual_seed(9)
    x = torch.randn(4, 64, 16, 2, generator=g)
    sig = torch.rand(4, generator=g) + 0.1
    with torch.no_grad():
        want = cpu(x, sig)
        reset_counts()
        got = model(x.to(card), sig.to(card)).cpu()
    assert counts()["conv2d_taps"] == {"launches": 113, "plain": 0}
    assert counts()["instance_norm_plus"] == {"launches": norms, "plain": 0}
    assert (got - want).abs().max() <= 2e-4 * want.abs().max()


def test_nccl_world_size_one_dsm_step_equals_no_group(card, tmp_path):
    """parallel/mp_smoke's train steps, checkpoint round trip and sweep
    chunk on NCCL at world size 1 (tcp://127.0.0.1) equal the same run with
    no process group, to 1e-6 (tests/test_torch_train.py's bar). Both take
    deterministic algorithms: by default two runs differ by themselves
    (the resize's backward and cuDNN's weight gradient accumulate in no
    fixed order)."""
    import socket

    import torch.distributed as dist

    from score_based_channels_torch.models.convert import tree_leaves
    from score_based_channels_torch.parallel import multihost
    from score_based_channels_torch.parallel.mp_smoke import run_smoke

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    kw = dict(device=card, ngf=8, num_classes=16, batch=8, steps=2)
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        assert multihost.initialize(f"127.0.0.1:{port}", 1, 0,
                                    device=card) == "nccl"
        try:
            reset_counts()
            dp = run_smoke(ckpt_path=str(tmp_path / "dp.npz"), **kw)
            c = counts()
        finally:
            dist.destroy_process_group()
        one = run_smoke(ckpt_path=str(tmp_path / "one.npz"), **kw)
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
    assert (dp["world"], one["world"]) == (1, 1)
    assert c["conv2d_taps"]["launches"] > 0 and c["conv2d_taps"]["plain"] == 0
    assert c["instance_norm_plus"]["plain"] == 0
    np.testing.assert_allclose(dp["losses"], one["losses"], rtol=1e-6)
    for name in ("params", "ema"):
        for a, b in zip(tree_leaves(dp[name]), tree_leaves(one[name])):
            assert np.linalg.norm(a - b) <= 1e-6 * np.linalg.norm(b)
    assert np.isfinite(dp["trace"]).all()
    assert np.abs(dp["trace"] - one["trace"]).max() <= \
        1e-6 * np.abs(one["trace"]).max()


# -- the posterior runner: one captured level, replayed ------------------------


def _posterior_case(card, dtype, B=8, levels=5):
    """A small network (ngf 8) in `dtype` and B rows of the bench's inputs
    (38 pilots, 10 dB) on the card."""
    g = torch.Generator().manual_seed(4)
    mcfg = ModelConfig(ngf=8)
    model = make_score_model(mcfg, device=card, generator=g)
    A = cplx.conj_transpose(cplx.qpsk_pilots(g, B, 64, 38))
    X = cplx.randn(g, (B, 64, 16))
    npow = float(physics.snr_to_noise_power(10.0, 64))
    Y = physics.measure_c2(g, A, X, npow)
    x0 = cplx.randn(g, (B, 64, 16))
    sig = get_sigmas(mcfg.sigma_begin, mcfg.sigma_end, levels)
    return (score_fn_from_params(model, dtype), A.to(card), Y.to(card),
            X.to(card), x0.to(card), npow, sig)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_graph_equals_plain_loop_bitwise_over_two_chunks(card, dtype):
    """langevin_chunked (one capture, replayed for every level of both
    chunks) against a runner per chunk run eagerly (`_graph.eager()`), at
    beta 0.01: the same bits, and launches of 113 convs and 25 norms a
    forward."""
    B, chunk, levels, steps, seed = 8, 4, 5, 2, 3
    score, A, Y, X, x0, npow, sig = _posterior_case(card, dtype, B, levels)
    cap = torch.arange(B) % levels
    reset_counts()
    sampling.reset_stats()
    _graph.reset_stats()
    xg, tg = langevin_chunked(score, A, Y, sig, npow, x0, seed, 3e-11, 0.01,
                              steps_each=steps, oracle2=X, chunk_size=chunk,
                              capture_level=cap, device=card)
    n, st, gst = counts(), dict(sampling.STATS), dict(_graph.STATS)
    assert st["forwards"] == steps * levels * (B // chunk)
    assert (gst["captures"], gst["replays"]) == (1, levels * 2 - 1)
    assert n["conv2d_taps"] == {"launches": 113 * st["forwards"], "plain": 0}
    assert n["instance_norm_plus"] == {"launches": 25 * st["forwards"],
                                       "plain": 0}
    xs, ts = [], []
    with _graph.eager():
        for start in range(0, B, chunk):
            rows = slice(start, start + chunk)
            xf, tr = PosteriorRunner(
                score, sig, torch.Generator(device=card).manual_seed(
                    derive_seed(seed, start)), steps_each=steps).run(
                A[rows], Y[rows], npow, x0[rows], alpha_step=3e-11,
                beta_noise=0.01, oracle=X[rows],
                capture_level=cap[rows].to(card))
            xs.append(cplx.to_complex(xf))
            ts.append(tr.cpu().numpy())
    assert _graph.STATS["captures"] == 1
    np.testing.assert_array_equal(xg, np.concatenate(xs))
    np.testing.assert_array_equal(tg, np.concatenate(ts, axis=1))


def test_graph_replays_draw_new_noise(card):
    """With a zero score, zero operator and unit noise scale, every row
    keeps draw row 0 and latches after level 0, 1, 2: the differences are
    the draws of the eager level 0 and of replays 1 and 2. A second run,
    re-seeded, replays all three levels and gives the same bits."""
    n = 3
    runner = PosteriorRunner(
        lambda x, s: torch.zeros_like(x), torch.ones(3),
        torch.Generator(device=card).manual_seed(1), steps_each=1,
        noise_rows=(4, torch.zeros(n, dtype=torch.int64, device=card)))
    args = (torch.zeros(n, 38, 64, 2, device=card),
            torch.zeros(n, 38, 16, 2, device=card), 1.0,
            torch.zeros(n, 64, 16, 2, device=card))
    kw = dict(alpha_step=0.5, beta_noise=1.0,
              capture_level=torch.arange(n, device=card))
    x, _ = runner.run(*args, **kw)
    x = x.clone()
    z = [x[0], x[1] - x[0], x[2] - x[1]]
    for zi in z:
        assert 0.6 < float(zi.std()) < 0.8  # unit complex power: 0.707
    assert float((z[1] - z[2]).abs().max()) > 0.5
    assert float((z[0] - z[1]).abs().max()) > 0.5
    runner.generator.manual_seed(1)
    again, _ = runner.run(*args, **kw)
    assert torch.equal(again, x)


def test_graph_launch_counts_are_captured_times_replays(card):
    levels, steps = 4, 2
    score, A, Y, X, x0, npow, sig = _posterior_case(card, torch.bfloat16,
                                                    levels=levels)
    runner = PosteriorRunner(score, sig,
                             torch.Generator(device=card).manual_seed(0),
                             steps_each=steps)
    reset_counts()
    _graph.reset_stats()
    runner.run(A, Y, npow, x0, oracle=X)
    rec = runner.replayer.cap.launches
    assert rec["conv2d_taps"] == 113 * steps
    assert rec["instance_norm_plus"] == 25 * steps
    assert _graph.STATS["replays"] == levels - 1
    for k in ("conv2d_taps", "instance_norm_plus"):  # eager level 0 + replays
        assert counts()[k]["launches"] == rec[k] * levels
    runner.run(A, Y, npow, x0, oracle=X)  # every level replayed
    assert _graph.STATS["replays"] == 2 * levels - 1
    assert _graph.STATS["captures"] == 1
    for k in ("conv2d_taps", "instance_norm_plus"):
        assert counts()[k]["launches"] == rec[k] * 2 * levels
        assert counts()[k]["plain"] == 0
    assert _graph.STATS["pool_bytes"] > 0


def test_capture_with_a_host_sync_raises(card):
    """A score function that reads a value on the host (.item()) runs in
    the eager level 0 but cannot be captured: the run raises, and nothing
    falls back to the eager loop. The card stays usable."""
    def syncing(x, s):
        return x * (float(s.item()) * 0.0)

    runner = PosteriorRunner(syncing, torch.ones(3),
                             torch.Generator(device=card).manual_seed(0),
                             steps_each=1)
    args = (torch.zeros(2, 38, 64, 2, device=card),
            torch.zeros(2, 38, 16, 2, device=card), 1.0,
            torch.ones(2, 64, 16, 2, device=card))
    with pytest.raises(RuntimeError):
        runner.run(*args)
    assert runner.replayer.cap is None
    ok, _ = PosteriorRunner(lambda x, s: torch.zeros_like(x), torch.ones(3),
                            torch.Generator(device=card).manual_seed(0),
                            steps_each=1).run(*args, beta_noise=0.0)
    assert torch.isfinite(ok).all()


# -- the program's spans on the profiler's clock ------------------------------


def _profiled(fn):
    """fn() and a synchronise under a CUDA profiler -> (the program's
    spans recorded meanwhile, the host's "sbc:" events, the host's graph
    launches and the device operations, each as (name, start, end) ns,
    and the time the synchronise returned). What puts time between the
    profiler's stamp and a span's other than the clock is kept out: a
    span "warm" opens and closes first in the same profile (a profile's
    first record_function enter and exit on a thread set up its state,
    50-800 us), and the garbage collector waits until the profile ends."""
    torch.cuda.synchronize()
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with spans.span("warm"):
                pass
            t0 = time.time_ns()
            fn()
            torch.cuda.synchronize()
            synced = time.time_ns()
    finally:
        gc.enable()
    got = spans.recorded(t0, synced)
    marks, launches, device = [], [], []
    for ev in prof.profiler.kineto_results.events():
        t = (ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not ev.is_user_annotation():
                device.append(t)
        elif t[0].startswith(spans.PREFIX) and t[1] >= t0:
            marks.append((t[0][len(spans.PREFIX):],) + t[1:])
        elif "cudaGraphLaunch" in t[0]:
            launches.append(t)
    return got, marks, launches, device, synced


def _near_their_events(got, marks):
    """Each span against its profiler event (the k-th span of a name
    against the k-th event): a clock that differed would move both of its
    stamps; a host delay between the profiler's stamp and the span's
    moves one (60-300 us, about one stamp in 300 on the card). So every
    span lies within 50 us of its event at one end and within 1 ms at
    both, and the stamps' median distance is under 20 us."""
    by = {}
    for name, s, e in sorted(marks, key=lambda t: t[1]):
        by.setdefault(name, []).append((s, e))
    assert {n: len(v) for n, v in by.items()} == {
        n: sum(1 for r in got if r.name == n) for n in {r.name for r in got}}
    seen, gaps = {}, []
    for r in sorted(got, key=lambda r: r.start_ns):
        k = seen.get(r.name, 0)
        seen[r.name] = k + 1
        s, e = by[r.name][k]
        near = sorted((abs(r.start_ns - s), abs(r.end_ns - e)))
        assert near[0] <= 50_000 and near[1] <= 1_000_000, (r, s, e)
        gaps += near
    assert sorted(gaps)[len(gaps) // 2] <= 20_000, sorted(gaps)


def test_posterior_runner_spans_share_the_profilers_clock(card):
    """A new bf16 runner under a CUDA profiler records a level span for
    each of its L levels, inside its run: the first holds the warm-up, the
    second the capture and a replay, each later one a replay; each span
    lies near its "sbc:" event (`_near_their_events`); the L-1 graph
    launches lie inside the replay spans, and the replays' device
    operations start after the first of them began and end before the
    profiler's last synchronise returned."""
    levels = 4
    score, A, Y, X, x0, npow, sig = _posterior_case(card, torch.bfloat16,
                                                    levels=levels)
    runner = PosteriorRunner(score, sig,
                             torch.Generator(device=card).manual_seed(0),
                             steps_each=2)
    got, marks, launches, device, synced = _profiled(
        lambda: runner.run(A, Y, npow, x0, oracle=X))
    names = [r.name for r in got]
    assert {n: names.count(n) for n in set(names)} == {
        "sampler.run": 1, "sampler.load": 1, "graph.warm_up": 1,
        "graph.capture": 1, "graph.replay": levels - 1,
        "sampler.level": levels}
    run, first = got[0], got[2]
    assert (run.name, first.name) == ("sampler.run", "sampler.level")
    assert run.parent is None
    level_of = [r.index for r in got if r.name == "sampler.level"]
    for r in got[1:]:
        assert run.start_ns <= r.start_ns <= r.end_ns <= run.end_ns
        if r.name in ("sampler.load", "sampler.level"):
            assert r.parent == run.index
        else:  # the replayer's spans nest in the levels
            assert r.parent in level_of, r
    warm, capture = (next(r for r in got if r.name == n)
                     for n in ("graph.warm_up", "graph.capture"))
    assert (warm.parent, capture.parent) == tuple(level_of[:2])
    _near_their_events(got, marks)

    replays = [r for r in got if r.name == "graph.replay"]
    assert len(replays) == levels - 1 == len(launches)
    assert [r.parent for r in replays] == level_of[1:]
    for (_, s, e), r in zip(sorted(launches, key=lambda t: t[1]), replays):
        assert r.start_ns <= s <= e <= r.end_ns
    after = [t for t in device if t[1] >= capture.end_ns]
    assert after, "no device operation after the capture"
    assert min(s for _, s, _ in after) >= replays[0].start_ns
    assert max(e for _, _, e in after) <= synced


def test_replayer_spans_warm_up_capture_and_replays(card):
    """A `Replayer` records its warm-up, its capture and each replay, one
    "sbc:" event each and near it, each replay's graph launch inside its
    span."""
    buf = torch.ones(1024, device=card)
    rep = _graph.Replayer(lambda: buf.mul_(1.5), card)
    _graph.reset_stats()
    got, marks, launches, _, _ = _profiled(
        lambda: [rep() for _ in range(5)])
    names = [r.name for r in got]
    assert names == ["graph.warm_up", "graph.capture"] + ["graph.replay"] * 4
    assert sorted(m[0] for m in marks) == sorted(names)
    assert len(launches) == 4 and _graph.STATS["replays"] == 4
    for (_, s, e), r in zip(sorted(launches, key=lambda t: t[1]), got[2:]):
        assert r.start_ns <= s <= e <= r.end_ns
    _near_their_events(got, marks)


# -- the training runner: one DSM step captured, replayed for every step -----

def _train_graph_config(**training):
    """ngf 8, 12 classes, 32 realizations at batch 8 (4 steps an epoch), 3
    epochs in chunks of 5: 12 steps over chunks 5, 5, 2 that cross the
    epoch boundaries."""
    from score_based_channels_torch.config import (
        Config, DataConfig, TrainingConfig,
    )

    return Config(model=ModelConfig(ngf=8, num_classes=12),
                  training=TrainingConfig(batch_size=8, n_epochs=3,
                                          log_every_steps=5, **training),
                  data=DataConfig(num_channels=32))


@pytest.fixture
def deterministic():
    """torch.use_deterministic_algorithms(True) for the test: two eager
    training runs on the card differ otherwise (ROADMAP §3)."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])


def test_train_graph_equals_the_eager_loop_bitwise(card, deterministic):
    """ScoreTrainer.train through the captured step against the same
    steps run eagerly: parameters, EMA, moments, count and every train
    and validation loss, bit for bit."""
    from score_based_channels_torch.train import ScoreTrainer

    runs = []
    for eager in (False, True):
        trainer = ScoreTrainer(_train_graph_config(), device=card)
        with _graph.eager() if eager else contextlib.nullcontext():
            runs.append(trainer.train(log_fn=lambda s: None))
    (a, la), (b, lb) = runs
    assert a.step == b.step == 12 and a.opt.count == b.opt.count == 12
    for m, n in ((a.model, b.model), (a.ema, b.ema)):
        for p, q in zip(m.parameters(), n.parameters()):
            assert torch.equal(p, q)
    for key in a.opt.moments:
        for p, q in zip(a.opt.moments[key], b.opt.moments[key]):
            assert torch.equal(p, q)
    assert int(a.opt.count_t) == 12
    np.testing.assert_array_equal(la["train_loss"], lb["train_loss"])
    np.testing.assert_array_equal(la["val_loss"], lb["val_loss"])


def test_train_graph_counts_its_launches_and_gradient_work(card):
    """One capture, step 0 eager, 11 replays: the launch and gradient
    counts are those of 12 eager steps (113 conv forwards, 112 dgrads and
    25 norms a step) and 3 validations, with no plain call."""
    from score_based_channels_torch.train import ScoreTrainer
    from score_based_channels_torch.train import score as train_score

    reset_counts()
    train_score.reset_stats()
    _graph.reset_stats()
    state, logs = ScoreTrainer(_train_graph_config(), device=card).train(
        log_fn=lambda s: None)
    st = dict(train_score.STATS, **_graph.STATS)
    assert (st["steps"], st["captures"], st["replays"]) == (12, 1, 11)
    assert st["pool_bytes"] > 0 and st["capture_seconds"] > 0
    steps, n_val = state.step, len(logs["val_loss"])
    assert (steps, n_val) == (12, 3)
    assert grad_counts() == {
        "conv2d_taps": {"functions": 113 * steps, "dgrad": 112 * steps},
        "instance_norm_plus": {"functions": 25 * steps,
                               "backward": 25 * steps}}
    assert counts()["conv2d_taps"] == {
        "launches": 225 * steps + 113 * n_val, "plain": 0}
    assert counts()["instance_norm_plus"] == {
        "launches": 25 * (steps + n_val), "plain": 0}
    assert np.isfinite(logs["train_loss"]).all()


def test_train_runner_refuses_inputs_that_change_between_runs(card):
    """A runner's graph serves one shape of inputs: a run with other
    shapes, or with draws where the first run had none, raises; the
    captured runner then still runs its own shape."""
    from score_based_channels_torch.train import ScoreTrainer, TrainChunkRunner

    trainer = ScoreTrainer(_train_graph_config(), device=card)
    state = trainer.init_state(0)
    x_all = torch.randn(16, 64, 16, 2, device=card)
    runner = TrainChunkRunner(trainer.update, state, x_all, 8, 3,
                              torch.Generator(device=card), 20)
    idx = torch.arange(16).view(2, 8)
    runner.run(idx, [1, 2])  # step 0 eager, the capture, step 1 replayed
    assert runner.replayer.cap is not None
    with pytest.raises(ValueError):
        runner.run(torch.zeros(2, 4, dtype=torch.int64), [1, 2])
    with pytest.raises(ValueError):
        runner.run(idx, [1, 2], labels=torch.zeros(2, 8, dtype=torch.int64),
                   noise=torch.zeros(2, 8, 64, 16, 2))
    losses = runner.run(idx, [1, 2])
    assert torch.isfinite(losses).all() and state.step == 4


def test_train_capture_with_a_host_sync_raises(card):
    """An update that reads a value on the host (.item()) runs eagerly
    at step 0 but cannot be captured: the run raises, nothing falls back
    to the eager loop, and the card stays usable."""
    from score_based_channels_torch.train import ScoreTrainer, TrainChunkRunner

    trainer = ScoreTrainer(_train_graph_config(), device=card)

    def syncing(state, x, generator=None, labels=None, noise=None):
        loss = trainer.update(state, x, generator, labels, noise)
        return loss * float(loss.item() > -1)

    state = trainer.init_state(0)
    x_all = torch.randn(16, 64, 16, 2, device=card)
    runner = TrainChunkRunner(syncing, state, x_all, 8, 3,
                              torch.Generator(device=card), 20)
    with pytest.raises(RuntimeError):
        runner.run(torch.arange(16).view(2, 8), [1, 2])
    assert runner.replayer.cap is None
    ok = TrainChunkRunner(trainer.update, trainer.init_state(1), x_all, 8, 3,
                          torch.Generator(device=card), 20)
    assert torch.isfinite(ok.run(torch.arange(16).view(2, 8), [1, 2])).all()


def _ldamp_tiny():
    """CDL-C at 8 realizations, LDAMP of 2 unrolls, 8 channels, 2 pools,
    batch 4: 2 steps an epoch, the rate x0.1 after the first epoch."""
    from score_based_channels_torch.config import Config, DataConfig
    from score_based_channels_torch.train.ldamp import LDAMPTrainConfig

    return (Config(data=DataConfig(num_channels=8)),
            LDAMPTrainConfig(max_unrolls=2, chans=8, num_pools=2,
                             batch_size=4, n_epochs=3, decay_epochs=1))


def _ldamp_runs(card, capture, steps=6):
    """(model, optimizer, (steps, 2) rows, runner, replays) of `steps`
    runner steps on the tiny LDAMP, one run an epoch of 2 steps, through
    the graph or (capture False) under `_graph.eager()`."""
    from score_based_channels_torch.data import ChannelDataset
    from score_based_channels_torch.train.ldamp import (
        LDAMPStepRunner, ldamp_batch, make_ldamp_model, make_ldamp_optimizer,
    )

    cfg, tc = _ldamp_tiny()
    ds = ChannelDataset(1234, dataclasses.replace(
        cfg.data, noise_std=2.5, num_pilots=38), norm="global")
    model = make_ldamp_model(tc, card)
    opt = make_ldamp_optimizer(model, tc, 2)
    runner = LDAMPStepRunner(model, opt, torch.Generator(device=card), 2,
                             steps)
    rows = []
    _graph.reset_stats()
    with contextlib.nullcontext() if capture else _graph.eager():
        for run in range(steps // 2):
            s = range(2 * run, 2 * run + 2)
            rows.append(runner.run(
                (ldamp_batch(ds, torch.Generator().manual_seed(i), 4, "cpu")
                 for i in s), [100 + i for i in s]).clone())
    return model, opt, torch.cat(rows), runner, _graph.STATS["replays"]


def test_ldamp_graph_equals_the_eager_loop_bitwise(card, deterministic):
    """6 steps over 3 epochs, across two drops of the rate: parameters,
    Adam moments, count and every (mse, nmse) row, bit for bit."""
    a, b = _ldamp_runs(card, True), _ldamp_runs(card, False)
    assert a[4] == 5 and b[4] == 0
    for p, q in zip(a[0].parameters(), b[0].parameters()):
        assert torch.equal(p, q)
    for key in ("mu", "nu"):
        for p, q in zip(a[1].moments[key], b[1].moments[key]):
            assert torch.equal(p, q)
    assert a[1].count == b[1].count == int(a[1].count_t) == 6
    assert torch.equal(a[2], b[2]) and torch.isfinite(a[2]).all()


def test_ldamp_graph_counts_what_the_eager_loop_launches(card):
    """train_ldamp_snr through the graph (step 0 eager, one capture, 5
    replays) counts the conv launches and gradient work of the same 6
    steps run eagerly, with no plain call."""
    from score_based_channels_torch.train.ldamp import train_ldamp_snr

    cfg, tc = _ldamp_tiny()
    seen = []
    for eager in (False, True):
        reset_counts()
        with _graph.eager() if eager else contextlib.nullcontext():
            _, logs = train_ldamp_snr(cfg, 10.0, tc, log_fn=lambda s: None,
                                      device=card)
        seen.append((counts(), grad_counts()))
        assert np.isfinite(logs["loss_log"]).all()
        assert len(logs["loss_log"]) == 6
    assert seen[0] == seen[1]
    fwd = 2 * 11  # unrolls x convs of a 2-pool U-Net apply
    assert seen[0][0]["conv2d_taps"] == {"launches": (3 * fwd - 1) * 6,
                                         "plain": 0}
    assert seen[0][1]["conv2d_taps"] == {"functions": fwd * 6,
                                         "dgrad": (fwd - 1) * 6}
    # each step assembles its drawn batch, eig1 by the kernel
    assert seen[0][0]["pilot_eigmax"] == {"launches": 6, "plain": 0}


def _qpsk_or_gaussian(B, Nt, Np, qpsk=True):
    g = torch.Generator().manual_seed(Np)
    if qpsk:
        return cplx.qpsk_pilots(g, B, Nt, Np)
    return torch.randn(B, Nt, Np, 2, generator=g)


@pytest.mark.parametrize("B,Nt,Np,qpsk", [
    (128, 64, 38, True),                      # LDAMP's recipe, alpha 0.6
    (128, 64, 12, True), (128, 64, 26, True),  # alpha 0.2, 0.4
    (128, 64, 51, True), (128, 64, 64, True),  # alpha 0.8, 1.0
    (5, 64, 33, False),                       # an odd number of columns
    (6, 16, 40, False)])                      # the rows: Np > Nt
def test_pilot_eigmax_matches_float64_eigvalsh(card, B, Nt, Np, qpsk):
    """lambda_max(P P^H) by the kernel against float64 eigvalsh: 1e-5
    relative, every sample's sweeps under the cap, one launch; the CPU
    tensor takes the plain version."""
    from score_based_channels_torch.kernels import eigmax

    P = _qpsk_or_gaussian(B, Nt, Np, qpsk)
    Pc = torch.view_as_complex(P).to(torch.complex128)
    want = torch.linalg.eigvalsh(Pc @ Pc.mH)[..., -1]
    reset_counts()
    got, sweeps = eigmax.pilot_eigmax(P.to(card))
    assert counts()["pilot_eigmax"] == {"launches": 1, "plain": 0}
    assert got.dtype == torch.float32 and sweeps.dtype == torch.int32
    err = ((got.cpu().double() - want).abs() / want).max().item()
    assert err <= 1e-5, err
    assert 1 <= sweeps.min().item() and sweeps.max().item() < \
        eigmax.max_sweeps()
    plain, none = eigmax.pilot_eigmax(P)
    assert none is None and counts()["pilot_eigmax"]["plain"] == 1
    assert ((plain.double() - want).abs() / want).max().item() <= 1e-5


def test_pilot_eigmax_refuses_what_the_kernel_does_not_take(card):
    from score_based_channels_torch.kernels import eigmax

    P = _qpsk_or_gaussian(2, 64, 38).to(card)
    with pytest.raises(TypeError):
        eigmax.pilot_eigmax(P.double())
    with pytest.raises(ValueError):
        eigmax.pilot_eigmax(P.transpose(1, 2))
    with pytest.raises(ValueError):
        eigmax.pilot_eigmax(P[..., 0])
    with pytest.raises(ValueError):  # past a block's shared memory
        eigmax.pilot_eigmax(_qpsk_or_gaussian(1, 129, 112).to(card))


def _leaf_gap(got, want):
    """The worst leaf's gap of norms over the larger of its norm and the
    median leaf's, over the leaves whose wanted gradient is not nought to
    rounding (the benchmark's `grad_gap` and `change_gap`). `got` and
    `want` are lists of (gradient, value) pairs: the leaves are chosen by
    the gradients, the gap taken of the values."""
    gnorms = [w[0].double().norm().item() for w in want]
    gmed = float(np.median(gnorms))
    keep = [i for i, n in enumerate(gnorms) if n >= 1e-3 * gmed]
    norms = {i: want[i][1].double().norm().item() for i in keep}
    med = float(np.median(list(norms.values())))
    return max(abs(got[i][1].double().norm().item() - norms[i])
               / max(norms[i], med) for i in keep)


def test_ldamp_runner_assembles_the_draws_in_its_graph(card, deterministic):
    """The captured runner fed the host's draws at the recipe (10
    unrolls, chans 16, 3 pools, batch 128, 64 x 38 pilots, CDL-C at 10 dB)
    from `train_ldamp_snr`'s initial parameters over 3 steps: bit for bit
    its eager loop, and within the LDAMP cell's limits of a runner fed
    batches the host assembled (eigvalsh, the product on the CPU): each
    step's losses 0.01 relative, the first gradient (Adam's first moment)
    0.008 and the parameters' change 0.04 of the worst leaf. The steps it
    assembled and the kernel's launches are both 3; the host batches'
    eig1 took the plain version."""
    from score_based_channels_torch.config import default_score_config
    from score_based_channels_torch.data import ChannelDataset
    from score_based_channels_torch.train.ldamp import (
        LDAMPStepRunner, LDAMPTrainConfig, ldamp_batch, ldamp_inputs,
        make_ldamp_model, make_ldamp_optimizer,
    )

    ds = ChannelDataset(1234, dataclasses.replace(
        default_score_config("CDL-C").data, noise_std=float(10 ** -0.5 * 8),
        num_pilots=38), norm="global")
    tc = LDAMPTrainConfig()

    def draws(s):
        return ldamp_batch(ds, torch.Generator().manual_seed(s), 128, "cpu")

    forms = {"graph": (draws, True), "eager": (draws, False),
             "host": (lambda s: ldamp_inputs(draws(s)), True)}
    weights = make_ldamp_model(tc, "cpu", torch.Generator().manual_seed(
        derive_seed(tc.seed, 0))).state_dict()
    got = {}
    for name, (batch, capture) in forms.items():
        model = make_ldamp_model(tc, card)
        model.load_state_dict(weights)
        opt = make_ldamp_optimizer(model, tc, 1)
        runner = LDAMPStepRunner(model, opt, torch.Generator(device=card),
                                 1, 3)
        reset_counts()
        _graph.reset_stats()
        rows, g1 = [], None
        with contextlib.nullcontext() if capture else _graph.eager():
            for s in range(3):
                rows.append(runner.run([batch(s)], [50 + s]).clone())
                if g1 is None:
                    g1 = [(mu / (1 - 0.9)).cpu() for mu in opt.moments["mu"]]
        change = [(p.detach().cpu() - weights[k])
                  for k, p in model.named_parameters()]
        got[name] = (torch.cat(rows).cpu(), list(zip(g1, g1)),
                     list(zip(g1, change)),
                     dict(runner.stats, replays=_graph.STATS["replays"]),
                     counts()["pilot_eigmax"])
    g, e, hb = got["graph"], got["eager"], got["host"]
    assert torch.equal(g[0], e[0]) and torch.isfinite(g[0]).all()
    assert all(torch.equal(a[1], b[1]) for a, b in zip(g[2], e[2]))
    assert ((g[0] - hb[0]).abs() / hb[0].abs()).max().item() <= 0.01
    assert _leaf_gap(g[1], hb[1]) <= 0.008
    assert _leaf_gap(g[2], hb[2]) <= 0.04
    assert (g[3]["assembled"], g[3]["replays"]) == (3, 2)
    assert e[3]["assembled"] == 3 and hb[3]["assembled"] == 0
    assert g[4] == e[4] == {"launches": 3, "plain": 0}
    assert hb[4] == {"launches": 0, "plain": 3}  # the host's assembly


def test_ldamp_capture_with_a_host_sync_raises(card, monkeypatch):
    """A step that reads a value on the host runs eagerly at step 0 but
    cannot be captured: the run raises, nothing falls back to the eager
    loop, and the card stays usable."""
    from score_based_channels_torch.train import ldamp

    losses = ldamp.ldamp_losses

    def syncing(*args, **kwargs):
        mse, nmse = losses(*args, **kwargs)
        return mse * float(mse.item() > -1), nmse

    monkeypatch.setattr(ldamp, "ldamp_losses", syncing)
    with pytest.raises(RuntimeError):
        _ldamp_runs(card, True, steps=2)
    monkeypatch.setattr(ldamp, "ldamp_losses", losses)
    assert torch.isfinite(_ldamp_runs(card, True, steps=2)[2]).all()


@pytest.mark.parametrize("name", ["fista", "amp"])
def test_baseline_graph_equals_the_plain_loop_bitwise(card, name):
    """The captured iteration, replayed, against the Python loop on the
    card: estimate and trace, bit for bit (B = 6, 64x16, lift 4)."""
    from score_based_channels_torch import cplx
    from score_based_channels_torch.baselines import amp, lasso

    A, X, Y = (t.to(card) for t in _baseline_inputs())
    L2, R2 = (cplx.from_complex(d).to(card)
              for d in lasso.lifted_fourier_dicts(64, 16, 4))
    if name == "fista":
        run = lambda f: f(A, Y, L2, R2, 0.3, 3e-3, num_iters=60, oracle2=X)
        got, want = run(lasso.fista_l1_lifted), run(
            lasso.fista_l1_lifted_plain)
    else:
        run = lambda f: f(A, Y, L2, R2, num_iters=30, oracle2=X)
        got, want = run(amp.em_gm_amp), run(amp.em_gm_amp_plain)
    assert got[0].device.type == "cuda"
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.isfinite(got[1]).all()


def test_run_steps_capture_with_a_host_sync_raises(card):
    """An iteration that reads a value on the host cannot be captured:
    run_steps raises after the eager first iteration."""
    from score_based_channels_torch import _graph

    x = torch.zeros(4, device=card)

    def step():
        x.add_(float(x.sum().item() > -1))

    with pytest.raises(RuntimeError):
        _graph.run_steps([step], 3, card)
    assert float(x.sum()) >= 4  # the first iteration ran
    # two steps in turn: 2 eager iterations, then the graphs alternate
    y = torch.zeros(4, device=card)
    caps = _graph.run_steps([lambda: y.add_(1), lambda: y.mul_(2)], 5, card)
    assert len(caps) == 2
    assert torch.equal(y, torch.full((4,), 7.0, device=card))  # +1 x2 +1 x2 +1


# -- the link's receiver and the other samplers' step as graphs --------------

def _link_case(card, seed, B=256, Nr=16, Nt=64, Ns=4):
    """y, Heff and the noise variance of one CSI mode at about 5 dB, as
    `simulate_packets` makes them, on the card."""
    g = torch.Generator(device=card).manual_seed(seed)
    Heff = cplx.matmul(cplx.randn(g, (B, Nr, Nt)),
                       cplx.randn(g, (B, Nt, Ns)) / 8.0)
    s = torch.sign(torch.randn(B, 81, Ns, 2, generator=g,
                               device=card)) * float(np.sqrt(0.5))
    nv = torch.tensor(0.16, device=card)
    y = cplx.matmul(s, cplx.transpose(Heff)) + torch.sqrt(2.0 * nv) * \
        cplx.randn(g, (B, 81, Nr))
    return y, Heff, nv


@pytest.mark.parametrize("detector", ["ml", "kbest", "zf-sic"])
def test_receiver_graph_equals_the_eager_receiver(card, detector):
    """One receiver through its graph (call 1 eager, then one capture and
    replays) against one run eagerly on the card (`_graph.eager()`), at
    256 packets: the same bits at every call; 25 `ldpc_minsum` launches a
    call, none plain."""
    from score_based_channels_torch.comms import link

    code = make_wifi_ldpc()
    graph = link.LinkReceiver(code, 256, 16, detector=detector, device=card)
    eager = link.LinkReceiver(code, 256, 16, detector=detector, device=card)
    reset_counts()
    _graph.reset_stats()
    for seed in range(4):
        y, H, nv = _link_case(card, seed)
        with _graph.eager():
            want = eager(y, H, nv)
        assert torch.equal(graph(y, H, nv), want)
        assert torch.equal(graph.decoder.post, eager.decoder.post)
    assert _graph.STATS["replays"] == 3 and eager.replayer.cap is None
    assert graph.replayer.cap.launches["ldpc_minsum"] == 25
    assert counts()["ldpc_minsum"] == {"launches": 2 * 4 * 25, "plain": 0}


def test_decoder_replays_equal_eager_decodes(card):
    """MinsumDecoder: call 1 eager, call 2 captured and replayed, calls 3
    and 4 replayed; each equals `minsum_decode` (25 launches a decode)."""
    from score_based_channels_torch.comms.ldpc import MinsumDecoder

    code = make_wifi_ldpc()
    dec = MinsumDecoder(code.H, 256, device=card)
    reset_counts()
    _graph.reset_stats()
    for seed in range(4):
        _, llr, _ = _ldpc_inputs(256, card, seed=seed)
        bits, post = dec(llr)
        want_bits, want_post = minsum_decode(llr, code.H, num_iters=25)
        assert torch.equal(bits, want_bits) and torch.equal(post, want_post)
    assert _graph.STATS["replays"] == 3
    assert dec.replayer.cap.launches == {"conv2d_taps": 0,
                                         "instance_norm_plus": 0,
                                         "ldpc_minsum": 25, "conv_im2col": 0,
                                         "conv_chain": 0, "pilot_eigmax": 0,
                                         "conv2d_taps.wide": 0,
                                         "instance_norm_plus.two_pass": 0,
                                         "max_pool_5x5": 0}
    assert counts()["ldpc_minsum"] == {"launches": 2 * 4 * 25, "plain": 0}


def test_link_sweep_through_the_graph_equals_the_eager_sweep(card):
    """`run_link_simulation` (one receiver, one capture, 2 x 3 - 2
    replays) against the same sweep with the receiver eager: equal BER
    and BLER, 25 launches a decode either way."""
    from score_based_channels_torch.comms import link

    g = np.random.default_rng(3)
    cn = lambda: (g.standard_normal((64, 16, 64)) + 1j * g.standard_normal(
        (64, 16, 64))) / np.sqrt(2)
    H = cn()
    H_est = H + 0.3 * cn()
    snrs = np.array([0.0, 5.0, 10.0])
    reset_counts()
    got = link.run_link_simulation(H, H_est, snr_range=snrs, device=card)
    assert counts()["ldpc_minsum"] == {"launches": 2 * 3 * 25, "plain": 0}

    with _graph.eager():
        want = link.run_link_simulation(H, H_est, snr_range=snrs,
                                        device=card)
    for key in ("ber_ideal", "ber_est", "bler_ideal", "bler_est"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))


@pytest.mark.parametrize("what", ["receiver", "sampler"])
def test_link_and_sampler_capture_with_a_host_sync_raises(card, what):
    """A step that reads a value on the host runs eagerly at its first
    call but cannot be captured: the second call raises, nothing falls
    back to the eager path, and the card stays usable."""
    from score_based_channels_torch.comms import link
    from score_based_channels_torch.diffusion import (
        annealed_langevin_unconditional,
    )

    if what == "receiver":
        rx = link.LinkReceiver(make_wifi_ldpc(), 8, 16, device=card)
        detect = rx.detect
        rx.detect = lambda y, H, nv: detect(y, H, nv) * float(nv.item() > 0)
        args = _link_case(card, 0, B=8)
        rx(*args)
        with pytest.raises(RuntimeError):
            rx(*args)
        assert rx.replayer.cap is None
    else:
        with pytest.raises(RuntimeError):
            annealed_langevin_unconditional(
                lambda x, s: x * (float(s.item()) * 0.0),
                torch.ones(2, 64, 16, 2, device=card), torch.ones(3),
                torch.Generator(device=card).manual_seed(0), n_steps_each=1)
    y = torch.ones(4, device=card)
    assert float((y + 1).sum()) == 8.0


@pytest.mark.parametrize("name", ["unconditional", "inpainting",
                                  "interpolation"])
def test_sampler_step_graph_equals_the_eager_loop(card, name):
    """Each sampler through its captured step (4 levels x 3 steps, 8
    chains, ngf 8, f32) against its eager loop fed the same generator's
    draws through noise_fn: the same bits, 113 conv and 25 norm launches
    a forward either way."""
    from score_based_channels_torch.diffusion import (
        annealed_langevin_inpainting, annealed_langevin_interpolation,
        annealed_langevin_unconditional,
    )

    g = torch.Generator().manual_seed(4)
    score = score_fn_from_params(make_score_model(ModelConfig(ngf=8),
                                                  device=card, generator=g))
    x0 = torch.randn(8, 64, 16, 2, generator=g).to(card)
    refer = torch.randn(8, 64, 16, 2, generator=g).to(card)
    mask = torch.zeros(1, 64, 16, 1, device=card)
    mask[:, :, :8] = 1.0
    sig = get_sigmas(39.15, 0.01, 4)
    runs = {
        "unconditional": (lambda **k: annealed_langevin_unconditional(
            score, x0, sig, n_steps_each=3, **k), [x0.shape], 1),
        "inpainting": (lambda **k: annealed_langevin_inpainting(
            score, x0, refer, mask, sig, n_steps_each=3, **k),
            [refer.shape, x0.shape], 0),
        "interpolation": (lambda **k: annealed_langevin_interpolation(
            score, x0[:2], sig, n_interpolations=4, n_steps_each=3, **k),
            [x0[:2].shape, x0[:2].shape], 0)}
    run, shapes, denoise = runs[name]
    reset_counts()
    got = run(generator=torch.Generator(device=card).manual_seed(5))
    n = counts()
    nfe = 4 * 3 + denoise
    assert n["conv2d_taps"] == {"launches": 113 * nfe, "plain": 0}
    assert n["instance_norm_plus"] == {"launches": 25 * nfe, "plain": 0}
    gen = torch.Generator(device=card).manual_seed(5)
    want = run(noise_fn=lambda lvl, i: tuple(
        torch.randn(s, generator=gen, device=card) for s in shapes))
    assert torch.isfinite(got).all() and torch.equal(got, want)


def test_zf_sic_solve_ex_equals_solve_on_the_card(card):
    """The ZF-SIC stages' regularised (2k, 2k) systems at 256 packets
    (k = 4, 3, 2, 1) against (2k, 81) columns: `solve_ex` without its
    check gives `solve`'s bits on the card too."""
    y, H, _ = _link_case(card, 5)
    for k in (4, 3, 2, 1):
        Hk = H[:, :, :k]
        Hh = cplx.conj_transpose(Hk)
        G = cplx.matmul(Hh, Hk)
        Gr = torch.cat([torch.cat([G[..., 0], -G[..., 1]], -1),
                        torch.cat([G[..., 1], G[..., 0]], -1)], -2)
        Gr = Gr + 1e-5 * torch.eye(2 * k, device=card)
        rhs = cplx.matmul(Hh, y.transpose(1, 2))
        rhs_r = torch.cat([rhs[..., 0], rhs[..., 1]], -2)
        sol, info = torch.linalg.solve_ex(Gr, rhs_r, check_errors=False)
        assert torch.equal(sol, torch.linalg.solve(Gr, rhs_r))
        assert not info.any()


def test_ldpc_refuses_an_out_buffer_it_cannot_write(card):
    code, llr, mask = _ldpc_inputs(2, card)
    t = ldpc_minsum.edge_tables(mask)
    c2v = torch.zeros(2, code.m, code.n, device=card)
    out = torch.empty_like(c2v)
    assert ldpc_minsum.bp_iteration(c2v, llr, mask, tables=t, out=out) is out
    for bad in (out[:1], out.double(), out.transpose(1, 2).contiguous()
                .transpose(1, 2), out.cpu()):
        with pytest.raises(ValueError, match="out must be"):
            ldpc_minsum.bp_iteration(c2v, llr, mask, tables=t, out=bad)
    with pytest.raises(ValueError, match="out may not be"):
        ldpc_minsum.bp_iteration(c2v, llr, mask, tables=t, out=c2v)
