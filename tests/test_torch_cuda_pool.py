"""The pool kernels on the card against the library: the 5x5 max pool
(csrc/max_pool5.cu, kernels/max_pool.py) against F.max_pool2d and the 2x2
mean pool (csrc/mean_pool2.cu, kernels/mean_pool.py) against F.avg_pool2d,
at every pool shape of NCSNv2-Deepest at ngf 32 (batch 256, bf16 and f32)
and ngf 128 (batch 8) and, for the mean pool, of the LDAMP U-Net (batch
128), edge shapes and values, the autograd route, what each refuses, the
launch counts of a captured sampler level, of a DSM step and of LDAMP's
forwards, and `pool_bench`'s timing. Skipped without a card; on the card,
run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_pool.py

(this file imports no JAX).
"""

import pytest
import torch
import torch.nn.functional as F

from score_based_channels_torch import _graph, cplx, physics
from score_based_channels_torch.config import ModelConfig
from score_based_channels_torch.diffusion import sampling
from score_based_channels_torch.diffusion.dsm import anneal_dsm_loss
from score_based_channels_torch.diffusion.sampling import PosteriorRunner
from score_based_channels_torch.diffusion.sigmas import get_sigmas
from score_based_channels_torch.eval.estimate import score_fn_from_params
from score_based_channels_torch.kernels import (counts, max_pool, mean_pool,
                                                pool_bench, reset_counts)
from score_based_channels_torch.models import layers, make_score_model
from score_based_channels_torch.models.unet import FlippedNormUnet

pytestmark = pytest.mark.cuda

# name in kernels.counts(), the layer's function, the kernel's wrapper, the
# library's pool, the counts of one launch
POOL = {
    "max": ("max_pool_5x5", layers.max_pool_5x5, max_pool.max_pool_5x5,
            lambda x: F.max_pool2d(x, 5, stride=1, padding=2),
            {"launches": 1, "plain": 0, "autograd": 0}),
    "mean": ("mean_pool_2x2", layers.mean_pool_2x2, mean_pool.mean_pool_2x2,
             lambda x: F.avg_pool2d(x, 2),
             {"launches": 1, "autograd": 0, "plain": 0}),
}
MEAN_ZERO = {"launches": 0, "autograd": 0, "plain": 0}
BF16, F32 = torch.bfloat16, torch.float32
SHAPES = ([("max", "ngf32", 256, dt, s) for dt in (BF16, F32)
           for s, _ in max_pool.POOLS["ngf32"]]
          + [("max", "ngf128", 8, BF16, s)
             for s, _ in max_pool.POOLS["ngf128"]]
          + [("mean", m, B, dt, s) for m, B in (("ngf32", 256), ("ngf128", 8),
                                                ("unet", 128))
             for dt in (BF16, F32) for s, _ in mean_pool.POOLS[m]])
EDGE_SHAPES = ([("max", *s) for s in [
    (3, 1, 1, 8), (3, 2, 2, 8), (5, 4, 3, 16), (2, 3, 7, 24), (4, 8, 2, 64),
    (2, 5, 1, 8), (3, 37, 5, 16), (2, 9, 300, 8), (2, 70, 2, 64),
    (1, 256, 3, 512), (257, 8, 2, 128)]]
    + [("mean", *s) for s in [
        (3, 2, 2, 8), (5, 4, 6, 16), (2, 6, 10, 24), (2, 2, 300, 8),
        (2, 70, 2, 64), (1, 256, 4, 512), (257, 8, 2, 128)]])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _input(card, B, H, W, C, dtype, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    return torch.randn(B, C, H, W, device=card, generator=g).to(dtype) \
        .contiguous(memory_format=torch.channels_last)


def _library(x):
    return F.max_pool2d(x, 5, stride=1, padding=2)


def _same_up_to_nan(got, want):
    """Equal values, NaN where the library has NaN."""
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan],
                                                              want[~nan])


def _same_bits(got, want):
    """Equal bits, NaNs and signed zeros included."""
    ints = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return got.shape == want.shape and torch.equal(
        got.contiguous().view(ints), want.contiguous().view(ints))


@pytest.mark.parametrize("pool,model,B,dtype,shape", SHAPES)
def test_kernel_equals_the_library_at_every_pool_shape(card, pool, model, B,
                                                       dtype, shape):
    name, layer, wrapper, library, one = POOL[pool]
    H, W, C = shape
    x = _input(card, B, H, W, C, dtype)
    reset_counts()
    with torch.no_grad():
        got = layer(x)
    assert counts()[name] == one
    want = library(x)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want) and _same_bits(got, want)
    assert torch.equal(got, wrapper(x))  # launches agree


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pool,B,H,W,C", EDGE_SHAPES)
def test_kernel_equals_the_library_at_edge_shapes(card, pool, B, H, W, C,
                                                  dtype):
    name, _, wrapper, library, _ = POOL[pool]
    x = _input(card, B, H, W, C, dtype, seed=H * W + C)
    reset_counts()
    assert torch.equal(wrapper(x), library(x))
    assert counts()[name]["launches"] == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_on_ties_nan_and_infinities(card, dtype):
    x = _input(card, 4, 12, 9, 32, dtype)
    x[0] = 0.25                         # all equal
    x[1, :, :, :4] = -float("inf")      # a block of -inf
    x[1, 3, 5, 6] = float("inf")
    x[2, 7, 4, 2] = float("nan")        # one NaN: its 5x5 neighbourhood
    x[3] = -float("inf")                # all -inf
    x[3, 5, 0, 0] = float("nan")
    got, want = max_pool.max_pool_5x5(x), _library(x)
    assert _same_up_to_nan(got, want)
    assert int(torch.isnan(want[2]).sum()) == 25
    assert bool((got[0] == 0.25).all()) and bool((got[3, :5] ==
                                                  -float("inf")).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mean_kernel_on_signed_zeros_nan_and_infinities(card, dtype):
    """Bit for bit the library's where the values are special: a window of
    -0 gives +0 (the sum starts from 0), inf - inf and a NaN give NaN, a
    sum past the largest f32 gives inf."""
    x = _input(card, 4, 12, 10, 32, dtype)
    x[0] = -0.0
    x[0, :, 4:6, 4:6] = 0.0
    x[1, :, :, :4] = float("inf")
    x[1, 3, 5, 2] = -float("inf")
    x[2, 7, 4, 2] = float("nan")
    x[2, 9, 6:8, 6:8] = 3e38
    x[3] = -float("inf")
    x[3, 5, 0, 0] = float("nan")
    reset_counts()
    got, want = mean_pool.mean_pool_2x2(x), F.avg_pool2d(x, 2)
    assert counts()["mean_pool_2x2"]["launches"] == 1
    assert _same_up_to_nan(got, want)
    assert not bool(torch.signbit(want[0]).any())
    assert bool((want[2, 9, 3, 3] == float("inf")))
    assert int(torch.isnan(want).sum()) == 3
    assert _same_bits(got, want)


@pytest.mark.parametrize("pool", ["max", "mean"])
def test_autograd_route_keeps_the_library_and_its_gradient(card, pool):
    name, layer, _, library, one = POOL[pool]
    x = _input(card, 8, 16, 4, 64, torch.float32).requires_grad_(True)
    reset_counts()
    with torch.enable_grad():
        y = layer(x)
    assert counts()[name] == dict(one, launches=0, autograd=1)
    g = torch.randn_like(y)
    (y * g).sum().backward()
    want = torch.autograd.grad((library(x) * g).sum(), x)[0]
    assert torch.equal(x.grad, want)
    with torch.no_grad():  # the same tensor under no_grad: the kernel
        assert torch.equal(layer(x), y.detach())
    assert counts()[name]["launches"] == 1


@pytest.mark.parametrize("pool", ["max", "mean"])
@pytest.mark.parametrize("make,error", [
    (lambda x: x.to(torch.float16), TypeError),
    (lambda x: x.contiguous(), ValueError),              # NCHW memory
    (lambda x: x[:, :6], ValueError),                    # a channel slice
    (lambda x: x[:, :3].contiguous(memory_format=torch.channels_last),
     ValueError),                                        # 6 bytes a pixel
    (lambda x: x[0], ValueError),                        # 3 dims
])
def test_kernel_refuses_what_it_does_not_take(card, pool, make, error):
    name, layer, _, _, one = POOL[pool]
    x = make(_input(card, 2, 8, 2, 64, torch.bfloat16))
    reset_counts()
    with pytest.raises(error), torch.no_grad():
        layer(x)
    assert counts()[name] == dict(one, launches=0)


def test_a_captured_sampler_level_counts_12_launches_a_forward(card):
    """One PosteriorRunner level captured and replayed (ngf 8, bf16): 12
    max-pool and 6 mean-pool launches a forward, as recorded and as
    counted, none plain."""
    levels, steps, B = 3, 2, 8
    g = torch.Generator().manual_seed(4)
    mcfg = ModelConfig(ngf=8)
    model = make_score_model(mcfg, device=card, generator=g)
    A = cplx.conj_transpose(cplx.qpsk_pilots(g, B, 64, 38))
    X = cplx.randn(g, (B, 64, 16))
    npow = float(physics.snr_to_noise_power(10.0, 64))
    Y = physics.measure_c2(g, A, X, npow)
    x0 = cplx.randn(g, (B, 64, 16))
    sig = get_sigmas(mcfg.sigma_begin, mcfg.sigma_end, levels)
    runner = PosteriorRunner(score_fn_from_params(model, torch.bfloat16),
                             sig, torch.Generator(device=card).manual_seed(0),
                             steps_each=steps)
    reset_counts()
    sampling.reset_stats()
    _graph.reset_stats()
    runner.run(A.to(card), Y.to(card), npow, x0.to(card), oracle=X.to(card))
    assert runner.replayer.cap.launches["max_pool_5x5"] == 12 * steps
    assert _graph.STATS["replays"] == levels - 1
    assert counts()["max_pool_5x5"] == {
        "launches": 12 * sampling.STATS["forwards"], "plain": 0,
        "autograd": 0}
    assert runner.replayer.cap.launches["mean_pool_2x2"] == 6 * steps
    assert counts()["mean_pool_2x2"] == dict(
        MEAN_ZERO, launches=6 * sampling.STATS["forwards"])
    assert sampling.STATS["forwards"] == levels * steps


def test_a_dsm_step_pools_on_the_library_under_grad(card):
    """DSM's loss under grad keeps F.max_pool2d and F.avg_pool2d (12 and 6
    calls, no launch); its validation loss, under no_grad, launches the
    kernels 12 and 6 times."""
    g = torch.Generator().manual_seed(0)
    model = make_score_model(ModelConfig(ngf=8), device=card, generator=g)
    x = torch.randn(4, 64, 16, 2, generator=g).to(card)
    sig = get_sigmas(1.0, 0.01, 10).to(card)
    reset_counts()
    anneal_dsm_loss(model, x, sig).backward()
    assert counts()["max_pool_5x5"] == {"launches": 0, "plain": 0,
                                        "autograd": 12}
    assert counts()["mean_pool_2x2"] == dict(MEAN_ZERO, autograd=6)
    with torch.no_grad():
        anneal_dsm_loss(model, x, sig)
    assert counts()["max_pool_5x5"] == {"launches": 12, "plain": 0,
                                        "autograd": 12}
    assert counts()["mean_pool_2x2"] == dict(MEAN_ZERO, launches=6,
                                             autograd=6)


def test_ldamp_unet_pools_on_the_kernel_without_grad(card):
    """The LDAMP U-Net (f32, chans 16, 3 pools): a graded forward keeps
    F.avg_pool2d (3 calls), a forward under no_grad (the divergence
    probes) launches the kernel 3 times, with the same output bits."""
    g = torch.Generator().manual_seed(1)
    unet = FlippedNormUnet(chans=16, num_pools=3)
    unet.init_parameters(g)
    unet = unet.to(card)
    x = torch.randn(128, 64, 16, 2, generator=g).to(card)
    reset_counts()
    y = unet(x)
    assert counts()["mean_pool_2x2"] == dict(MEAN_ZERO, autograd=3)
    with torch.no_grad():
        assert torch.equal(unet(x), y.detach())
    assert counts()["mean_pool_2x2"] == dict(MEAN_ZERO, launches=3,
                                             autograd=3)


@pytest.mark.parametrize("pool", [max_pool, mean_pool], ids=["max", "mean"])
def test_pool_bench_times_the_kernel_beside_the_library(card, pool):
    """pool_bench.per_forward over a forward's pools at a small batch: the
    kernel equals the library at each shape, every time and bound is
    positive, and the sums take each shape as often as a forward does."""
    f = pool_bench.per_forward(pool, "ngf32", 2, torch.bfloat16, reps=2)
    assert f["equal"] and [r["shape"] for r in f["rows"]] == [
        list(s) for s, _ in pool.POOLS["ngf32"]]
    assert min(min(r["kernel_ms"], r["library_ms"], r["bound_ms"])
               for r in f["rows"]) > 0
    assert f["bound_ms"] == pytest.approx(sum(
        r["bound_ms"] * n for r, (_, n) in zip(f["rows"],
                                                pool.POOLS["ngf32"])))
