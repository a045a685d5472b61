"""The 5x5 max-pool kernel (csrc/max_pool5.cu, kernels/max_pool.py) on the
card against F.max_pool2d: every pool shape of NCSNv2-Deepest at ngf 32
(batch 256, bf16 and f32) and ngf 128 (batch 8, bf16), edge shapes and
values, the autograd route, the refusals, and the launch counts of a
captured sampler level and of a DSM step. Skipped without a card; on the
card, run

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
from score_based_channels_torch.kernels import counts, max_pool, reset_counts
from score_based_channels_torch.models import layers, make_score_model

pytestmark = pytest.mark.cuda

SHAPES = ([("ngf32", 256, dt, s) for dt in (torch.bfloat16, torch.float32)
           for s, _ in max_pool.POOLS["ngf32"]]
          + [("ngf128", 8, torch.bfloat16, s)
             for s, _ in max_pool.POOLS["ngf128"]])


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


@pytest.mark.parametrize("model,B,dtype,shape", SHAPES)
def test_kernel_equals_the_library_at_every_pool_shape(card, model, B, dtype,
                                                       shape):
    H, W, C = shape
    x = _input(card, B, H, W, C, dtype)
    reset_counts()
    with torch.no_grad():
        got = layers.max_pool_5x5(x)
    assert counts()["max_pool_5x5"] == {"launches": 1, "plain": 0,
                                        "autograd": 0}
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, _library(x))
    assert torch.equal(got, max_pool.max_pool_5x5(x))  # launches agree


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,W,C", [
    (3, 1, 1, 8), (3, 2, 2, 8), (5, 4, 3, 16), (2, 3, 7, 24), (4, 8, 2, 64),
    (2, 5, 1, 8), (3, 37, 5, 16), (2, 9, 300, 8), (2, 70, 2, 64),
    (1, 256, 3, 512), (257, 8, 2, 128)])
def test_kernel_equals_the_library_at_edge_shapes(card, B, H, W, C, dtype):
    x = _input(card, B, H, W, C, dtype, seed=H * W + C)
    assert torch.equal(max_pool.max_pool_5x5(x), _library(x))


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


def test_autograd_route_keeps_the_library_and_its_gradient(card):
    x = _input(card, 8, 16, 4, 64, torch.float32).requires_grad_(True)
    reset_counts()
    with torch.enable_grad():
        y = layers.max_pool_5x5(x)
    assert counts()["max_pool_5x5"] == {"launches": 0, "plain": 0,
                                        "autograd": 1}
    g = torch.randn_like(y)
    (y * g).sum().backward()
    want = torch.autograd.grad((_library(x) * g).sum(), x)[0]
    assert torch.equal(x.grad, want)
    with torch.no_grad():  # the same tensor under no_grad: the kernel
        assert torch.equal(layers.max_pool_5x5(x), y.detach())
    assert counts()["max_pool_5x5"]["launches"] == 1


@pytest.mark.parametrize("make,error", [
    (lambda x: x.to(torch.float16), TypeError),
    (lambda x: x.contiguous(), ValueError),              # NCHW memory
    (lambda x: x[:, :6], ValueError),                    # a channel slice
    (lambda x: x[:, :3].contiguous(memory_format=torch.channels_last),
     ValueError),                                        # 6 bytes a pixel
])
def test_kernel_refuses_what_it_does_not_take(card, make, error):
    x = make(_input(card, 2, 8, 2, 64, torch.bfloat16))
    reset_counts()
    with pytest.raises(error), torch.no_grad():
        layers.max_pool_5x5(x)
    assert counts()["max_pool_5x5"] == {"launches": 0, "plain": 0,
                                        "autograd": 0}


def test_a_captured_sampler_level_counts_12_launches_a_forward(card):
    """One PosteriorRunner level captured and replayed (ngf 8, bf16): 12
    kernel launches a forward, as recorded and as counted, none plain."""
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
    assert sampling.STATS["forwards"] == levels * steps


def test_a_dsm_step_pools_on_the_library_under_grad(card):
    """DSM's loss under grad keeps F.max_pool2d (12 calls, no launch); its
    validation loss, under no_grad, launches the kernel 12 times."""
    g = torch.Generator().manual_seed(0)
    model = make_score_model(ModelConfig(ngf=8), device=card, generator=g)
    x = torch.randn(4, 64, 16, 2, generator=g).to(card)
    sig = get_sigmas(1.0, 0.01, 10).to(card)
    reset_counts()
    anneal_dsm_loss(model, x, sig).backward()
    assert counts()["max_pool_5x5"] == {"launches": 0, "plain": 0,
                                        "autograd": 12}
    with torch.no_grad():
        anneal_dsm_loss(model, x, sig)
    assert counts()["max_pool_5x5"] == {"launches": 12, "plain": 0,
                                        "autograd": 12}
