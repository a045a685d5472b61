"""The 2x2 mean pool of ConvMeanPool and the U-Net (kernels/mean_pool.py) on
the CPU: the plain route against the JAX package's pool and F.avg_pool2d,
the dispatch and its counts, which card tensors the kernel refuses, the pool
table against the models' census, and the launch plan at every pool shape
of NCSNv2-Deepest at ngf 32 and ngf 128 and of the LDAMP U-Net, walked
here as the kernel walks it (csrc/mean_pool2.cu: one thread an output
vector, the sum in f32 in the library's order). The kernel itself is held
against F.avg_pool2d on the card (tests/test_torch_cuda_pool.py,
chip_smoke.py).
"""

import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from score_based_channels_tpu.models.layers import (
    mean_pool_2x2 as jax_mean_pool_2x2,
)
from score_based_channels_torch import kernels
from score_based_channels_torch.config import ModelConfig
from score_based_channels_torch.kernels import mean_pool
from score_based_channels_torch.models import layers, make_score_model
from score_based_channels_torch.models.ncsnv2 import NCSNv2Deepest
from score_based_channels_torch.models.unet import FlippedNormUnet

DTYPES = (torch.bfloat16, torch.float32)
BATCH = {"ngf32": 256, "ngf128": 8, "unet": 128}
EDGES = [(2, 2, 8), (2, 6, 16), (4, 2, 24), (6, 10, 8), (2, 300, 8)]
ZERO = {"launches": 0, "autograd": 0, "plain": 0}


def _nchw(B, H, W, C, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, C, H, W, generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("H,W,C", [(64, 16, 64), (16, 4, 64), (2, 2, 3),
                                   (6, 4, 5)])
def test_plain_route_equals_the_library_and_the_jax_pool(H, W, C):
    x = _nchw(2, H, W, C)
    got = mean_pool.mean_pool_2x2_plain(x)
    assert torch.equal(got, F.avg_pool2d(x, 2))
    want = np.asarray(jax_mean_pool_2x2(jnp.asarray(
        x.permute(0, 2, 3, 1).numpy())))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("grad", [False, True])
def test_layers_pool_counts_plain_on_a_cpu_tensor(grad):
    x = _nchw(2, 16, 4, 8).requires_grad_(grad)
    kernels.reset_counts()
    y = layers.mean_pool_2x2(x)
    assert kernels.counts()["mean_pool_2x2"] == dict(ZERO, plain=1)
    assert torch.equal(y, F.avg_pool2d(x, 2))
    if grad:  # the plain route is the library's, gradient and all
        y.sum().backward()
        want = torch.autograd.grad(F.avg_pool2d(x, 2).sum(), x)[0]
        assert torch.equal(x.grad, want)


@pytest.mark.parametrize("module", ["ConvMeanPool", "MeanPoolConv"])
def test_resampling_blocks_pool_through_the_wrapper(module):
    block = getattr(layers, module)(8, 8)
    kernels.reset_counts()
    with torch.no_grad():
        block(_nchw(2, 16, 4, 8))
    assert kernels.counts()["mean_pool_2x2"] == dict(ZERO, plain=1)


@pytest.mark.parametrize("shape", [(2, 8, 5, 4), (2, 8, 4, 3), (8, 3, 3)])
def test_odd_sizes_raise_as_before(shape):
    kernels.reset_counts()
    with pytest.raises(ValueError, match="requires even spatial dims"):
        layers.mean_pool_2x2(torch.zeros(shape))
    assert kernels.counts()["mean_pool_2x2"] == ZERO


def test_counts_registered_and_reset():
    assert kernels.KERNEL_MODULES["mean_pool_2x2"] is mean_pool
    mean_pool.mean_pool_2x2(_nchw(1, 4, 4, 8))
    for key, n in (("launches", 3), ("autograd", 2)):
        mean_pool.COUNTS[key] += n
    n = kernels.counts()["mean_pool_2x2"]
    assert n["plain"] >= 1 and n["launches"] >= 3 and n["autograd"] >= 2
    kernels.reset_counts()
    assert kernels.counts()["mean_pool_2x2"] == ZERO
    kernels.add_launches({"mean_pool_2x2": 6}, times=2)
    assert kernels.counts()["mean_pool_2x2"] == dict(ZERO, launches=12)
    kernels.reset_counts()


def _walk(x: torch.Tensor, p: mean_pool.Plan) -> torch.Tensor:
    """The kernel's walk of NCHW x (channels-last) as `p` launches it:
    thread i of the grid (those past p.outputs return) takes output vector
    i, the vector fastest, then the column, then the row of the (B H/2)
    rows; it reads the vectors of its window at input row 2r, columns 2c
    and 2c + 1, and the row below, sums them in f32 from 0 in that order,
    takes a quarter and rounds once to the dtype."""
    B, C, H, W = x.shape
    epv = 16 // x.element_size()  # elements of a 16-byte vector
    V, Wo = C // epv, W // 2
    assert p.vectors == V
    flat = x.permute(0, 2, 3, 1).reshape(-1, epv)  # vectors in memory order
    i = torch.arange(p.blocks * p.threads)
    i = i[i < p.outputs]
    pix, v = i // V, i % V
    r, c = pix // Wo, pix % Wo
    row = 2 * Wo * V
    top = 2 * r * row + 2 * c * V + v
    a, b, e, f = (flat[top + d].float() for d in (0, V, row, row + V))
    s = (((torch.zeros_like(a) + a) + b) + e) + f
    out = torch.full((p.outputs, epv), float("nan"), dtype=x.dtype)
    out[i] = (s * 0.25).to(x.dtype)
    return out.view(B, H // 2, Wo, C).permute(0, 3, 1, 2)


def _same_bits(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    ints = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return torch.equal(got.contiguous().view(ints),
                       want.contiguous().view(ints))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model,B,H,W,C", [
    *[(m, BATCH[m], *s) for m in mean_pool.POOLS
      for s, _ in mean_pool.POOLS[m]],
    *[("edge", 3, *s) for s in EDGES]])
def test_launch_plan_covers_the_output_and_its_walk_is_the_pool(
        model, B, H, W, C, dtype):
    p = mean_pool.launch_plan(B, H, W, C, dtype)
    es = 2 if dtype == torch.bfloat16 else 4
    assert p.vectors == C * es // 16
    assert p.outputs == B * (H // 2) * (W // 2) * p.vectors
    assert p.threads % 32 == 0
    assert mean_pool.MIN_THREADS <= p.threads <= mean_pool.THREADS
    assert (p.blocks - 1) * p.threads < p.outputs <= p.blocks * p.threads
    # the small launches take more, smaller blocks
    assert p.blocks >= mean_pool.MIN_BLOCKS \
        or p.threads == mean_pool.MIN_THREADS
    if model in ("ngf32", "unet"):
        assert p.blocks >= 256
    # the walk, on two samples of the shape, cut to at most 16 rows (the
    # walk's index arithmetic keeps every width and crosses a sample)
    h = min(H, 16)
    x = _nchw(2, h, W, C, seed=H * W + C, dtype=dtype)
    assert _same_bits(_walk(x, mean_pool.launch_plan(2, h, W, C, dtype)),
                      F.avg_pool2d(x, 2))


@pytest.mark.parametrize("dtype", DTYPES)
def test_walk_handles_signed_zeros_nan_and_infinities(dtype):
    x = _nchw(2, 6, 4, 16, dtype=dtype)
    x[0, :, :2, :2] = -0.0                # a window of -0: +0, as the library
    x[0, 3, 2, 2] = float("nan")
    x[1, :, :2, 2:] = float("inf")
    x[1, 4, 2:4, :2] = float("inf")
    x[1, 4, 2, 0] = -float("inf")         # inf - inf: NaN
    x[1, 5, 4:6, 0:2] = 3e38              # the f32 sum overflows: inf
    got = _walk(x, mean_pool.launch_plan(2, 6, 4, 16, dtype))
    want = F.avg_pool2d(x, 2)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert _same_bits(got[~nan], want[~nan])
    assert int(nan.sum()) == 2 and bool((want[1, 5, 2, 0] == float("inf")))
    assert not torch.signbit(want[0, :, 0, 0]).any()


@pytest.mark.parametrize("make,error", [
    (lambda: _nchw(2, 8, 2, 64), None),
    (lambda: _nchw(2, 8, 2, 64, dtype=torch.bfloat16), None),
    (lambda: _nchw(2, 8, 2, 8, dtype=torch.bfloat16), None),  # one vector
    (lambda: _nchw(2, 8, 2, 64).contiguous(), ValueError),     # NCHW memory
    (lambda: _nchw(2, 8, 2, 64)[:, :32], ValueError),          # a slice
    (lambda: _nchw(2, 8, 2, 6, dtype=torch.bfloat16), ValueError),  # 12 B
    (lambda: _nchw(2, 8, 2, 2), ValueError),                   # 8 bytes
    (lambda: _nchw(2, 8, 2, 64, dtype=torch.float16), TypeError),
    (lambda: _nchw(2, 8, 2, 64, dtype=torch.float64), TypeError),
    (lambda: _nchw(2, 8, 2, 64)[0], ValueError),               # 3 dims
    (lambda: _nchw(0, 8, 2, 64), ValueError),                  # empty
    (lambda: torch.randn(1 + 8 * 2 * 64).to(torch.bfloat16)[1:]  # 2 bytes in
     .view(1, 8, 2, 64).permute(0, 3, 1, 2), ValueError),
])
def test_card_checks_take_what_the_kernel_can_and_refuse_the_rest(make,
                                                                  error):
    """The card's checks: a tensor the kernel takes gets its launch plan;
    any other card tensor raises before a launch (no library route)."""
    x = make()
    if error is None:
        B, C, H, W = x.shape
        assert mean_pool._check_cuda(x) == mean_pool.launch_plan(
            B, H, W, C, x.dtype)
    else:
        with pytest.raises(error):
            mean_pool._check_cuda(x)


@pytest.mark.parametrize("B,H,W,C,dtype", [
    (2, 8, 2, 6, torch.bfloat16),    # 12 bytes a pixel
    (2, 8, 2, 2, torch.float32),     # 8 bytes
    (0, 8, 2, 64, torch.bfloat16),   # empty batch
    (2, 7, 2, 64, torch.bfloat16),   # odd rows
    (2, 8, 1, 64, torch.bfloat16),   # odd columns
    (2, 8, 2, 64, torch.float16),
    (2 ** 16, 256, 256, 256, torch.float32)])  # 2^36 vectors
def test_launch_plan_refuses_what_the_kernel_does_not_take(B, H, W, C,
                                                           dtype):
    with pytest.raises((ValueError, TypeError)):
        mean_pool.launch_plan(B, H, W, C, dtype)


def _census(model, *args):
    """(H, W, C) -> calls of the mean pool in one no-grad forward."""
    shapes = collections.Counter()
    saved = mean_pool.mean_pool_2x2

    def record(x):
        shapes[tuple(x.shape[2:]) + (x.shape[1],)] += 1
        return saved(x)

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(mean_pool, "mean_pool_2x2", record)
        model(*args)
    return dict(shapes)


def test_pool_table_is_the_models_census():
    """POOLS (the card's timing table) holds each model's pools as the
    census of a forward finds them: 6 a forward of NCSNv2-Deepest at ngf 32
    and ngf 128 (a ConvMeanPool on both branches of res2, res3 and res31),
    3 of the LDAMP U-Net. The ngf-128 forward runs with its convs and
    norms stubbed out, so the census costs no arithmetic."""
    table = {m: dict(rows) for m, rows in mean_pool.POOLS.items()}
    assert [sum(t.values()) for t in table.values()] == [6, 6, 3]
    ngf32 = make_score_model(ModelConfig(), device="cpu")
    assert _census(ngf32, torch.randn(1, 64, 16, 2),
                   torch.ones(1)) == table["ngf32"]
    unet = FlippedNormUnet(chans=16, num_pools=3)
    assert _census(unet, torch.randn(1, 64, 16, 2)) == table["unet"]

    def conv(x, w, b=None, d=1, elu=False):
        return x.new_zeros(x.shape[0], w.shape[0], *x.shape[2:]).contiguous(
            memory_format=torch.channels_last)

    ngf128 = NCSNv2Deepest(dataclasses.replace(ModelConfig(), ngf=128), 3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers.conv_kernel, "conv2d", conv)
        mp.setattr(layers.norm_kernel, "instance_norm_plus",
                   lambda x, *a, elu=False: x)
        got = _census(ngf128, torch.rand(1, 256, 256, 3), torch.tensor(1.0))
    assert got == table["ngf128"]
