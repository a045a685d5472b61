"""The 5x5 max pool of the CRP blocks (kernels/max_pool.py) on the CPU: the
plain route against the JAX package's flax pool and F.max_pool2d, the
dispatch and its counts, the card's argument checks, and the launch plan
at every pool shape of NCSNv2-Deepest at ngf 32 and ngf 128, walked here as
the kernel walks it (csrc/max_pool5.cu: clamped tiles, bands, sub-bands).
The kernel itself is held against F.max_pool2d on the card
(tests/test_torch_cuda_pool.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from score_based_channels_tpu.models.layers import (
    max_pool_5x5 as jax_max_pool_5x5,
)
from score_based_channels_torch import kernels
from score_based_channels_torch.kernels import max_pool
from score_based_channels_torch.models import layers

DTYPES = (torch.bfloat16, torch.float32)
# (H, W, C) of each CRP block's two pools, in forward order
NGF32 = [(8, 2, 128), (8, 2, 64), (8, 2, 64), (16, 4, 64), (32, 8, 32),
         (64, 16, 32)]
NGF128 = [(32, 32, 512), (32, 32, 256), (32, 32, 256), (64, 64, 256),
          (128, 128, 128), (256, 256, 128)]
# edges: rows and columns under the window, one pixel, ragged bands
EDGES = [(1, 1, 8), (2, 2, 8), (3, 7, 16), (5, 1, 8), (4, 3, 24),
         (37, 5, 16), (9, 300, 8), (70, 2, 64)]


def _nchw(B, H, W, C, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, C, H, W, generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("H,W,C", [(64, 16, 32), (8, 2, 64), (4, 3, 5),
                                   (1, 1, 3), (7, 6, 2)])
def test_plain_route_equals_the_library_and_the_jax_pool(H, W, C):
    x = _nchw(2, H, W, C)
    got = max_pool.max_pool_5x5_plain(x)
    assert torch.equal(got, F.max_pool2d(x, 5, stride=1, padding=2))
    want = np.asarray(jax_max_pool_5x5(jnp.asarray(
        x.permute(0, 2, 3, 1).numpy())))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("grad", [False, True])
def test_layers_pool_counts_plain_on_a_cpu_tensor(grad):
    x = _nchw(2, 16, 4, 8).requires_grad_(grad)
    kernels.reset_counts()
    y = layers.max_pool_5x5(x)
    assert kernels.counts()["max_pool_5x5"] == {"launches": 0, "plain": 1,
                                                "autograd": 0}
    assert torch.equal(y, F.max_pool2d(x, 5, stride=1, padding=2))
    if grad:  # the plain route is the library's, gradient and all
        y.sum().backward()
        want = torch.autograd.grad(
            F.max_pool2d(x, 5, stride=1, padding=2).sum(), x)[0]
        assert torch.equal(x.grad, want)


def test_crp_block_pools_through_the_wrapper():
    block = layers.CRPBlock(8, n_stages=2)
    kernels.reset_counts()
    with torch.no_grad():
        block(_nchw(2, 16, 4, 8))
    assert kernels.counts()["max_pool_5x5"]["plain"] == 2


def test_counts_registered_and_reset():
    assert kernels.KERNEL_MODULES["max_pool_5x5"] is max_pool
    max_pool.max_pool_5x5(_nchw(1, 4, 4, 8))
    max_pool.COUNTS["launches"] += 3
    max_pool.COUNTS["autograd"] += 2
    n = kernels.counts()["max_pool_5x5"]
    assert n["plain"] >= 1 and n["launches"] >= 3 and n["autograd"] >= 2
    kernels.reset_counts()
    assert kernels.counts()["max_pool_5x5"] == {"launches": 0, "plain": 0,
                                                "autograd": 0}
    kernels.add_launches({"max_pool_5x5": 12}, times=2)
    assert kernels.counts()["max_pool_5x5"]["launches"] == 24
    kernels.reset_counts()


def _walk(x: torch.Tensor, p: max_pool.Plan) -> torch.Tensor:
    """The kernel's walk of NCHW x (channels-last) as `p` cuts it: each
    block's tile holds the in-image rows and columns of its band with their
    2-pixel halo; a tap outside the image reads the nearest pixel in it;
    each thread writes its sub-band's rows once. Raises where a block's tile
    exceeds p.smem or an output is written twice or never."""
    B, C, H, W = x.shape
    nhwc = x.permute(0, 2, 3, 1)
    epv = C // p.vectors  # elements of a 16-byte vector
    out = torch.full_like(nhwc, float("nan"))
    written = torch.zeros(B, H, W, p.groups, dtype=torch.int32)
    th = p.sub * p.rows
    for b in range(B):
        for g in range(p.groups):
            ch = slice(g * p.vg * epv, (g + 1) * p.vg * epv)
            for cb in range(p.col_blocks):
                for band in range(p.bands):
                    h0, w0 = band * th, cb * p.tw
                    r_lo, r_hi = max(h0 - 2, 0), min(h0 + th + 2, H)
                    c_lo, c_hi = max(w0 - 2, 0), min(w0 + p.tw + 2, W)
                    assert (r_hi - r_lo) * (c_hi - c_lo) * p.vg * 16 \
                        <= p.smem
                    tile = nhwc[b, r_lo:r_hi, c_lo:c_hi, ch]
                    for s in range(p.sub):
                        hs = h0 + s * p.rows
                        if hs >= H:  # a sub-band past the image: idle
                            continue
                        rows = torch.arange(hs, min(hs + p.rows, H))
                        cols = torch.arange(w0, min(w0 + p.tw, W))
                        d = torch.arange(-2, 3)
                        ri = (rows[:, None] + d).clamp(0, H - 1) - r_lo
                        ci = (cols[:, None] + d).clamp(0, W - 1) - c_lo
                        win = tile[ri[:, :, None, None], ci[None, None]]
                        out[b, rows[:, None], cols[None], ch] = \
                            win.amax(dim=(1, 3))
                        written[b, rows[:, None], cols[None], g] += 1
    assert bool((written == 1).all())
    return out.permute(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model,B,H,W,C", [
    *[("ngf32", 256, *s) for s in NGF32],
    *[("ngf128", 8, *s) for s in NGF128],
    *[("edge", 3, *s) for s in EDGES]])
def test_launch_plan_is_a_valid_tile_and_its_walk_is_the_pool(
        model, B, H, W, C, dtype):
    p = max_pool.launch_plan(B, H, W, C, dtype)
    es = 2 if dtype == torch.bfloat16 else 4
    assert p.vectors == C * es // 16 and p.vectors % p.vg == 0
    assert p.vg in (1, 2, 4, 8) and p.groups * p.vg == p.vectors
    assert p.threads == p.vg * p.tw * p.sub <= max_pool.MAX_THREADS
    assert p.smem == max_pool.tile_bytes(H, W, p.vg, p.tw, p.sub * p.rows)
    assert p.smem <= max_pool.MAX_SMEM
    assert (p.bands - 1) * p.sub * p.rows < H <= p.bands * p.sub * p.rows
    assert (p.col_blocks - 1) * p.tw < W <= p.col_blocks * p.tw
    assert p.blocks == B * p.groups * p.col_blocks * p.bands < 2 ** 31
    # the walk, on two samples of the shape (the plan is per sample)
    x = _nchw(2, H, W, C, seed=H * W + C, dtype=dtype)
    assert torch.equal(_walk(x, p), F.max_pool2d(x, 5, stride=1, padding=2))


def test_walk_handles_nan_and_infinities():
    x = _nchw(2, 9, 6, 16)
    x[0, 3, 4, 2] = float("nan")
    x[1, :, :3, :] = -float("inf")
    x[1, 5, 5, 5] = float("inf")
    p = max_pool.launch_plan(2, 9, 6, 16, torch.float32)
    got, want = _walk(x, p), F.max_pool2d(x, 5, stride=1, padding=2)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    keep = ~torch.isnan(want)
    assert torch.equal(got[keep], want[keep])
    assert int(torch.isnan(want).sum()) == 5 * 5


@pytest.mark.parametrize("make,error", [
    (lambda: _nchw(2, 8, 2, 64).contiguous(), ValueError),   # NCHW memory
    (lambda: _nchw(2, 8, 2, 64, dtype=torch.float16), TypeError),
    (lambda: _nchw(2, 8, 2, 64, dtype=torch.float64), TypeError),
    (lambda: _nchw(2, 8, 2, 64)[0], ValueError),               # 3 dims
    (lambda: torch.randn(1 + 8 * 2 * 64).to(torch.bfloat16)[1:]  # 2 bytes in
     .view(1, 8, 2, 64).permute(0, 3, 1, 2), ValueError),
])
def test_card_checks_refuse_what_the_kernel_does_not_take(make, error):
    with pytest.raises(error):
        max_pool._check_cuda(make())


@pytest.mark.parametrize("B,H,W,C,dtype", [
    (2, 8, 2, 6, torch.bfloat16),    # 12 bytes a pixel
    (2, 8, 2, 2, torch.float32),     # 8 bytes
    (0, 8, 2, 64, torch.bfloat16),   # empty batch
    (2, 8, 2, 64, torch.float16)])
def test_launch_plan_refuses_shapes_the_kernel_does_not_take(B, H, W, C,
                                                             dtype):
    with pytest.raises((ValueError, TypeError)):
        max_pool.launch_plan(B, H, W, C, dtype)


def test_pool_table_is_the_models_census():
    """POOLS (the card's timing table) holds each model's pools, 12 a
    forward, as the census of a forward finds them."""
    for name, shapes in (("ngf32", NGF32), ("ngf128", NGF128)):
        table = {s: n for s, n in max_pool.POOLS[name]}
        assert sum(table.values()) == 12
        assert table == {s: 2 * shapes.count(s) for s in set(shapes)}
    shapes = []
    saved = max_pool.max_pool_5x5

    def record(x):
        shapes.append(tuple(x.shape[2:]) + (x.shape[1],))
        return saved(x)

    from score_based_channels_torch.config import ModelConfig
    from score_based_channels_torch.models import make_score_model

    model = make_score_model(ModelConfig(), device="cpu")
    max_pool.max_pool_5x5 = record
    try:
        with torch.no_grad():
            model(torch.randn(1, 64, 16, 2), torch.ones(1))
    finally:
        max_pool.max_pool_5x5 = saved
    assert sorted(shapes) == sorted(s for s in NGF32 for _ in range(2))
