"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain versions; the same inputs, made
with numpy from a seed, go through the Pallas kernel in interpret mode and
the flax/lax oracles. Bars are the JAX package's own
(tests/test_kernels.py): InstanceNorm++ rtol 2e-4 / atol 2e-5, conv 1e-5.
The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from score_based_channels_tpu.kernels.conv_probe import (
    conv_oracle, conv_pertap, live_taps as jax_live_taps,
)
from score_based_channels_tpu.kernels.instance_norm import (
    instance_norm_plus_pallas,
)
from score_based_channels_tpu.models.layers import InstanceNorm2dPlus
from score_based_channels_torch.kernels import (
    conv, conv_im2col, counts, instance_norm, reset_counts,
)

torch.set_num_threads(1)


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW tensor in channels_last memory (no copy)."""
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def _norm_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    alpha, gamma = (1 + 0.1 * rng.randn(2, c)).astype(np.float32)
    beta = (0.1 * rng.randn(c)).astype(np.float32)
    return x, alpha, gamma, beta


@pytest.mark.parametrize("elu", [False, True])
@pytest.mark.parametrize("shape", [(3, 64, 16, 32), (2, 8, 2, 128)])
def test_instance_norm_matches_pallas(shape, elu):
    x, alpha, gamma, beta = _norm_inputs(shape, 0)
    want = instance_norm_plus_pallas(
        jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(gamma),
        jnp.asarray(beta), fuse_elu=elu, interpret=True)
    got = instance_norm.instance_norm_plus(
        _nchw(x), *map(torch.from_numpy, (alpha, gamma, beta)), elu=elu)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("shape", [(3, 64, 16, 32), (2, 8, 2, 128)])
def test_instance_norm_matches_flax_module(shape):
    x = _norm_inputs(shape, 1)[0]
    module = InstanceNorm2dPlus(shape[-1])
    params = module.init(jax.random.key(0), jnp.asarray(x))["params"]
    params = {k: v * 1.1 + 0.05 for k, v in params.items()}  # beta != 0
    want = module.apply({"params": params}, jnp.asarray(x))
    got = instance_norm.instance_norm_plus(
        _nchw(x), *(torch.tensor(np.asarray(params[k]))
                    for k in ("alpha", "gamma", "beta")))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want),
                               rtol=2e-4, atol=2e-5)


def test_instance_norm_bf16_keeps_dtype_and_f32_statistics():
    x, alpha, gamma, beta = _norm_inputs((2, 16, 4, 64), 2)
    xb = _nchw(x).to(torch.bfloat16)
    p = [torch.from_numpy(v) for v in (alpha, gamma, beta)]
    got = instance_norm.instance_norm_plus(xb, *p, elu=True)
    want = instance_norm.instance_norm_plus(xb.float(), *p, elu=True)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want).abs().max() <= 2e-2 * want.abs().max()


CONV_CASES = [
    # (H, W, Cin, Cout, k, d, bias, elu): tests/test_kernels.py:72-77 plus a
    # 1x1 case and a no-bias + ELU case
    (8, 2, 16, 16, 3, 1, True, False),
    (8, 2, 16, 16, 3, 4, True, False),
    (16, 4, 8, 16, 3, 2, True, False),
    (4, 4, 8, 8, 3, 1, True, False),
    (8, 2, 16, 32, 1, 1, True, False),
    (16, 4, 8, 8, 3, 1, False, True),
]


def _conv_inputs(H, W, Cin, Cout, k, seed, B=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, Cin).astype(np.float32)
    w_hwio = (rng.randn(k, k, Cin, Cout) / (3 * Cin)).astype(np.float32)
    b = np.linspace(-1, 1, Cout, dtype=np.float32)
    return x, w_hwio, b


def _to_sbc(x):
    B, H, W, C = x.shape
    return jnp.asarray(x.transpose(1, 2, 0, 3).reshape(H * W, B, C))


def _from_sbc(y, B, H, W):
    return np.asarray(y).reshape(H, W, B, -1).transpose(2, 0, 1, 3)


@pytest.mark.parametrize("H,W,Cin,Cout,k,d,bias,elu", CONV_CASES)
def test_conv_matches_pallas_and_oracle(H, W, Cin, Cout, k, d, bias, elu):
    x, w_hwio, b = _conv_inputs(H, W, Cin, Cout, k, H * W * Cin + d)
    bj = jnp.asarray(b) if bias else None
    want_p = _from_sbc(conv_pertap(_to_sbc(x), jnp.asarray(w_hwio), bj, H, W,
                                   d, act=elu, interpret=True), 8, H, W)
    want_o = _from_sbc(conv_oracle(_to_sbc(x), jnp.asarray(w_hwio), bj, H, W,
                                   d, act=elu), 8, H, W)
    weight = torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy())
    got = _nhwc(conv.conv2d(_nchw(x), weight,
                            torch.from_numpy(b) if bias else None, d, elu))
    np.testing.assert_allclose(got, want_p, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_o, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,d,H,W", [(3, 1, 8, 2), (3, 4, 8, 2), (3, 2, 8, 2),
                                     (3, 2, 16, 4), (1, 1, 8, 2), (3, 4, 4, 4)])
def test_live_taps_match_pallas(k, d, H, W):
    assert [t[:4] for t in jax_live_taps(k, d, H, W)] == [
        (iy, ix, dy, dx) for iy, ix, dy, dx in conv.live_taps(k, d, H, W)]


def _taps_sum(x, weight, bias, d):
    """What the kernel computes from the weight's memory: the sum over the
    live taps of the zero-padded input shifted by (dy, dx) times the
    (Cin, Cout) matrix at offset wi * Cin * Cout, wi = iy * k + ix."""
    B, C, H, W = x.shape
    Cout, _, k, _ = weight.shape
    mem = weight.as_strided((weight.numel(),), (1,))
    taps = conv.live_taps(k, d, H, W)
    py, px = max(abs(t[2]) for t in taps), max(abs(t[3]) for t in taps)
    xp = F.pad(x, (px, px, py, py))
    acc = torch.zeros(B, H, W, Cout)
    for iy, ix, dy, dx in taps:
        wi = iy * k + ix
        w_t = mem[wi * C * Cout:(wi + 1) * C * Cout].view(C, Cout)
        win = xp[:, :, py + dy:py + dy + H, px + dx:px + dx + W]
        acc += torch.einsum("bchw,co->bhwo", win, w_t)
    if bias is not None:
        acc = acc + bias
    return acc.permute(0, 3, 1, 2)


@pytest.mark.parametrize("H,W,Cin,Cout,k,d,bias,elu", CONV_CASES + [
    (64, 16, 4, 2, 3, 1, True, False)])  # Cout=2 pads to 4 (end_conv)
def test_tap_sum_over_kernel_layout_equals_plain_conv(H, W, Cin, Cout, k, d,
                                                      bias, elu):
    x, w_hwio, b = _conv_inputs(H, W, Cin, Cout, k, 7, B=2)
    weight = conv.kernel_layout(
        torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy()))
    assert conv.has_kernel_layout(weight)
    assert not conv.has_kernel_layout(weight.contiguous()) or k == 1 == Cout
    bt = torch.from_numpy(b) if bias else None
    got = _taps_sum(_nchw(x), weight, bt, d)
    want = conv.conv2d_plain(_nchw(x), weight, bt, d, elu=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("H,W,k,d,wi", [(8, 2, 3, 4, [1, 4, 7]),
                                        (8, 2, 3, 1, list(range(9))),
                                        (16, 4, 1, 1, [0])])
def test_launch_args_are_made_once_per_shape(H, W, k, d, wi):
    taps = conv.live_taps(k, d, H, W)
    for bf16, plan in ((False, conv.plan), (True, conv.wgmma_plan)):
        args = conv._launch_args(256, H, W, 64, 64, k, d, bf16)
        assert conv._launch_args(256, H, W, 64, 64, k, d, bf16) is args
        p, T, dy, dx, wis = args
        assert T == len(wi) and list(wis) == wi
        assert list(dy) == [t[2] for t in taps]
        assert list(dx) == [t[3] for t in taps]
        assert p == plan(256, H, W, 64, 64, list(dy), list(dx))
        if not bf16:  # 32 tiles of 8x2 at batch 256: split over clusters
            assert p.CL > 1 or (H, W) != (8, 2)


# the 19 conv shapes of one NCSNv2-Deepest forward (H, W, Cin, Cout, k, d)
MAIN_PATH_CONVS = [
    (8, 2, 64, 64, 3, 1), (64, 16, 32, 32, 3, 1), (16, 4, 64, 64, 3, 1),
    (8, 2, 128, 128, 3, 1), (32, 8, 32, 32, 3, 1), (32, 8, 64, 64, 3, 1),
    (8, 2, 128, 128, 3, 4), (8, 2, 64, 128, 3, 2), (8, 2, 128, 128, 3, 2),
    (8, 2, 128, 64, 3, 1), (64, 16, 2, 32, 3, 1), (64, 16, 32, 64, 3, 1),
    (64, 16, 32, 64, 1, 1), (32, 8, 64, 64, 1, 1), (16, 4, 64, 64, 1, 1),
    (8, 2, 64, 64, 3, 2), (32, 8, 64, 32, 3, 1), (16, 4, 64, 32, 3, 1),
    (64, 16, 32, 2, 3, 1)]


@pytest.mark.parametrize("B", [256, 2])
@pytest.mark.parametrize("H,W,Cin,Cout,k,d", MAIN_PATH_CONVS)
def test_conv_plan_fits_the_card(H, W, Cin, Cout, k, d, B):
    taps = conv.live_taps(k, d, H, W)
    dy, dx = [t[2] for t in taps], [t[3] for t in taps]
    # float32: the implicit-GEMM kernel's plan
    p = conv.plan(B, H, W, Cin, Cout, dy, dx)
    assert p.BN in conv.F32_BN and p.BN >= min(Cout, 32)
    assert p.BM % conv.f32_warp_pixels(p.BN) == 0
    assert p.threads == p.BM * p.BN // 32
    assert p.threads % 32 == 0 and 32 <= p.threads <= conv.F32_MAX_THREADS
    assert p.smem <= conv.MAX_SMEM_OPTIN and p.smem == conv.f32_smem(
        p.SB, p.TH + 2 * p.py, W + 2 * p.px, len(taps), p.BM, p.BN, p.BK,
        p.stages)
    assert 1 <= p.TH <= H and 1 <= p.SB <= B and p.SB * p.TH * W <= p.BM
    assert p.SB == 1 or p.TH == H
    assert p.CL in conv.F32_CLUSTERS and p.CL <= p.nchunks
    assert 2 <= p.stages <= 3 and p.BK in conv.F32_BK
    assert p.blocks >= conv.SMS or p.why
    # bf16: conv2d_taps's wgmma plan
    q = conv.wgmma_plan(B, H, W, Cin, Cout, dy, dx)
    assert q.smem <= 232_448 and q.smem == conv.wgmma_smem(
        q.SB, q.TH + 2 * q.py, W + 2 * q.px, q.KS, q.BN,
        len(taps) * q.nchunks, q.BM)
    assert q.BM % 64 == 0 and q.threads == q.BM // 64 * 128 + 32
    assert q.SB * q.TH * W <= q.BM and (q.SB == 1 or q.TH == H)
    assert q.BN in conv.WGMMA_N and q.BN >= min(Cout, 32)
    assert 16 * q.KS * q.nchunks >= Cin > 16 * q.KS * (q.nchunks - 1)
    assert q.tiles == (-(-H // q.TH), -(-B // q.SB), -(-Cout // q.BN))
    # bf16: conv_im2col's plan, on the same tiles
    r = conv_im2col.plan(B, H, W, Cin, Cout, len(taps), torch.bfloat16)
    assert r.route == conv_im2col.WGMMA and r.smem <= 232_448
    assert (r.BM, r.SB, r.TH) == (q.BM, q.SB, q.TH)
    assert r.BN in conv.WGMMA_N and r.stages >= 4
    assert r.grid == (q.tiles[0] * q.tiles[1], -(-Cout // r.BN))
    if B == 256 and (H, W) == (8, 2):  # the 8x2 layers fill the card
        assert q.tiles[0] * q.tiles[1] * q.tiles[2] >= 128
        assert r.grid[0] * r.grid[1] >= 128


@pytest.mark.parametrize("Cin,Cout", [(2, 32), (32, 2), (8, 8), (16, 8),
                                      (3, 5), (1, 1), (24, 40), (128, 128)])
def test_wgmma_plans_take_every_channel_count(Cin, Cout):
    """ngf = 8 widths, the 2-channel begin and end convs and odd counts."""
    for H, W in ((64, 16), (8, 2), (5, 3)):
        taps = conv.live_taps(3, 1, H, W)
        q = conv.wgmma_plan(4, H, W, Cin, Cout, [t[2] for t in taps],
                            [t[3] for t in taps])
        assert q.BN in conv.WGMMA_N and q.smem <= 232_448
        r = conv_im2col.plan(4, H, W, Cin, Cout, 9, torch.bfloat16)
        assert r.BN in conv.WGMMA_N and r.route == conv_im2col.WGMMA
    with pytest.raises(ValueError, match="channels"):
        conv.wgmma_plan(4, 8, 2, 129, 8, [0], [0])


# the conv shapes of NCSNv2Deeper and NCSNv2 that NCSNv2-Deepest lacks, and
# of one LDAMP denoiser (tests/test_torch_cuda.py OTHER_ARCH_CONVS,
# UNET_CONVS), as (H, W, Cin, Cout, k, d)
OTHER_ARCH_CONVS = [
    (16, 4, 64, 64, 3, 2), (16, 4, 64, 128, 3, 2), (16, 4, 128, 64, 3, 1),
    (16, 4, 128, 128, 3, 1), (16, 4, 128, 128, 3, 2), (16, 4, 128, 128, 3, 4),
    (32, 8, 64, 64, 3, 2), (32, 8, 64, 64, 3, 4)]
UNET_CONVS = [
    (64, 16, 2, 16, 3, 1), (64, 16, 16, 16, 3, 1), (32, 8, 16, 32, 3, 1),
    (32, 8, 32, 32, 3, 1), (16, 4, 32, 64, 3, 1), (16, 4, 64, 64, 3, 1),
    (8, 2, 64, 128, 3, 1), (8, 2, 128, 128, 3, 1), (16, 4, 128, 64, 3, 1),
    (32, 8, 64, 32, 3, 1), (64, 16, 32, 16, 3, 1), (64, 16, 16, 2, 1, 1)]


def _f32_plan(B, H, W, Cin, Cout, k, d):
    taps = conv.live_taps(k, d, H, W)
    return conv.plan(B, H, W, Cin, Cout, [t[2] for t in taps],
                     [t[3] for t in taps]), taps


def _f32_block(p, H, B, Cout, blk):
    """(rank, b0, h0, n0) of block blk, as csrc conv2d_taps_f32_kernel
    numbers them: rank blk % CL of tile blk // CL, the channel tile
    fastest, then the row tile, then the sample group."""
    tile, ntn, nrt = blk // p.CL, -(-Cout // p.BN), -(-H // p.TH)
    mt = tile // ntn
    return blk % p.CL, (mt // nrt) * p.SB, (mt % nrt) * p.TH, \
        (tile % ntn) * p.BN


def _f32_chunks(p, rank):
    """The chunks of the K loop that block `rank` of a cluster takes."""
    return range(rank * p.nchunks // p.CL, (rank + 1) * p.nchunks // p.CL)


def _f32_threads(p):
    """[(pixels, channels)] of each thread of a block: the csrc kernel's
    lane layout (WN = BN / 4 lanes along the channels, 4 each; the other
    32 / WN along the pixels, 8 each, 32 / WN apart)."""
    WN = p.BN // 4
    WM = 32 // WN
    out = []
    for tid in range(p.threads):
        warp, lane = divmod(tid, 32)
        nb, qb = 4 * (lane % WN), warp * 8 * WM + lane // WN
        out.append(([qb + WM * m for m in range(8)],
                    [nb + j for j in range(4)]))
    return out


@pytest.mark.parametrize("B", [1, 3, 32, 256, 384])
@pytest.mark.parametrize("H,W,Cin,Cout,k,d", MAIN_PATH_CONVS
                         + OTHER_ARCH_CONVS + UNET_CONVS)
def test_f32_plan_covers_every_output_and_chunk_once(H, W, Cin, Cout, k, d,
                                                     B):
    """Every f32 launch of the score models and LDAMP's U-Net: the block
    fits the card, its grid is whole clusters, its tiles cover every
    (pixel, output channel) once, its threads every entry of a tile once,
    the ranks of a cluster every (tap, chunk) once; at the training batch
    the grid fills the card's SMs, or the plan says why it cannot."""
    p, taps = _f32_plan(B, H, W, Cin, Cout, k, d)
    assert p.smem <= conv.MAX_SMEM_OPTIN == 232_448
    assert p.threads <= conv.F32_MAX_THREADS and p.threads % 32 == 0
    assert p.BM <= conv.F32_MAX_BM and p.SB * p.TH * W <= p.BM
    assert p.blocks % p.CL == 0 and p.CL in conv.F32_CLUSTERS
    cover = np.zeros((B, H, Cout), np.int32)  # each pixel of a row alike
    for blk in range(0, p.blocks, p.CL):
        _, b0, h0, n0 = _f32_block(p, H, B, Cout, blk)
        cover[b0:b0 + p.SB, h0:h0 + p.TH, n0:n0 + p.BN] += 1
    assert (cover == 1).all()
    entries = np.zeros((p.BM, p.BN), np.int32)
    for pixels, channels in _f32_threads(p):
        entries[np.ix_(pixels, channels)] += 1
    assert (entries == 1).all()
    work = sorted((t, c) for r in range(p.CL) for c in _f32_chunks(p, r)
                  for t in range(len(taps)))
    assert work == [(t, c) for t in range(len(taps))
                    for c in range(p.nchunks)]
    assert all(len(_f32_chunks(p, r)) >= 1 for r in range(p.CL))
    assert p.BK * p.nchunks >= Cin > p.BK * (p.nchunks - 1)
    if B == 32:
        assert p.blocks >= conv.SMS or p.why, p


def _f32_kernel_in_numpy(x, weight, bias, d, elu, p):
    """csrc conv2d_taps_f32_kernel's arithmetic in float64, block by block
    as plan `p` launches it: the halo tile staged from the channels-last
    memory through the block's source-offset table (zero outside the
    image and past Cin), every live tap's weight rows read in place from
    the kernel_layout memory (zero past Cin and Cout), each thread's 8 x TN
    entries of the partial tile, the cluster's partial tiles summed in rank
    order, + bias, ELU, stored to the pixels that lie in the tensor."""
    B, Cin, H, W = x.shape
    Cout, k = weight.shape[0], weight.shape[-1]
    taps = conv.live_taps(k, d, H, W)
    T = len(taps)
    xm = x.permute(0, 2, 3, 1).reshape(-1).numpy()
    wm = weight.permute(2, 3, 1, 0).reshape(-1).numpy()
    TR, TW = p.TH + 2 * p.py, W + 2 * p.px
    HP, P = p.SB * TR * TW, p.SB * p.TH * W
    threads = _f32_threads(p)
    out = np.full(B * H * W * Cout, np.nan)
    for blk0 in range(0, p.blocks, p.CL):
        parts = []
        for blk in range(blk0, blk0 + p.CL):
            rank, b0, h0, n0 = _f32_block(p, H, B, Cout, blk)
            hp = np.arange(HP)
            sb, r, c = hp // (TR * TW), hp % (TR * TW) // TW, hp % TW
            b, h, wc = b0 + sb, h0 - p.py + r, c - p.px
            ok = (b < B) & (h >= 0) & (h < H) & (wc >= 0) & (wc < W)
            gofs = np.where(ok, ((b * H + h) * W + wc) * Cin, -1)
            q = np.minimum(np.arange(p.BM), P - 1)
            sq, rq = q // (p.TH * W), q % (p.TH * W)
            hoff = (sq * TR + rq // W + p.py) * TW + rq % W + p.px
            acc = np.zeros((p.BM, p.BN))
            for ch in _f32_chunks(p, rank):
                c0 = ch * p.BK
                cc = c0 + np.arange(p.BK)
                halo = np.zeros((HP, p.BK))
                src = gofs[:, None] + cc[None, :]
                live = (gofs[:, None] >= 0) & (cc[None, :] < Cin)
                halo[live] = xm[src[live]]
                n = n0 + np.arange(p.BN)
                for t, (iy, ix, ty, tx) in enumerate(taps):
                    ws = np.zeros((p.BK, p.BN))
                    row = (iy * k + ix) * Cin + cc
                    wl = (cc[:, None] < Cin) & (n[None, :] < Cout)
                    ws[wl] = wm[(row[:, None] * Cout + n[None, :])[wl]]
                    acc += halo[hoff + ty * TW + tx] @ ws
            part = np.full((p.BM, p.BN), np.nan)
            for pixels, channels in threads:
                part[np.ix_(pixels, channels)] = acc[np.ix_(pixels,
                                                            channels)]
            parts.append(part)
        tile = 0.0
        for part in parts:  # rank order
            tile = tile + part
        if bias is not None:
            tile = tile + np.pad(bias.numpy(), (0, p.BN))[n0:n0 + p.BN]
        if elu:
            tile = np.where(tile > 0, tile, np.expm1(tile))
        for q in range(P):
            b = b0 + q // (p.TH * W)
            h = h0 + q % (p.TH * W) // W
            if b < B and h < H:
                o = ((b * H + h) * W + q % W) * Cout
                nn = min(p.BN, Cout - n0)
                out[o + n0:o + n0 + nn] = tile[q, :nn]
    return torch.from_numpy(out.reshape(B, H, W, Cout)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("B,H,W,Cin,Cout,k,d,bias,elu,forced", [
    (3, 8, 2, 24, 20, 3, 1, True, True, {}),          # 2 channel tiles
    (3, 8, 2, 24, 20, 3, 1, True, False, dict(CL=2)),  # ragged K split
    (2, 8, 2, 32, 16, 3, 4, False, False, dict(CL=4)),  # 3 live taps
    (5, 16, 4, 2, 8, 3, 1, True, True, {}),           # Cin 2: 4-byte copies
    (3, 12, 5, 5, 3, 3, 2, True, False, {}),          # odd counts, ragged
    (2, 6, 4, 8, 6, 1, 1, True, False, dict(BK=4, CL=2)),  # k = 1
    (4, 8, 2, 16, 32, 3, 2, False, True,
     dict(SB=3, BM=64, threads=64)),                  # a ragged sample group
    (2, 16, 4, 8, 8, 3, 1, True, True, dict(TH=6)),   # ragged row tiles
])
def test_f32_plan_walked_in_numpy_reproduces_pruned_conv(B, H, W, Cin, Cout,
                                                         k, d, bias, elu,
                                                         forced):
    """The plan's tiles, halos, thread tiles and K splits, walked in numpy
    (float64) as the kernel walks them, give `pruned_conv`: wrong offsets
    show here before the card runs the kernel."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(B, Cin, H, W, generator=g, dtype=torch.float64)
    w = conv.kernel_layout(torch.randn(Cout, Cin, k, k, generator=g,
                                       dtype=torch.float64))
    b = torch.randn(Cout, generator=g, dtype=torch.float64) if bias else None
    p, _ = _f32_plan(B, H, W, Cin, Cout, k, d)
    if forced:
        p = dataclasses.replace(p, **forced)
        p = dataclasses.replace(p, nchunks=-(-Cin // p.BK), tiles=(
            -(-H // p.TH), -(-B // p.SB), p.tiles[2]))
        assert p.CL <= p.nchunks and p.SB * p.TH * W <= p.BM
    got = _f32_kernel_in_numpy(x, w, b, d, elu, p)
    want = conv.pruned_conv(x, w, b, d, elu)
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


# the five norm shapes of one NCSNv2-Deepest forward (H, W, C)
MAIN_PATH_NORMS = [(64, 16, 32), (32, 8, 64), (16, 4, 64), (8, 2, 64),
                   (8, 2, 128)]


@pytest.mark.parametrize("B", [256, 257, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,C", MAIN_PATH_NORMS)
def test_norm_plan_fits_the_card(H, W, C, dtype, B):
    p = instance_norm.plan(B, H, W, C, dtype)
    es = 2 if dtype == torch.bfloat16 else 4
    ts = p.threads
    nvec = H * W * C // 8  # 8-channel vectors of a sample
    assert (p.vec, p.cluster, p.pixels_per_block) == (8, 1, H * W)
    assert ts % 32 == 0 and ts >= C // 8 and p.blocks == B  # a block a sample
    if nvec <= instance_norm.REG_VECS * instance_norm.MAX_REG_THREADS:
        # 16x4 and 8x2: each thread's vectors in registers, 16-byte
        # loads and stores, no shared copy
        assert p.copy == "vector" and p.chunks == 1
        assert ts <= instance_norm.MAX_REG_THREADS
        G = ts // (1 << (C // 8 - 1).bit_length())
        assert -(-H * W // G) <= instance_norm.REG_VECS
        assert p.smem == instance_norm.smem_bytes(ts, H * W, C, 8, es,
                                                  registers=True)
        assert p.smem < 8192
    else:
        # 64x16 and 32x8: in by bulk copies of 16-32 KB
        assert p.copy == "bulk" and ts <= instance_norm.MAX_THREADS
        assert nvec <= ts * instance_norm.VEC_PER_THREAD
        assert p.chunks == min(4, H * W * C * es // 16384)
        assert p.smem == instance_norm.smem_bytes(ts, H * W, C, 8, es)
        assert H * W * C * es < p.smem <= instance_norm.MAX_SMEM
    if (H, W) == (64, 16) and dtype == torch.bfloat16:
        assert 3 * p.smem <= instance_norm.MAX_SMEM  # three blocks an SM
    if (H, W) == (8, 2):
        # a short block a sample, REG_TARGET vectors a thread
        assert ts == nvec // instance_norm.REG_TARGET
    assert instance_norm.plan(B, H, W, C, dtype) is p  # made once


@pytest.mark.parametrize("C", [2, 3, 7, 12, 24, 100, 128])
def test_norm_plan_takes_every_channel_count(C):
    for H, W in ((64, 16), (8, 2), (5, 3), (1, 1)):
        for dtype, es in ((torch.float32, 4), (torch.bfloat16, 2)):
            p = instance_norm.plan(3, H, W, C, dtype)
            assert p.vec == (8 if C % 8 == 0 else 1)
            whole = H * W * C * es % 16 == 0
            assert p.copy in (("bulk", "vector") if whole and C % 8 == 0
                              else ("bulk",) if whole else ("element",))
            cvp = 1 << (C // p.vec - 1).bit_length()
            assert p.threads % cvp == 0
            assert p.smem <= instance_norm.MAX_SMEM


@pytest.mark.parametrize("H,W,C,dtype,cluster,copy", [
    (64, 16, 128, torch.float32, 4, "bulk"),     # 512 KB a sample
    (64, 16, 128, torch.bfloat16, 2, "bulk"),
    (64, 16, 64, torch.float32, 2, "bulk"),      # 256 KB
    (100, 100, 12, torch.bfloat16, 2, "bulk"),   # one channel a thread
    (99, 101, 12, torch.bfloat16, 2, "element"),  # 239,976 B: ragged halves
    (128, 32, 64, torch.float32, 8, "bulk")])    # 1 MB
def test_norm_cluster_plans_split_a_sample(H, W, C, dtype, cluster, copy):
    """A sample too large for one block's shared memory goes to the
    smallest cluster whose blocks fit; the blocks cover its pixels, 16-byte
    aligned, each with at least one pixel."""
    p = instance_norm.plan(3, H, W, C, dtype)
    es = 2 if dtype == torch.bfloat16 else 4
    hwc = p.pixels_per_block
    assert (p.cluster, p.copy) == (cluster, copy) and p.blocks == 3 * cluster
    assert (cluster - 1) * hwc < H * W <= cluster * hwc
    assert hwc * C * es % 16 == 0
    assert p.smem <= instance_norm.MAX_SMEM
    smaller = cluster // 2
    assert instance_norm.smem_bytes(
        p.threads, -(-H * W // smaller), C, p.vec, es) > instance_norm.MAX_SMEM


def test_norm_plan_refuses_what_the_kernel_does_not_take():
    for C in (1, 129):
        with pytest.raises(ValueError, match="channels"):
            instance_norm.plan(2, 8, 2, C, torch.float32)
    with pytest.raises(TypeError):
        instance_norm.plan(2, 8, 2, 8, torch.float16)
    with pytest.raises(ValueError, match="fit"):  # 32 MB a sample
        instance_norm.plan(2, 256, 256, 128, torch.float32)
    # 180 B a sample: no 16-byte pieces, element copies
    assert instance_norm.plan(2, 5, 3, 3, torch.float32).copy == "element"
    # a register-route sample of one channel group: the fewest threads
    p = instance_norm.plan(2, 8, 2, 8, torch.bfloat16)
    assert (p.copy, p.threads, p.chunks) == ("vector", 32, 1)


def test_wrappers_count_and_refuse_other_devices():
    reset_counts()
    x = torch.randn(2, 8, 8, 2).contiguous(memory_format=torch.channels_last)
    conv.conv2d(x, torch.randn(4, 8, 3, 3))
    ones = torch.ones(8)
    instance_norm.instance_norm_plus(x, ones, ones, ones, elu=True)
    c = counts()
    assert c["conv2d_taps"] == {"launches": 0, "plain": 1}
    assert c["instance_norm_plus"] == {"launches": 0, "plain": 1}
    with pytest.raises(RuntimeError, match="no kernel"):
        conv.conv2d(x.to("meta"), torch.randn(4, 8, 3, 3, device="meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        instance_norm.instance_norm_plus(x.to("meta"), *[ones.to("meta")] * 3)
