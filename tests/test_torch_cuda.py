"""The port's CUDA kernels and main path on the card, against their plain
PyTorch versions. Skipped without a card; on the card, run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest: tests/conftest.py sets up JAX, which the card's machine
need not have; this file imports no JAX).
"""

import ctypes

import pytest
import torch

import numpy as np

from score_based_channels_torch.comms.ldpc import make_wifi_ldpc, minsum_decode
from score_based_channels_torch.config import ModelConfig
from score_based_channels_torch.diffusion.sampling import (
    annealed_langevin_posterior_c2,
)
from score_based_channels_torch.diffusion.sigmas import get_sigmas
from score_based_channels_torch.eval.estimate import score_fn_from_params
from score_based_channels_torch.kernels import (
    conv, conv_chain, conv_im2col, counts, instance_norm, ldpc_minsum,
    reset_counts,
)
from score_based_channels_torch.kernels.fused_forward import fused_forward
from score_based_channels_torch.models import make_score_model

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,C", [(64, 16, 32), (32, 8, 64), (8, 2, 128)])
def test_norm_kernel_matches_plain(card, H, W, C, dtype):
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(32, C, H, W, generator=g) * 2 + 0.5).to(
        card, dtype).contiguous(memory_format=torch.channels_last)
    a, gm, bt = (1 + 0.1 * torch.randn(3, C, generator=g)).to(card, dtype)
    got = instance_norm.instance_norm_plus(x, a, gm, bt, elu=True)
    want = instance_norm.instance_norm_plus_plain(x, a, gm, bt, elu=True)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
    else:
        err = (got.float() - want.float()).abs().max()
        assert err <= 2e-2 * want.float().abs().max()


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
@pytest.mark.parametrize("B", [1, 5, 100])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,C,B,n,d", [(8, 2, 128, 256, 4, 1),
                                         (8, 2, 128, 40, 2, 2),
                                         (8, 2, 16, 8, 3, 1),
                                         (8, 2, 64, 300, 2, 1),
                                         (4, 4, 24, 5, 2, 1)])
def test_chain_kernel_matches_plain(card, H, W, C, B, n, d, dtype):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(H * W, B, C, generator=g).to(card, dtype)
    ws = (torch.randn(n, 3, 3, C, C, generator=g) / (9 * C) ** 0.5).to(
        card, dtype)
    bs = (0.1 * torch.randn(n, C, generator=g)).to(card)
    reset_counts()
    got = conv_chain.conv_chain(x, ws, bs, H, W, d)
    want = conv_chain.conv_chain_plain(x, ws, bs, H, W, d)
    assert counts()["conv_chain"] == {"launches": 1, "plain": 1}
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    else:
        err = (got.float() - want.float()).abs().max()
        assert err <= 2e-2 * want.float().abs().max(), float(err)


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
