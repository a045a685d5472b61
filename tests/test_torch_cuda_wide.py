"""The wide bf16 route of conv2d_taps and the two-pass route of
instance_norm_plus on the card, at the shapes of NCSNv2-Deepest at its
published FFHQ widths (ngf 128, 256x256x3), against their plain PyTorch
versions. Skipped without a card; on the card, run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_wide.py
"""

import dataclasses

import pytest
import torch

from score_based_channels_torch.kernels import (
    conv, counts, instance_norm, reset_counts,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.parametrize("H,W,Cin,Cout,k,d,bias,elu", [
    (256, 256, 128, 128, 3, 1, True, False),
    (256, 256, 128, 128, 3, 1, False, True),
    (256, 256, 3, 128, 3, 1, True, False),     # the begin conv
    (256, 256, 128, 3, 3, 1, True, False),     # the end conv: N = 8
    (256, 256, 128, 256, 1, 1, True, False),   # the shortcut, 1x1
    (128, 128, 256, 256, 3, 1, False, True),
    (128, 128, 256, 128, 3, 1, True, False),
    (64, 64, 256, 256, 3, 1, True, False),
    (32, 32, 256, 512, 3, 2, True, False),
    (32, 32, 512, 512, 3, 4, True, False),
    (32, 32, 512, 256, 3, 1, True, True),
])
def test_wide_conv_matches_plain(card, H, W, Cin, Cout, k, d, bias, elu):
    """bf16 in and out, f32 accumulation, one rounding: the kernel against
    `conv2d_plain` on the same card tensors within bf16's rounding; two
    launches give equal bits; the launch is counted on the wide route."""
    g = torch.Generator(device=card).manual_seed(H * Cin + Cout + d)
    B = 8
    x = torch.randn(B, Cin, H, W, generator=g, device=card).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w = conv.kernel_layout((torch.randn(Cout, Cin, k, k, generator=g,
                                        device=card) / (Cin * k * k) ** 0.5
                            ).to(torch.bfloat16))
    b = (torch.randn(Cout, generator=g, device=card) if bias else None)
    assert conv.takes_wide(W, Cin, Cout)
    reset_counts()
    got = conv.conv2d(x, w, b, d, elu)
    again = conv.conv2d(x, w, b, d, elu)
    assert counts()["conv2d_taps.wide"] == {"launches": 2}
    assert counts()["conv2d_taps"] == {"launches": 2, "plain": 0}
    want = conv.conv2d_plain(x, w, b, d, elu)
    assert torch.equal(got, again)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert _rel(got, want) < 8e-3, _rel(got, want)


@pytest.mark.parametrize("nwg,KS,stages", [(2, 4, 4), (2, 2, 8), (4, 2, 8),
                                           (4, 1, 6), (4, 4, 3)])
@pytest.mark.parametrize("H,W,Cin,Cout,d", [(256, 256, 128, 128, 1),
                                            (32, 32, 512, 256, 4),
                                            (64, 64, 136, 72, 1)])
def test_wide_conv_every_tile_form(card, H, W, Cin, Cout, d, nwg, KS,
                                   stages):
    """The wide kernel launched with two or four warpgroups, chunks of 16,
    32 or 64 input channels and 3-8 weight stages (plans made by
    `wide_plan` with those choices) gives the plain version's output
    within bf16's rounding, partial chunks and channel tiles included."""
    g = torch.Generator(device=card).manual_seed(7)
    B = 3
    x = torch.randn(B, Cin, H, W, generator=g, device=card).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w = conv.kernel_layout((torch.randn(Cout, Cin, 3, 3, generator=g,
                                        device=card) / (9 * Cin) ** 0.5
                            ).to(torch.bfloat16))
    b = torch.randn(Cout, generator=g, device=card)
    taps = conv.live_taps(3, d, H, W)
    p = conv.wide_plan(B, H, W, Cin, Cout, [t[2] for t in taps],
                       [t[3] for t in taps], nwg=nwg, KS=KS, stages=stages)
    got = conv._launch(x, w, b, d, True, p)
    want = conv.conv2d_plain(x, w, b, d, True)
    assert _rel(got, want) < 8e-3, _rel(got, want)


def test_wide_conv_takes_a_resident_shape(card):
    """A shape of the resident route launched through the wide kernel (a
    plan made by `wide_plan`) gives what the resident route gives, within
    bf16's rounding: the two routes compute one function."""
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(4, 64, 64, 16, generator=g, device=card).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w = conv.kernel_layout((torch.randn(64, 64, 3, 3, generator=g,
                                        device=card) / 24).to(torch.bfloat16))
    taps = conv.live_taps(3, 1, 64, 16)
    p = conv.wide_plan(4, 64, 16, 64, 64, [t[2] for t in taps],
                       [t[3] for t in taps])
    got = conv._launch(x, w, None, 1, False, p)
    want = conv.conv2d(x, w, None, 1, False)
    assert _rel(got, want) < 8e-3


def test_wide_route_refuses_f32_and_dgrad(card):
    """The f32 route and the input gradient take 256 channels on the f32
    wide route (forward and dgrad counted apart) and, like the bf16 wide
    route, refuse more than 512."""
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(1, 256, 8, 8, generator=g, device=card).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    w = conv.kernel_layout(torch.randn(256, 256, 3, 3, generator=g,
                                       device=card))
    reset_counts()
    conv.conv2d(x, w).sum().backward()
    n = counts()
    assert n["conv2d_taps.f32_wide"] == {"launches": 1}
    assert n["conv2d_taps.f32_wide.dgrad"] == {"launches": 1}
    big = torch.randn(1, 520, 8, 8, generator=g, device=card).contiguous(
        memory_format=torch.channels_last)
    wb = conv.kernel_layout(torch.randn(520, 520, 3, 3, generator=g,
                                        device=card))
    with pytest.raises(ValueError, match="float32 route"):
        conv.conv2d(big, wb)
    xb = big.to(torch.bfloat16).requires_grad_(True)
    with pytest.raises(ValueError, match="channels"):
        conv.conv2d(xb, wb.to(torch.bfloat16))


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 8e-3),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("H,W,C,elu", [(256, 256, 128, True),
                                       (128, 128, 256, False),
                                       (32, 32, 512, True),
                                       (64, 16, 136, False)])
def test_two_pass_norm_matches_plain(card, H, W, C, elu, dtype, tol):
    """Statistics in f32 over many blocks, combined in a fixed order: the
    route against `instance_norm_plus_plain` on the same card tensors
    (bf16: one rounding of the output); two launches give equal bits."""
    g = torch.Generator(device=card).manual_seed(C + H)
    B = 3
    x = (torch.randn(B, C, H, W, generator=g, device=card) * 2.0
         + torch.randn(1, C, 1, 1, generator=g, device=card)).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    a, gm, bt = (torch.randn(C, generator=g, device=card).to(dtype)
                 for _ in range(3))
    p = instance_norm.launch_plan(B, H, W, C, dtype)
    assert isinstance(p, instance_norm.TwoPassPlan)
    reset_counts()
    got = instance_norm.instance_norm_plus(x, a, gm, bt, elu)
    again = instance_norm.instance_norm_plus(x, a, gm, bt, elu)
    assert counts()["instance_norm_plus.two_pass"] == {"launches": 2}
    want = instance_norm.instance_norm_plus_plain(x, a, gm, bt, elu)
    assert torch.equal(got, again)
    assert _rel(got, want) < tol, _rel(got, want)


def test_ffhq_forward_on_the_card(card):
    """The port's NCSNv2-Deepest at ngf 128 on one 256x256x3 image, bf16
    network: 113 conv and 25 norm launches, all of them on the wide and
    two-pass routes, and the output within bf16's
    rounding of the f32 forward of the same weights through the plain
    versions on the card."""
    from score_based_channels_torch.config import ModelConfig
    from score_based_channels_torch.eval.estimate import score_fn_from_params
    from score_based_channels_torch.models.ncsnv2 import NCSNv2Deepest

    m = NCSNv2Deepest(dataclasses.replace(ModelConfig(), ngf=128), 3)
    m.init_parameters(torch.Generator().manual_seed(0))
    m = m.to(card)
    x = torch.rand(1, 256, 256, 3, device=card)
    s = torch.tensor(5.0, device=card)
    reset_counts()
    got = score_fn_from_params(m, torch.bfloat16)(x, s)
    n = counts()
    assert n["conv2d_taps"] == {"launches": 113, "plain": 0}
    assert n["instance_norm_plus"] == {"launches": 25, "plain": 0}
    assert n["conv2d_taps.wide"] == {"launches": 113}
    assert n["instance_norm_plus.two_pass"] == {"launches": 25}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(conv, "conv2d", conv.conv2d_plain)
        mp.setattr(instance_norm, "instance_norm_plus",
                   instance_norm.instance_norm_plus_plain)
        from score_based_channels_torch.models import layers
        mp.setattr(layers.conv_kernel, "conv2d", conv.conv2d_plain)
        mp.setattr(layers.norm_kernel, "instance_norm_plus",
                   instance_norm.instance_norm_plus_plain)
        with torch.no_grad():
            want = m(x, s)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _rel(got, want) < 5e-2, _rel(got, want)
