"""The wide f32 route of conv2d_taps (forward and input gradient), the
two-pass norm under grad, and one captured training step of
NCSNv2-Deepest at its published FFHQ widths (ngf 128, 256x256x3, f32,
TF32 off) on the card, against their plain PyTorch versions. Skipped
without a card; on the card, run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_f32_wide.py
"""

import dataclasses

import pytest
import torch

from perfbench import work
from score_based_channels_torch import _graph
from score_based_channels_torch.kernels import (
    conv, counts, grad_counts, instance_norm, reset_counts,
)

pytestmark = pytest.mark.cuda

FWD = work.table("ncsnv2_deepest_ffhq256")["convs"]  # (H, W, Cin, Cout, k,
# d, bias, per forward) of every forward conv shape of the FFHQ model


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _case(card, B, H, W, Cin, Cout, k, bias, seed=0):
    g = torch.Generator(device=card).manual_seed(seed + H * Cin + Cout)
    x = torch.randn(B, Cin, H, W, generator=g, device=card).contiguous(
        memory_format=torch.channels_last)
    w = conv.kernel_layout(torch.randn(Cout, Cin, k, k, generator=g,
                                       device=card) / (k * k * Cin) ** 0.5)
    b = torch.randn(Cout, generator=g, device=card) if bias else None
    return x, w, b


def _err(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("B", [2, 16])
@pytest.mark.parametrize("H,W,Cin,Cout,k,d,bias", [r[:7] for r in FWD],
                         ids=lambda v: str(v))
def test_f32_wide_forward_and_dgrad_match_plain(card, H, W, Cin, Cout, k, d,
                                                bias, B):
    """Batch 2 and 16 (the FFHQ training cell's, whose plans differ), f32:
    the forward (with ELU, as the blocks fuse it) and, through the conv's
    autograd Function, the input gradient against `conv2d_plain` and
    autograd through it (cuDNN, TF32 off), within 1e-5 of max|plain|; each
    launch counted on its route, forward and dgrad apart."""
    x, w, b = _case(card, B, H, W, Cin, Cout, k, bias)
    gout = torch.randn(B, Cout, H, W, device=card).contiguous(
        memory_format=torch.channels_last)
    xa, xb = (x.clone().requires_grad_() for _ in range(2))
    reset_counts()
    got = conv.conv2d(xa, w, b, d, True)
    want = conv.conv2d_plain(xb, w, b, d, True)
    got.backward(gout)
    want.backward(gout)
    torch.cuda.synchronize()
    assert _err(got, want) <= 1e-5
    assert _err(xa.grad, xb.grad) <= 1e-5
    n = counts()
    assert n["conv2d_taps"] == {"launches": 2, "plain": 1}
    assert n["conv2d_taps.f32_wide"]["launches"] == int(
        conv.takes_wide(W, Cin, Cout))
    assert n["conv2d_taps.f32_wide.dgrad"]["launches"] == int(
        conv.takes_wide(W, Cout, Cin))
    assert grad_counts()["conv2d_taps"] == {"functions": 1, "dgrad": 1}


@pytest.mark.parametrize("H,W,Cin,Cout,k,d,forced", [
    (256, 256, 128, 256, 1, 1, dict(CL=2)),
    (32, 32, 512, 512, 3, 4, {}),
    (32, 32, 512, 512, 3, 4, dict(CL=4)),
    (128, 128, 256, 128, 3, 1, dict(WS=64)),
    (256, 256, 3, 128, 3, 1, {}),      # Cin 3: 4-byte copies of x
    (256, 256, 128, 3, 3, 1, {}),      # Cout 3: BN 4, 4-byte weight copies
    (64, 64, 256, 256, 3, 1, dict(WS=32, BK=8, stages=3)),
    (256, 256, 256, 128, 3, 1, dict(WS=256, BM=256)),
])
def test_f32_wide_launches_give_equal_bits(card, H, W, Cin, Cout, k, d,
                                           forced):
    """No atomics: two launches of a plan (forced tile columns, chunks,
    stages or a cluster split too) give the same bits, within 1e-5 of
    max|plain|."""
    taps = conv.live_taps(k, d, H, W)
    dy, dx = [t[2] for t in taps], [t[3] for t in taps]
    p = conv.plan(2, H, W, Cin, Cout, dy, dx)
    if forced:
        o = dict(dataclasses.asdict(p), **forced)
        p = conv.f32_config(2, H, W, Cin, Cout, dy, dx, o["BN"], o["BM"],
                            o["BK"], o["CL"], forced.get("stages"),
                            WS=o["WS"])
        assert p is not None
    x, w, b = _case(card, 2, H, W, Cin, Cout, k, True, seed=4)
    first = conv._launch(x, w, b, d, True, p)
    assert torch.equal(first, conv._launch(x, w, b, d, True, p))
    assert _err(first, conv.conv2d_plain(x, w, b, d, True)) <= 1e-5


@pytest.mark.parametrize("elu", [False, True])
@pytest.mark.parametrize("H,W,C", [(256, 256, 128), (128, 128, 256),
                                   (64, 64, 256), (32, 32, 256),
                                   (32, 32, 512)])
def test_two_pass_norm_under_grad_matches_plain_autograd(card, H, W, C, elu):
    """The norm Function on the two-pass route (its forward kernel, the
    closed-form backward in torch ops), f32, batch 2, against autograd
    through the plain version: each gradient within 1e-4 of its max|plain|
    and 1e-5 norm-wise (the statistics sum 1,024 to 65,536 pixels a
    channel, up to 64 times the one-pass route's 64x16 samples)."""
    g = torch.Generator(device=card).manual_seed(C + H)
    x = (torch.randn(2, C, H, W, generator=g, device=card) * 2 + 0.5
         ).contiguous(memory_format=torch.channels_last)
    params = [torch.randn(C, generator=g, device=card) * 0.1 + 1
              for _ in range(3)]
    assert isinstance(instance_norm.launch_plan(2, H, W, C, torch.float32),
                      instance_norm.TwoPassPlan)
    leaves = [t.clone().requires_grad_() for t in [x] + params]
    ref = [t.clone().requires_grad_() for t in [x] + params]
    gout = torch.randn(x.shape, generator=g, device=card)
    reset_counts()
    instance_norm.instance_norm_plus(*leaves, elu=elu).backward(gout)
    instance_norm.instance_norm_plus_plain(*ref, elu=elu).backward(gout)
    assert grad_counts()["instance_norm_plus"] == {"functions": 1,
                                                   "backward": 1}
    assert counts()["instance_norm_plus.two_pass"] == {"launches": 1}
    for p, q in zip(leaves, ref):
        assert _err(p.grad, q.grad) <= 1e-4
        assert float((p.grad - q.grad).norm() / q.grad.norm()) <= 1e-5


def _ffhq_state(card, seed):
    from perfbench.drivers.train_images import port_config
    from perfbench.harness import load_json
    from score_based_channels_torch.diffusion.ema import ema_init
    from score_based_channels_torch.models.ncsnv2 import NCSNv2Deepest
    from score_based_channels_torch.train.score import (
        ScoreTrainer, ScoreTrainState, make_optimizer)

    cell = load_json("workloads", "ffhq256.train.f32")
    cfg = port_config(load_json("configs", cell["config"]), 3)
    model = NCSNv2Deepest(cfg.model, 3)
    model.init_parameters(torch.Generator().manual_seed(seed))
    model = model.to(card)
    state = ScoreTrainState(model=model, ema=ema_init(model),
                            opt=make_optimizer(model, cfg.optim), step=0)
    return ScoreTrainer(cfg, device=card), state


def test_ffhq_training_step_captured_counts_its_routes(card):
    """Three DSM steps of NCSNv2-Deepest at ngf 128 on 256x256x3 at batch 2
    through `TrainChunkRunner` (step 0 eager, step 1 captured, step 2
    replayed): per step 113 conv forwards and 112 dgrads on the kernels,
    the wide f32 route's share of each by the shape table, 25 two-pass
    norms, no plain call; the losses within 1e-4 of the same steps run
    eagerly."""
    from perfbench import work
    from score_based_channels_torch.train.score import TrainChunkRunner

    x_all = torch.rand(4, 256, 256, 3, device=card,
                       generator=torch.Generator(device=card).manual_seed(1))
    idx = torch.tensor([[0, 1], [2, 3], [1, 2]])
    losses = []
    for eager in (False, True):
        trainer, state = _ffhq_state(card, 3)
        runner = TrainChunkRunner(trainer.update, state, x_all, 2, 3,
                                  torch.Generator(device=card), 10)
        reset_counts()
        if eager:
            with _graph.eager():
                losses.append(runner.run(idx, [11, 12, 13]).clone())
            continue
        losses.append(runner.run(idx, [11, 12, 13]).clone())
        assert runner.replayer.cap is not None
        n = counts()
        table = work.table("ncsnv2_deepest_ffhq256")
        first = tuple(table["convs_first"][:6])
        wide_f = sum(r[7] for r in table["convs"]
                     if conv.takes_wide(r[1], r[2], r[3]))
        wide_d = sum(r[7] - (tuple(r[:6]) == first) for r in table["convs"]
                     if conv.takes_wide(r[1], r[3], r[2]))
        assert n["conv2d_taps"] == {"launches": 3 * 225, "plain": 0}
        assert n["conv2d_taps.f32_wide"] == {"launches": 3 * wide_f}
        assert n["conv2d_taps.f32_wide.dgrad"] == {"launches": 3 * wide_d}
        assert n["instance_norm_plus"] == {"launches": 3 * 25, "plain": 0}
        assert n["instance_norm_plus.two_pass"] == {"launches": 3 * 25}
        assert grad_counts()["conv2d_taps"] == {"functions": 3 * 113,
                                                "dgrad": 3 * 112}
        del runner, state, trainer
    got, want = losses
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
