"""The benchmark's shape tables against a census of the port's models,
and its operation and byte counts against hand counts."""

import collections

import pytest
import torch

from perfbench import work


def census(run):
    """Conv and norm launches of run() on the port's CPU path, by shape."""
    from score_based_channels_torch.kernels import conv, instance_norm
    from score_based_channels_torch.models import layers

    convs, norms = collections.Counter(), collections.Counter()
    first = []
    c0, n0 = conv.conv2d, instance_norm.instance_norm_plus

    def c(x, w, b=None, d=1, elu=False):
        key = (x.shape[2], x.shape[3], x.shape[1], w.shape[0], w.shape[-1],
               d, int(b is not None))
        first.append(key)
        convs[key] += 1
        return c0(x, w, b, d, elu)

    def n(x, a, g, b, elu=False):
        norms[(x.shape[2], x.shape[3], x.shape[1])] += 1
        return n0(x, a, g, b, elu)

    mp = pytest.MonkeyPatch()
    mp.setattr(layers.conv_kernel, "conv2d", c)
    mp.setattr(layers.norm_kernel, "instance_norm_plus", n)
    try:
        with torch.no_grad():
            run()
    finally:
        mp.undo()
    return convs, norms, first[0]


def test_ncsnv2_deepest_table():
    from score_based_channels_torch.config import default_score_config
    from score_based_channels_torch.models.ncsnv2 import NCSNv2Deepest

    m = NCSNv2Deepest(default_score_config().model, 2)
    convs, norms, first = census(
        lambda: m(torch.randn(3, 64, 16, 2), torch.tensor(1.0)))
    t = work.table("ncsnv2_deepest")
    assert {tuple(r[:7]): r[7] for r in t["convs"]} == dict(convs)
    assert {tuple(r[:3]): r[3] for r in t["norms"]} == dict(norms)
    assert tuple(t["convs_first"]) == first
    assert sum(convs.values()) == 113 and sum(norms.values()) == 25
    assert sum(p.numel() for p in m.parameters()) == 5_890_082


def test_ldamp_unet_table():
    from score_based_channels_torch.train.ldamp import (
        LDAMPTrainConfig, make_ldamp_model)

    m = make_ldamp_model(LDAMPTrainConfig(), "cpu")
    convs, norms, first = census(
        lambda: m.denoiser_0(torch.randn(3, 64, 16, 2)))
    t = work.table("ldamp_unet")
    assert {tuple(r[:7]): r[7] for r in t["convs"]} == dict(convs)
    assert tuple(t["convs_first"]) == first and not norms
    tconvs = [(mod.tconv.weight.shape[0], mod.tconv.weight.shape[1])
              for name, mod in m.denoiser_0.unet.named_children()
              if name.startswith("up_t_")]
    assert [(r[2], r[3]) for r in t["tconvs"]] == tconvs
    assert sum(p.numel() for p in m.parameters()) == 4_810_900


def test_conv_counts_by_hand():
    # 64x16, 32 -> 32, 3x3, bias: 9 live taps
    c = work.Conv(64, 16, 32, 32, 3, 1, True)
    assert work.conv_flops(2, c) == 2 * 2 * 1024 * 9 * 32 * 32
    assert work.conv_bytes(2, c, 2) == (2 * 1024 * 64 + 9 * 1024 + 32) * 2
    # 8x2, 128 -> 128, dilation 4: only the middle column and row live
    d = work.Conv(8, 2, 128, 128, 3, 4, False)
    assert work.live_taps(3, 4, 8, 2) == 3
    assert work.conv_flops(1, d) == 2 * 16 * 3 * 128 * 128
    assert work.conv_bytes(1, d, 4) == (16 * 256 + 3 * 128 * 128) * 4


def test_norm_bytes_by_hand():
    assert work.norm_bytes(256, 64, 16, 32, 2) == (2 * 256 * 1024 * 32
                                                  + 96) * 2


def test_launch_counts_of_a_step():
    """What the port's runners record a step: 113 convs a forward; a DSM
    step 113 forward + 112 input-gradient convs; an LDAMP step 300
    forwards and 149 input gradients (PERF.md's launch counts)."""
    assert work.counts({"model": "ncsnv2_deepest",
                        "forward": {256: 1}})["conv"] == 113
    assert work.counts({"model": "ncsnv2_deepest",
                        "train": {32: 1}}) == {"conv": 225, "norm": 25}
    assert work.counts({"model": "ldamp_unet", "unrolled": {128: 1},
                        "unrolls": 10})["conv"] == 449
