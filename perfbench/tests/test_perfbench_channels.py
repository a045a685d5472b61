"""The benchmark's own channel generator (a frozen copy of the CDL-C
generator) gives the port's channels bit for bit, and the port reads the
channel file the benchmark writes as the same channels, normalised as the
reference normalises them."""

import dataclasses

import numpy as np

from perfbench import channels
from perfbench.drivers import common


def test_frozen_generator_gives_the_ports_channels():
    from score_based_channels_torch.data.cdl import generate_cdl_channels

    for seed in (3, 2**31 - 5):
        ours = channels.cdl_c(seed, 6)
        port = generate_cdl_channels(seed, "CDL-C", 6)[:, 0]
        assert ours.dtype == np.complex64 and ours.shape == (6, 16, 64)
        assert np.array_equal(ours, port)


def test_the_port_reads_the_file_as_the_same_channels():
    from perfbench import harness

    cfg = common.port_config(harness.load_json("configs",
                                               "ncsnv2-deepest.cdl-c.64x16"))
    raw = channels.cdl_c(11, 5)
    train = common.program_dataset(raw, cfg.data, 7, "global")
    assert np.array_equal(train.channels, raw)
    assert (train.mean, train.std) == channels.global_norm(raw)
    val = common.program_dataset(raw[:2], dataclasses.replace(cfg.data),
                                 8, list(train.norm_stats), 38)
    x = common.hermitian_c2(raw[:2], raw)
    assert np.array_equal(val.network_input().numpy(), x.numpy())
