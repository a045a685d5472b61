"""DSM training of NCSNv2-Deepest on images, the benchmark's FFHQ training
cell (`ffhq256.train.f32`) at a CPU test's size: the blocked reference
(`perfbench/reference/dsm_blocked.py`) against `reference/dsm.py`
unblocked, and the port's `TrainChunkRunner` steps (the cell's own driver,
the eager yardstick `_graph.eager()`) against the blocked reference on
32x32x3 images at an ngf whose widest layers carry more than 128 channels.
"""

import copy
import math

import pytest
import torch

from perfbench import harness
from perfbench.drivers.common import worst_leaf_gap
from perfbench.drivers import train_images
from perfbench.reference import common as rc
from perfbench.reference import dsm, dsm_blocked, ncsnv2
from perfbench.weights import make_weights
from score_based_channels_torch import _graph, kernels

CELL = "ffhq256.train.f32"
SEED = 2 ** 35 + 3


def tiny(ngf=33, size=32):
    """(config, cell) of the FFHQ training cell cut to a CPU test's size:
    ngf 33 (a widest layer of 132 channels), 32x32x3 images, batch 4 in
    reference blocks of 3 and 1, units of 2 steps."""
    cell = copy.deepcopy(harness.load_json("workloads", CELL))
    config = copy.deepcopy(harness.load_json("configs", cell["config"]))
    config["model"]["ngf"] = ngf
    config["data"]["image_size"] = size
    config["training"]["batch_size"] = 4
    cell["traffic"].update(images=8, held_out=4, chunk=2, updates=20,
                           block=3)
    return config, cell


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("block", [1, 3, 4])
def test_blocked_reference_equals_dsm_unblocked(block):
    """Three steps of the blocked reference (the batch in blocks of rows,
    its draws made first) give `dsm.train_steps`' losses, first gradient,
    parameters and EMA to float32 rounding."""
    W = make_weights(ncsnv2.param_specs(8, 3), 5, "cpu")
    g = torch.Generator().manual_seed(1)
    xs = [torch.rand(4, 32, 32, 3, generator=g) for _ in range(3)]
    sig = rc.geometric_sigmas(348.0, (0.01 / 348.0) ** (1 / 2310), 2311)
    gens = lambda: [rc.generator(7, 2, k) for k in range(3)]
    want = dsm.train_steps(W, xs, gens(), sig, 1e-4, 1e-8, 0.999, 8)
    got = dsm_blocked.train_steps(W, xs, gens(), sig, 1e-4, 0.9, 0.999, 1e-8,
                                  0.999, 8, block)
    for a, b in zip(got[0], want[0]):
        assert abs(a - b) <= 1e-5 * abs(b)
    for k in W:
        assert _rel(got[1][k], want[1][k]) <= 1e-4, k
    # the changes over three steps, leaf norms held against the larger of
    # their own and the median leaf's, as the cell compares them (Adam at
    # eps 1e-8 turns a rounding-sized gradient entry into a whole step;
    # the DSM cell reads up to 5e-3 between two float32 programs)
    # the EMA's change is a thousandth of the parameters' and rounds at the
    # ulp of its values: the DSM cell reads up to 6e-3 there, limit 0.1
    for part, tol in ((2, 5e-3), (3, 0.05)):
        change = [{k: r[part][k] - W[k] for k in W} for r in (got, want)]
        assert worst_leaf_gap(*change, list(W)) <= tol, part


def _drive(config, cell):
    drv = train_images.Driver(config, cell, SEED, "cpu")
    with _graph.eager():
        drv.setup()
        work = drv.unit()
    drv.release()
    return drv, work


def test_runner_steps_on_images_match_the_blocked_reference():
    """The cell's driver on the CPU: the port's three first steps through
    `TrainChunkRunner` (eager) and the EMA's loss against the blocked
    reference within the cell's limits (loss, first gradient by its worst
    and lower-quartile leaf, parameter and EMA change); the unit's work is
    the shape table's training steps."""
    config, cell = tiny()
    kernels.reset_counts()
    drv, work = _drive(config, cell)
    assert work["train"] == {4: 2} and work["done"] == 2
    assert work["model"] == "ncsnv2_deepest_ffhq256"
    assert kernels.counts()["conv2d_taps"]["plain"] > 0  # the CPU's path
    r = drv.readings(drv.program(), drv.reference())
    lim = cell["limits"]
    assert set(r) == set(lim)
    for k, v in r.items():
        assert math.isfinite(v) and v <= lim[k] / 10, (k, v)
    assert r["loss_gap"] <= 1e-5
    assert drv.check() and all(v <= lim for _, v, lim in drv.check())
    assert len(drv.losses) == 3 and drv.done == 5


def test_half_batch_fails_the_cells_limits():
    """The planted fault (each loss over half the batch) and the program
    broken the same way both fail the cell's limits."""
    from score_based_channels_torch.train import score

    config, cell = tiny()
    drv, _ = _drive(config, cell)
    ref = drv.reference()
    r = drv.readings(drv.reference(half=True), ref)
    lim = cell["limits"]
    assert any(v > lim[k] for k, v in r.items()), r
    orig = score.anneal_dsm_loss

    def half(model, x, sigmas, gen, labels=None, noise=None,
             anneal_power=2.0, rows=None):
        return orig(model, x, sigmas, gen, labels, noise, anneal_power,
                    rows=slice(0, x.shape[0] // 2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(score, "anneal_dsm_loss", half)
        bad, _ = _drive(config, cell)
    assert not all(math.isfinite(v) and v <= lm for _, v, lm in bad.check())


def test_port_config_takes_the_published_recipe():
    """The port's config of the cell: ngf 128, 3 channels, the FFHQ sigmas
    (348 to 0.01 over 2311, through sigma_begin and the rate), Adam 1e-4
    with eps 1e-8, EMA 0.999, TF32 off, batch 16."""
    from score_based_channels_torch.diffusion.sigmas import sigmas_from_config

    cell = harness.load_json("workloads", CELL)
    config = harness.load_json("configs", cell["config"])
    c = train_images.port_config(config, cell["traffic"]["chunk"])
    assert (c.model.ngf, c.data.channels, c.model.num_classes) == (128, 3,
                                                                   2311)
    s = sigmas_from_config(c.model)
    ref = rc.geometric_sigmas(348.0, train_images.sigma_rate(config["model"]),
                              2311)
    assert torch.equal(s, ref)
    assert abs(float(s[0]) - 348.0) < 1e-4 and abs(float(s[-1]) - 0.01) < 1e-7
    assert (c.optim.lr, c.optim.eps, c.optim.beta1, c.optim.beta2) == (
        1e-4, 1e-8, 0.9, 0.999)
    assert c.model.ema_rate == 0.999 and c.training.anneal_power == 2.0
    assert c.training.batch_size == 16 and c.training.log_every_steps == 4
    assert c.training.matmul_precision == "highest"


def test_smoke_config_is_the_cells_recipe():
    """`chip_smoke.ffhq_train_config`, built from the port's own config
    module for the card's smoke phase, is the cell's `port_config` but for
    its batch and chunk."""
    import dataclasses

    import chip_smoke

    cell = harness.load_json("workloads", CELL)
    want = train_images.port_config(harness.load_json("configs",
                                                      cell["config"]), 3)
    got = chip_smoke.ffhq_train_config(2)
    assert got.training.batch_size == 2
    assert dataclasses.replace(got.model, sigma_rate=0.0) == \
        dataclasses.replace(want.model, sigma_rate=0.0)
    assert got.model.sigma_rate == pytest.approx(want.model.sigma_rate,
                                                 rel=1e-12)
    assert (got.optim, got.data) == (want.optim, want.data)
    assert dataclasses.replace(got.training, batch_size=16,
                               log_every_steps=3) == want.training
