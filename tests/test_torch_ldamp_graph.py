"""LDAMP's training runner (`LDAMPStepRunner`: steps on static buffers,
one captured CUDA graph on the card) and the optimizer's scheduled rate
on the device, on the CPU.

On the CPU the runner calls its step once a step, and the scheduled
learning rate comes from the optimizer's device table: `addcmul` with
the rate's 0-d tensor gives the bits of `add(alpha=-lr)` with the host
float (both one fused multiply-add on the CPU). So `train_ldamp_snr`
through the runner equals the eager loop with the host-float rate that
it replaced, bit for bit, over steps that cross the staircase. Against
the JAX package's `train_ldamp_snr` the bars are test_torch_ldamp.py's:
1e-5 relative on the logs, 1e-4 absolute on the parameters. Tiny LDAMP:
2 unrolls, 4 channels, 1 pool, batch 2-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_based_channels_tpu.config import Config as JConfig
from score_based_channels_tpu.config import DataConfig as JDataConfig
from score_based_channels_tpu.data.dataset import ChannelDataset as JDataset
from score_based_channels_tpu.models.ldamp import LDAMP as JLDAMP
from score_based_channels_tpu.train.ldamp import (
    LDAMPTrainConfig as JTrainConfig, _device_batch, train_ldamp_snr as
    jax_train,
)
from score_based_channels_torch import _graph
from score_based_channels_torch.config import Config, DataConfig, OptimConfig
from score_based_channels_torch.data import ChannelDataset
from score_based_channels_torch.eval.estimate import derive_seed
from score_based_channels_torch.models.convert import (
    jax_variables_to_state_dict, state_dict_to_jax_params,
)
from score_based_channels_torch.train.ldamp import (
    LDAMPStepRunner, LDAMPTrainConfig, ldamp_batch, ldamp_inputs,
    ldamp_losses, ldamp_train_step, make_ldamp_model, make_ldamp_optimizer,
    train_ldamp_snr,
)
from score_based_channels_torch.train.score import Optimizer, staircase_decay

torch.set_num_threads(1)

TOL = 1e-5
SNR = 10.0
# 4 realizations at batch 2: 2 steps an epoch; the rate drops x0.1 after
# the first epoch, so 2 epochs cross the staircase
TINY = dict(max_unrolls=2, chans=4, num_pools=1, batch_size=2, n_epochs=2,
            decay_epochs=1)


def _quiet(s):
    pass


@torch.no_grad()
def _host_float_step(opt, count):
    """Optimizer.step as it was before the scheduled rate went into the
    table: the rate a host float from the host count (0-based)."""
    c, p = opt.cfg, opt.params
    g = [q.grad for q in p]
    lr = opt.schedule(count)
    if opt.rule in ("adam", "amsgrad"):
        mu, nu = opt.moments["mu"], opt.moments["nu"]
        torch._foreach_mul_(mu, c.beta1)
        torch._foreach_add_(mu, g, alpha=1.0 - c.beta1)
        torch._foreach_mul_(nu, c.beta2)
        torch._foreach_add_(nu, torch._foreach_mul(g, g), alpha=1.0 - c.beta2)
        bc1 = float(1 - np.float32(c.beta1) ** np.float32(count + 1))
        bc2 = float(1 - np.float32(c.beta2) ** np.float32(count + 1))
        m_hat = torch._foreach_div(mu, bc1)
        v_hat = torch._foreach_div(nu, bc2)
        if opt.rule == "amsgrad":
            torch._foreach_maximum_(opt.moments["nu_max"], v_hat)
            v_hat = [v.clone() for v in opt.moments["nu_max"]]
        torch._foreach_sqrt_(v_hat)
        torch._foreach_add_(v_hat, c.eps)
        torch._foreach_div_(m_hat, v_hat)
        torch._foreach_add_(p, m_hat, alpha=-lr)
    elif opt.rule == "rmsprop":
        nu = opt.moments["nu"]
        torch._foreach_mul_(nu, 0.99)
        torch._foreach_add_(nu, torch._foreach_mul(g, g), alpha=1 - 0.99)
        scale = torch._foreach_add(nu, 1e-8)
        torch._foreach_rsqrt_(scale)
        torch._foreach_add_(p, torch._foreach_mul(g, scale), alpha=-lr)
    else:
        tr = opt.moments["trace"]
        torch._foreach_mul_(tr, 0.9)
        torch._foreach_add_(tr, g)
        torch._foreach_add_(p, tr, alpha=-lr)
    opt.count += 1


def test_rate_column_is_the_staircase_bitwise():
    """Row r of the table holds -staircase_decay(r) in float32 beside
    the bias corrections; RMSprop and SGD with a schedule hold the rate
    alone; without a schedule, no rate column."""
    sched = staircase_decay(1e-3, 3, 0.1)
    p = [("w", torch.nn.Parameter(torch.zeros(3)))]
    for over, cols in ((dict(), 3), (dict(optimizer="RMSProp"), 1),
                       (dict(optimizer="SGD"), 1)):
        opt = Optimizer(p, dataclasses.replace(OptimConfig(), **over),
                        schedule=sched)
        opt.reserve(10)
        assert opt.table.shape == (10, cols)
        for r in range(10):
            want = -np.float32(np.float32(1e-3) * np.float32(0.1) ** (
                np.float32(r // 3)))
            assert opt.table[r, -1].item() == float(want), r
        assert opt.table[2, -1] != opt.table[3, -1]  # the staircase
    assert Optimizer(p, OptimConfig()).table is None
    plain = Optimizer(p, OptimConfig())
    plain.reserve(4)
    assert plain.table.shape == (4, 2)
    plain.schedule = sched  # set after: the table is made anew
    plain.reserve(1)
    assert plain.table.shape == (8, 3)


@pytest.mark.parametrize("rule", [dict(), dict(amsgrad=True),
                                  dict(optimizer="RMSProp"),
                                  dict(optimizer="SGD")],
                         ids=["adam", "amsgrad", "rmsprop", "sgd"])
def test_device_rate_update_equals_the_host_float_rule(rule):
    """7 updates over two drops of the staircase (every 3 steps), with a
    state round trip through the leaves after the third: bit for bit the
    host-float rate's update."""
    cfg = dataclasses.replace(OptimConfig(lr=1e-2, eps=1e-8), **rule)
    sched = staircase_decay(1e-2, 3, 0.1)
    rng = np.random.RandomState(3)
    w0 = [rng.randn(*s).astype(np.float32) for s in ((5,), (2, 3, 3, 4))]
    models = [[(f"w{i}", torch.nn.Parameter(torch.from_numpy(w.copy())))
               for i, w in enumerate(w0)] for _ in range(2)]
    opt, ref = (Optimizer(m, cfg, schedule=sched) for m in models)
    for step in range(7):
        grads = [rng.randn(*w.shape).astype(np.float32) * 10 ** rng.uniform(
            -4, 0) for w in w0]
        for m in models:
            for (_, p), g in zip(m, grads):
                p.grad = torch.from_numpy(g.copy())
        opt.step()
        _host_float_step(ref, step)
        if step == 2:
            leaves = opt.state_leaves()
            opt = Optimizer(models[0], cfg, schedule=sched)
            opt.load_state_leaves(leaves)
    assert opt.count == int(opt.count_t) == 7
    for (_, p), (_, q) in zip(*models):
        assert torch.equal(p, q)
    for key in opt.moments:
        for p, q in zip(opt.moments[key], ref.moments[key]):
            assert torch.equal(p, q)


@pytest.fixture(scope="module")
def tiny():
    """The tiny run's config, training config and dataset (as
    train_ldamp_snr makes it)."""
    cfg = Config(data=DataConfig(num_channels=4))
    tc = LDAMPTrainConfig(**TINY)
    ds = ChannelDataset(1234, dataclasses.replace(
        cfg.data, noise_std=float(10 ** (-SNR / 20) * 8), num_pilots=38),
        norm="global")
    return cfg, tc, ds


def _eager_loop(tc, ds):
    """train_ldamp_snr's loop as it was before the runner: one eager step
    a step, the batch made on the host, the rate a host float ->
    (model, optimizer, losses (steps, 2))."""
    model = make_ldamp_model(tc, "cpu", torch.Generator().manual_seed(
        derive_seed(tc.seed, 0)))
    opt = make_ldamp_optimizer(model, tc, len(ds) // tc.batch_size)
    gen = torch.Generator()
    rows = []
    for step in range(tc.n_epochs * len(ds) // tc.batch_size):
        batch = ldamp_batch(ds, torch.Generator().manual_seed(
            derive_seed(tc.seed, 1, step)), tc.batch_size, "cpu")
        gen.manual_seed(derive_seed(tc.seed, 2, step))
        mse, nmse = ldamp_losses(model, ldamp_inputs(batch), gen)
        opt.zero_grad()
        mse.backward()
        _host_float_step(opt, step)
        rows.append([mse.item(), nmse.item()])
    return model, opt, np.asarray(rows)


def test_train_ldamp_snr_equals_the_eager_loop_bitwise(tiny):
    """4 steps over 2 epochs, the rate x0.1 from the third: the trained
    parameters and every loss and NMSE."""
    cfg, tc, ds = tiny
    model, logs = train_ldamp_snr(cfg, SNR, tc, log_fn=_quiet, device="cpu")
    ref, _, rows = _eager_loop(tc, ds)
    np.testing.assert_array_equal(logs["loss_log"], rows[:, 0])
    np.testing.assert_array_equal(logs["nmse_log"], rows[:, 1])
    for p, q in zip(model.parameters(), ref.parameters()):
        assert torch.equal(p, q)


def test_runner_equals_the_eager_steps_bitwise(tiny):
    """The runner's steps (two runs, one an epoch) against
    ldamp_train_step on the same batches and seeds, with the directions
    seam and without: parameters, moments, count and every row."""
    _, tc, ds = tiny
    batches = [ldamp_batch(ds, torch.Generator().manual_seed(s), 2, "cpu")
               for s in range(4)]
    gd = torch.Generator().manual_seed(9)
    dirs = [[torch.randn(2, 64, 16, 2, generator=gd) for _ in range(2)]
            for _ in range(4)]
    for given in (None, dirs):
        models = [make_ldamp_model(tc, "cpu") for _ in range(2)]
        opts = [make_ldamp_optimizer(m, tc, 2) for m in models]
        runner = LDAMPStepRunner(models[0], opts[0], torch.Generator(), 2, 4)
        _graph.reset_stats()
        got = []
        for run in range(2):
            steps = range(2 * run, 2 * run + 2)
            got.append(runner.run(
                (batches[s] for s in steps), [100 + s for s in steps],
                None if given is None else (given[s] for s in steps)
            ).clone())
        gen = torch.Generator()
        for s in range(4):
            gen.manual_seed(100 + s)
            want = ldamp_train_step(models[1], opts[1], batches[s], gen,
                                    None if given is None else given[s])
            assert torch.equal(got[s // 2][s % 2], torch.stack(want))
        for p, q in zip(models[0].parameters(), models[1].parameters()):
            assert torch.equal(p, q)
        for p, q in zip(opts[0].moments["mu"] + opts[0].moments["nu"],
                        opts[1].moments["mu"] + opts[1].moments["nu"]):
            assert torch.equal(p, q)
        assert opts[0].count == opts[1].count == int(opts[0].count_t) == 4
        assert runner.stats == dict(steps=4, assembled=4)
        assert _graph.STATS == dict(captures=0, replays=0,
                                    capture_seconds=0.0, pool_bytes=0)


def test_runner_refuses_changed_shapes_and_a_grown_table(tiny):
    """A runner's buffers and graph serve one shape of inputs, and its
    graph reads the table it was built with."""
    _, tc, ds = tiny
    model = make_ldamp_model(tc, "cpu")
    opt = make_ldamp_optimizer(model, tc, 2)
    runner = LDAMPStepRunner(model, opt, torch.Generator(), 2, 3)
    b2 = ldamp_batch(ds, torch.Generator().manual_seed(0), 2, "cpu")
    b3 = ldamp_batch(ds, torch.Generator().manual_seed(0), 3, "cpu")
    runner.run([b2], [0])
    with pytest.raises(ValueError, match="first step"):
        runner.run([b3], [1])
    d = [torch.zeros(2, 64, 16, 2)] * 2
    with pytest.raises(ValueError, match="first step"):
        runner.run([b2], [1], [d])
    with pytest.raises(ValueError, match="at most 2 steps"):
        runner.run([b2] * 3, [1, 2, 3])
    runner.run([b2, b2], [1, 2])  # the 3 updates it was built for
    with pytest.raises(RuntimeError, match="table grew"):
        runner.run([b2], [3])
    assert opt.count == 3


def _jax_directions(key, n, shape):
    out = []
    for _ in range(n):
        key, k_dir = jax.random.split(key)
        out.append(torch.from_numpy(np.array(
            jax.random.normal(k_dir, shape, jnp.float32))))
    return out


def test_runner_matches_the_jax_train_ldamp_snr(tmp_path):
    """The JAX package's run of 2 epochs x 1 step (4 channels read from a
    file in the reference naming, batch 4, the second step at lr x 0.1) against the port's through the runner, fed the JAX run's
    initial parameters, batches and directions (train/ldamp.py:98-121)."""
    rng = np.random.default_rng(4)
    h = (rng.standard_normal((4, 1, 16, 64))
         + 1j * rng.standard_normal((4, 1, 16, 64))).astype(np.complex64)
    np.savez(tmp_path / "CDL-C_Nt64_Nr16_ULA0.50_seed1234.npz", output_h=h)
    files = dict(num_channels=4, source="file", data_dir=str(tmp_path))
    over = dict(TINY, batch_size=4)
    jcfg = JConfig(data=JDataConfig(**files))
    jtc = JTrainConfig(**over)
    params, jlogs = jax_train(jcfg, SNR, jtc, log_fn=_quiet)
    jds = JDataset(1234, dataclasses.replace(
        jcfg.data, noise_std=float(10 ** (-SNR / 20) * 8), num_pilots=38),
        norm="global")
    key = jax.random.key(jtc.seed)
    key, k_init, k_b0 = jax.random.split(key, 3)
    b0 = _device_batch(jds, k_b0, 2)
    init = JLDAMP(max_unrolls=2, chans=4, num_pools=1).init(
        k_init, b0["Y_herm"], b0["P_herm"], b0["eig1"], jax.random.key(0),
        2)["params"]
    batches, directions = [], []
    for _ in range(2):
        key, k_b, k_s = jax.random.split(key, 3)
        batches.append({k: torch.from_numpy(np.array(v)) for k, v in
                        _device_batch(jds, k_b, 4).items()})
        directions.append(_jax_directions(k_s, 2, (4, 64, 16, 2)))
    model, logs = train_ldamp_snr(
        Config(data=DataConfig(**files)), SNR,
        LDAMPTrainConfig(**over), log_fn=_quiet, device="cpu",
        _init=jax_variables_to_state_dict(init),
        _batches=lambda i: batches[i], _directions=lambda i: directions[i])
    np.testing.assert_allclose(logs["loss_log"], jlogs["loss_log"], rtol=TOL)
    np.testing.assert_allclose(logs["nmse_log"], jlogs["nmse_log"], rtol=TOL)
    got = state_dict_to_jax_params(model.state_dict())
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)
