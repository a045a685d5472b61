"""The training runner (`TrainChunkRunner`: chunks of DSM steps on static
buffers, one captured CUDA graph on the card) on the CPU, against the
eager loop it replaces and the JAX package's `train_chunk`.

On the CPU the runner calls its step once a step. Its arithmetic is the
eager `train_step`'s, op for op (the batch gathered by index_select, the
optimizer's bias corrections read from its device table), so
`ScoreTrainer.train` through the runner equals the loop of eager steps
that it replaced bit for bit, over several chunks, a short last chunk,
an epoch boundary and a resume. Against the JAX `train_chunk` the bars
are test_torch_train.py's: 2e-4 relative on the loss, 1e-6 absolute on
each parameter and EMA leaf. The table-driven optimizer equals the
host-float update it replaced bit for bit, and optax to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from score_based_channels_tpu.config import Config as JConfig
from score_based_channels_tpu.config import OptimConfig as JOptimConfig
from score_based_channels_tpu.diffusion.sigmas import (
    sigmas_from_config as jax_sigmas,
)
from score_based_channels_tpu.models import make_score_model as jax_model
from score_based_channels_tpu.train import score as jax_train
from score_based_channels_torch import _graph, kernels
from score_based_channels_torch.config import Config, ModelConfig, OptimConfig
from score_based_channels_torch.data import ChannelDataset
from score_based_channels_torch.eval.estimate import derive_seed
from score_based_channels_torch.models import (
    jax_params_to_state_dict, make_score_model, state_dict_to_jax_params,
)
from score_based_channels_torch.models.convert import tree_paths
from score_based_channels_torch.train import ScoreTrainer, make_optimizer
from score_based_channels_torch.train import score as port_train
from score_based_channels_torch.train.score import (
    Optimizer, TrainChunkRunner, staircase_decay,
)

torch.set_num_threads(1)

# 16 realizations at batch 4: 4 steps an epoch; chunks of 3 give 3, 3, 2
# over 2 epochs (the second chunk crosses the epoch boundary)
CFG = dict(model=dict(ngf=8, num_classes=12),
           training=dict(batch_size=4, n_epochs=2, log_every_steps=3),
           data=dict(num_channels=16))


def _cfg(cls_cfg, **over):
    base = cls_cfg()
    secs = {k: dataclasses.replace(getattr(base, k), **v) for k, v in CFG.items()}
    for k, v in over.items():
        secs[k] = dataclasses.replace(secs.get(k, getattr(base, k)), **v)
    return base.replace(**secs)


def _eager_loop(trainer, n_epochs=None, resume_from=None, rng_seed=None):
    """ScoreTrainer.train's loop as it was before the runner: one eager
    `train_step` a step, each batch gathered by advanced indexing from a
    device copy of the epoch's permutation -> (state, train losses, val
    losses)."""
    cfg = trainer.config
    n_epochs = n_epochs if n_epochs is not None else cfg.training.n_epochs
    rng_seed = rng_seed if rng_seed is not None else cfg.training.seed
    train_ds = ChannelDataset(1234, cfg, norm=cfg.data.norm_channels)
    val_ds = ChannelDataset(4321, cfg, norm=list(train_ds.norm_stats))
    x_all = train_ds.network_input()
    x_val = val_ds.network_input()
    state = (trainer.restore_state(resume_from) if resume_from
             else trainer.init_state(rng_seed))
    batch = cfg.training.batch_size
    n = x_all.shape[0]
    steps_per_epoch = n // batch
    total = n_epochs * steps_per_epoch
    chunk_len = cfg.training.log_every_steps
    gen = torch.Generator()
    perm, perm_epoch = None, -1
    train_log, val_log = [], []
    done = state.step
    while done < total:
        losses = []
        for s in range(done, min(done + chunk_len, total)):
            epoch, i = divmod(s, steps_per_epoch)
            if epoch != perm_epoch:
                perm = torch.randperm(n, generator=torch.Generator()
                                      .manual_seed(derive_seed(rng_seed, 1,
                                                               epoch)))
                perm_epoch = epoch
            x = x_all[perm[i * batch:(i + 1) * batch]]
            gen.manual_seed(derive_seed(rng_seed, 2, s))
            losses.append(trainer.train_step(state, x, gen))
        done += len(losses)
        train_log.extend(torch.stack(losses).tolist())
        gen.manual_seed(derive_seed(rng_seed, 3, done))
        val_log.append(float(trainer.eval_loss(state.ema, x_val, gen)))
    return state, np.asarray(train_log), np.asarray(val_log)


def _assert_states_equal(a, b):
    assert a.step == b.step and a.opt.count == b.opt.count
    for m, n in ((a.model, b.model), (a.ema, b.ema)):
        for p, q in zip(m.parameters(), n.parameters()):
            assert torch.equal(p, q)
    for key in a.opt.moments:
        for p, q in zip(a.opt.moments[key], b.opt.moments[key]):
            assert torch.equal(p, q)
    if a.opt.rule in ("adam", "amsgrad"):  # the rules that read it
        assert int(a.opt.count_t) == a.opt.count


def _quiet(s):
    pass


@pytest.mark.parametrize("optimizer", ["Adam", "RMSProp"])
def test_runner_equals_the_eager_loop_bitwise(optimizer):
    """8 steps in chunks of 3, 3, 2 over 2 epochs: parameters, EMA,
    moments, count and every train and validation loss."""
    cfg = _cfg(Config, optim=dict(optimizer=optimizer))
    trainer = ScoreTrainer(cfg, device="cpu")
    state, logs = trainer.train(log_fn=_quiet)
    ref, train_log, val_log = _eager_loop(ScoreTrainer(cfg, device="cpu"))
    assert state.step == 8 and len(logs["val_loss"]) == 3
    _assert_states_equal(state, ref)
    np.testing.assert_array_equal(logs["train_loss"], train_log)
    np.testing.assert_array_equal(logs["val_loss"], val_log)


def test_runner_resumes_a_checkpoint_written_mid_run_bitwise(tmp_path):
    """One epoch (chunks of 3 and 1) to a checkpoint, then on to 3 epochs
    from it (chunks 3, 3, 2): equal to the eager loop resumed from the same
    file, and to the runner's uninterrupted run."""
    cfg = _cfg(Config)
    path = str(tmp_path / "mid.npz")
    ScoreTrainer(cfg, device="cpu").train(n_epochs=1, checkpoint_path=path,
                                          log_fn=_quiet)
    resumed, logs = ScoreTrainer(cfg, device="cpu").train(
        n_epochs=3, resume_from=path, log_fn=_quiet)
    ref, train_log, val_log = _eager_loop(ScoreTrainer(cfg, device="cpu"),
                                          n_epochs=3, resume_from=path)
    assert resumed.step == 12 and resumed.opt.count == 12
    _assert_states_equal(resumed, ref)
    np.testing.assert_array_equal(logs["train_loss"], train_log)
    np.testing.assert_array_equal(logs["val_loss"], val_log)
    full, full_logs = ScoreTrainer(cfg, device="cpu").train(n_epochs=3,
                                                            log_fn=_quiet)
    _assert_states_equal(resumed, full)
    np.testing.assert_array_equal(full_logs["train_loss"][4:],
                                  logs["train_loss"])


def _jax_draws(key, B, L, shape):
    """labels and unit noise as the JAX package's anneal_dsm_loss draws
    them from `key` (tests/test_torch_train.py)."""
    k_label, k_noise = jax.random.split(key)
    labels = jax.random.randint(k_label, (B,), 0, L)
    noise = jax.random.normal(k_noise, shape, jnp.float32)
    return np.asarray(labels), np.asarray(noise)


def test_runner_matches_the_jax_train_chunk():
    """4 steps of the JAX `train_chunk` (one lax.scan) against one run of
    the runner on the same x_all and idx, with the JAX draws of
    fold_in(base_key, step) given through the runner's draws seam."""
    jcfg = _cfg(JConfig)
    model = jax_model(jcfg.model)
    params = model.init(jax.random.key(0), jnp.zeros((1, 64, 16, 2)),
                        jnp.float32(1.0))["params"]
    trainer = ScoreTrainer(_cfg(Config), device="cpu")
    state = trainer.init_state(0)
    state.model.load_state_dict(jax_params_to_state_dict(params))
    state.ema.load_state_dict(jax_params_to_state_dict(params))
    tx = jax_train.make_optimizer(jcfg.optim)
    _, j_chunk = jax_train.make_score_train_step(
        model, tx, jax_sigmas(jcfg.model), jcfg.model.ema_rate,
        jcfg.training.anneal_power)
    p0 = jax.tree.map(jnp.array, params)
    j_state = jax_train.ScoreTrainState(
        params=p0, opt_state=tx.init(p0),
        ema_params=jax.tree.map(jnp.copy, p0), step=jnp.zeros((), jnp.int32))
    rng = np.random.RandomState(3)
    x_all = rng.randn(16, 64, 16, 2).astype(np.float32)
    idx = np.stack([rng.permutation(16)[:4] for _ in range(4)]).astype(
        np.int32)
    base_key = jax.random.key(11)
    draws = [_jax_draws(jax.random.fold_in(base_key, s), 4, 12, (4, 64, 16, 2))
             for s in range(4)]
    j_state, j_losses = j_chunk(j_state, jnp.asarray(x_all), jnp.asarray(idx),
                                base_key)

    runner = TrainChunkRunner(trainer.update, state, torch.from_numpy(x_all),
                              4, 4, torch.Generator(), 4)
    losses = runner.run(torch.from_numpy(idx).long(), [0] * 4,
                        labels=torch.from_numpy(np.stack([d[0] for d in
                                                          draws])).long(),
                        noise=torch.from_numpy(np.stack([d[1] for d in
                                                         draws])))
    np.testing.assert_allclose(losses.numpy(), np.asarray(j_losses),
                               rtol=2e-4)
    assert state.step == int(j_state.step) == 4 and state.opt.count == 4
    for mine, theirs in ((state.model, j_state.params),
                         (state.ema, j_state.ema_params)):
        got = jax.tree_util.tree_leaves(
            state_dict_to_jax_params(mine.state_dict()))
        for a, b in zip(got, jax.tree_util.tree_leaves(theirs)):
            assert np.abs(np.asarray(a) - np.asarray(b)).max() <= 1e-6


@torch.no_grad()
def _host_float_step(opt, count):
    """Optimizer.step as it was before the device table: the learning
    rate and optax's float32 bias corrections as host floats from the
    host count (the update's 1-based count)."""
    c, p = opt.cfg, opt.params
    g = [q.grad for q in p]
    lr = c.lr if opt.schedule is None else opt.schedule(count - 1)
    if opt.rule in ("adam", "amsgrad"):
        if c.weight_decay:
            g = torch._foreach_add(g, torch._foreach_mul(p, c.weight_decay))
        mu, nu = opt.moments["mu"], opt.moments["nu"]
        torch._foreach_mul_(mu, c.beta1)
        torch._foreach_add_(mu, g, alpha=1.0 - c.beta1)
        torch._foreach_mul_(nu, c.beta2)
        torch._foreach_add_(nu, torch._foreach_mul(g, g), alpha=1.0 - c.beta2)
        bc1 = float(1 - np.float32(c.beta1) ** np.float32(count))
        bc2 = float(1 - np.float32(c.beta2) ** np.float32(count))
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


OPTIMIZERS = {
    "adam": (dict(), lambda c: optax.adam(c.lr, b1=c.beta1, b2=c.beta2,
                                          eps=c.eps)),
    "adam_wd": (dict(weight_decay=0.1), lambda c: optax.chain(
        optax.add_decayed_weights(c.weight_decay),
        optax.adam(c.lr, b1=c.beta1, b2=c.beta2, eps=c.eps))),
    "amsgrad": (dict(amsgrad=True, eps=1e-8), lambda c: optax.amsgrad(
        c.lr, b1=c.beta1, b2=c.beta2, eps=c.eps)),
    "rmsprop": (dict(optimizer="RMSProp", lr=1e-3), lambda c: optax.rmsprop(
        c.lr, decay=0.99, eps=1e-8)),
    "sgd": (dict(optimizer="SGD", lr=1e-2), lambda c: optax.sgd(
        c.lr, momentum=0.9)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_table_optimizer_equals_the_host_float_update_and_optax(name):
    """7 updates (the table grows from 1 row to 8 on the way), with a
    state round trip through the leaves after the third: bit for bit the
    host-float update; optax to 1e-6 (the JAX package's make_optimizer and
    the rules' own optax builders agree)."""
    over, build = OPTIMIZERS[name]
    ocfg = dataclasses.replace(OptimConfig(), **over)
    jcfg = dataclasses.replace(JOptimConfig(), **over)
    txs = [jax_train.make_optimizer(jcfg), build(jcfg)]
    models = [make_score_model(ModelConfig(ngf=4, num_classes=12),
                               device="cpu",
                               generator=torch.Generator().manual_seed(1))
              for _ in range(2)]
    opt, ref = (make_optimizer(m, ocfg) for m in models)
    params = state_dict_to_jax_params(models[0].state_dict())
    j_params = [jax.tree.map(jnp.asarray, params) for _ in txs]
    j_states = [tx.init(p) for tx, p in zip(txs, j_params)]
    rng = np.random.RandomState(2)
    for step in range(1, 8):
        grads = jax.tree.map(
            lambda p: (rng.randn(*p.shape) * 10 ** rng.uniform(-6, 0)
                       ).astype(np.float32), params)
        sd = jax_params_to_state_dict(grads)
        for m in models:
            for n, p in m.named_parameters():
                p.grad = sd[n].clone()
        opt.step()
        _host_float_step(ref, step)
        for i, tx in enumerate(txs):
            upd, j_states[i] = tx.update(jax.tree.map(jnp.asarray, grads),
                                         j_states[i], j_params[i])
            j_params[i] = optax.apply_updates(j_params[i], upd)
        if step == 3:  # a resume: the device counter comes from the leaves
            leaves = opt.state_leaves()
            opt = make_optimizer(models[0], ocfg)
            opt.load_state_leaves(leaves)
    if opt.rule in ("adam", "amsgrad"):  # the rules whose leaves count
        assert opt.count == int(opt.count_t) == 7
        assert opt.table.shape == (8, 2)
    for p, q in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(p, q)
    for key in opt.moments:
        for p, q in zip(opt.moments[key], ref.moments[key]):
            assert torch.equal(p, q)
    got = state_dict_to_jax_params(models[0].state_dict())
    for want in j_params:
        want = jax.tree.map(np.asarray, want)
        for path in tree_paths(want):
            g, w = got, want
            for t in path:
                g, w = g[t], w[t]
            assert np.abs(g - w).max() <= 1e-6 * max(np.abs(w).max(), 1e-30)


def test_table_rows_are_optax_float32_bias_corrections():
    model = make_score_model(ModelConfig(ngf=4), device="cpu")
    opt = make_optimizer(model, OptimConfig())
    opt.count = 5
    opt.reserve(3)
    assert opt.table.shape == (8, 2) and opt.table.dtype == torch.float32
    for c in range(1, 9):
        for j, b in enumerate((0.9, 0.999)):
            want = 1 - np.float32(b) ** np.float32(c)
            assert opt.table[c - 1, j].item() == float(want)
    same = opt.table
    opt.reserve(3)  # covered: the same tensor
    assert opt.table is same


def test_runner_refuses_a_schedule_and_changed_inputs():
    """A scheduled optimizer runs (its rates are in its table); a schedule
    set after the runner was built (its rates are not in the table the
    runner reads), a table that grew, and inputs that change between
    runs raise."""
    trainer = ScoreTrainer(_cfg(Config), device="cpu")
    state = trainer.init_state(0)
    x_all = torch.randn(8, 64, 16, 2)
    idx = torch.arange(8).view(2, 4)
    scheduled = Optimizer(state.model.named_parameters(), OptimConfig(),
                          schedule=staircase_decay(1e-4, 2, 0.1))
    losses = TrainChunkRunner(trainer.update, dataclasses.replace(
        state, opt=scheduled), x_all, 4, 3, torch.Generator(), 3).run(
            idx, [1, 2])
    assert torch.isfinite(losses).all() and scheduled.count == 2
    assert scheduled.table.shape == (3, 3)
    runner = TrainChunkRunner(trainer.update, state, x_all, 4, 3,
                              torch.Generator(), 6)
    runner.run(idx, [1, 2])
    with pytest.raises(ValueError, match="at most 3 steps"):
        runner.run(torch.zeros(4, 4, dtype=torch.int64), [1, 2, 3, 4])
    with pytest.raises(ValueError, match="rows"):
        runner.run(torch.zeros(1, 2, dtype=torch.int64), [1])
    with pytest.raises(ValueError, match="same inputs"):
        runner.run(idx, [1, 2], labels=torch.zeros(2, 4, dtype=torch.int64),
                   noise=torch.zeros(2, 4, 64, 16, 2))
    state.opt.schedule = staircase_decay(1e-4, 2, 0.1)
    with pytest.raises(RuntimeError, match="schedule was set"):
        runner.run(idx, [1, 2])
    state.opt.schedule = None
    state.opt.reserve(100)  # the table grew past what the runner reserved
    with pytest.raises(RuntimeError, match="table grew"):
        runner.run(idx, [1, 2])
    assert state.step == 2 and state.opt.count == 2


def test_runner_losses_are_the_eager_steps_on_the_same_draws():
    """The runner's rows come from its idx buffer and its draws from the
    seeds: a run equals train_step on x_all[idx[s]] after seeding, with
    the draws seam and without."""
    trainer = ScoreTrainer(_cfg(Config), device="cpu")
    x_all = torch.randn(12, 64, 16, 2, generator=torch.Generator()
                        .manual_seed(5))
    idx = torch.tensor([[3, 1, 4, 7], [11, 0, 2, 9]])
    states = [trainer.init_state(0) for _ in range(2)]
    runner = TrainChunkRunner(trainer.update, states[0], x_all, 4, 2,
                              torch.Generator(), 2)
    losses = runner.run(idx, [7, 8]).clone()
    gen = torch.Generator()
    for s, seed in enumerate((7, 8)):
        gen.manual_seed(seed)
        loss = trainer.train_step(states[1], x_all[idx[s]], gen)
        assert torch.equal(losses[s], loss)
    _assert_states_equal(*states)


def test_add_launches_and_grad_counts_take_back_and_replay():
    kernels.reset_counts()
    rec = {"conv2d_taps": 225, "instance_norm_plus": 25}
    rec_grad = {"conv2d_taps": {"functions": 113, "dgrad": 112},
                "instance_norm_plus": {"functions": 25, "backward": 25}}
    # what the wrappers counted while a capture recorded, taken back ...
    kernels.add_launches(rec)
    kernels.add_grad_counts(rec_grad)
    kernels.add_launches(rec, -1)
    kernels.add_grad_counts(rec_grad, -1)
    assert kernels.grad_counts() == {
        "conv2d_taps": {"functions": 0, "dgrad": 0},
        "instance_norm_plus": {"functions": 0, "backward": 0}}
    # ... then added once a replay
    for _ in range(3):
        kernels.add_launches(rec)
        kernels.add_grad_counts(rec_grad)
    kernels.add_grad_counts({"conv2d_taps": {"dgrad": 2}}, times=5)
    n, ng = kernels.counts(), kernels.grad_counts()
    assert n["conv2d_taps"] == {"launches": 675, "plain": 0}
    assert n["instance_norm_plus"] == {"launches": 75, "plain": 0}
    assert ng == {"conv2d_taps": {"functions": 339, "dgrad": 346},
                  "instance_norm_plus": {"functions": 75, "backward": 75}}
    kernels.reset_counts()
    assert kernels.grad_counts()["conv2d_taps"] == {"functions": 0,
                                                    "dgrad": 0}


def test_runner_counts_its_steps_on_the_cpu():
    """On the CPU every step runs eagerly through the plain versions: no
    capture, no replay, 113 conv and 25 norm plain calls a forward."""
    kernels.reset_counts()
    port_train.reset_stats()
    _graph.reset_stats()
    trainer = ScoreTrainer(_cfg(Config), device="cpu")
    state, logs = trainer.train(n_epochs=1, log_fn=_quiet)
    assert port_train.STATS == dict(steps=4)
    assert _graph.STATS == dict(captures=0, replays=0, capture_seconds=0.0,
                                pool_bytes=0)
    n = kernels.counts()
    # 4 steps and 2 validations, one forward each
    assert n["conv2d_taps"] == {"launches": 0, "plain": 113 * 6}
    assert n["instance_norm_plus"] == {"launches": 0, "plain": 25 * 6}
