"""The WGAN baseline in the PyTorch port against the JAX package: DCGAN_G
and DCGAN_D (train and eval mode, running statistics), optax's RMSprop,
one `train_wgan` epoch of two critic steps and a generator step, the
latent inversion `wgan_invert` and `run_wgan_eval` (with restarts) on a
checkpoint the JAX package's trainer wrote.

The JAX package's draws (initial parameters, batch indices, z, pilots,
noise, channels) are rebuilt from its own key splits (train/wgan.py:77-81,
152-159; eval/wgan.py:185-215) and injected through the port's seams.
Bars: 1e-5 relative for the modules; parameters after the epoch within
1e-6 absolute (an RMSprop step moves one by at most ~10 lr = 5e-4); the
inversion's traces within 1e-4 relative after 50 Adam steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from score_based_channels_tpu import cplx as jcplx
from score_based_channels_tpu.config import Config as JConfig
from score_based_channels_tpu.config import DataConfig as JDataConfig
from score_based_channels_tpu.data.dataset import ChannelDataset as JDataset
from score_based_channels_tpu.eval.wgan import run_wgan_eval as jax_eval
from score_based_channels_tpu.eval.wgan import wgan_invert as jax_invert
from score_based_channels_tpu.models.dcgan import DCGAN_D as JD
from score_based_channels_tpu.models.dcgan import DCGAN_G as JG
from score_based_channels_tpu.train.wgan import WGANTrainConfig as JTC
from score_based_channels_tpu.train.wgan import train_wgan as jax_train
from score_based_channels_torch.config import Config, DataConfig, OptimConfig
from score_based_channels_torch.eval.wgan import (
    load_generator, run_wgan_eval, wgan_invert,
)
from score_based_channels_torch.models.convert import (
    jax_variables_to_state_dict, module_to_jax_variables,
)
from score_based_channels_torch.models.dcgan import DCGAN_D, DCGAN_G
from score_based_channels_torch.train.score import Optimizer
from score_based_channels_torch.train.wgan import WGANTrainConfig, train_wgan

torch.set_num_threads(1)

TOL = 1e-5
TINY = dict(nz=8, ndf=8, ngf=8, n_extra_layers=1, batch_size=8,
            d_iters_boost=2)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _load(module, v):
    module.load_state_dict(jax_variables_to_state_dict(
        v["params"], v.get("batch_stats")), strict=True)
    return module


def _stepped(jm, v, x):
    """Variables with the running statistics of one train-mode apply, so
    that eval mode reads non-trivial ones."""
    _, new = jm.apply(v, x, train=True, mutable=["batch_stats"])
    return {"params": v["params"], "batch_stats": new["batch_stats"]}


@pytest.mark.parametrize("train", [True, False])
def test_generator_matches_flax(train):
    """Including the dense layout: flax's (in, out) kernel reshaped to
    (nr/4, nt/4, ngf) NHWC lands on the same channels in the port's NCHW
    view."""
    z = np.random.RandomState(0).randn(3, 8).astype(np.float32)
    jm = JG(nz=8, ngf=8, n_extra_layers=1)
    v = _stepped(jm, jm.init(jax.random.key(0), jnp.asarray(z)),
                 jnp.asarray(z) * 2)
    want, new = jm.apply(v, jnp.asarray(z), train=train,
                         mutable=["batch_stats"])
    tm = _load(DCGAN_G(nz=8, ngf=8, n_extra_layers=1), v).train(train)
    got = tm(torch.from_numpy(z))
    assert got.shape == (3, 16, 64, 2)
    assert _rel(got.detach().numpy(), want) < TOL
    _, stats = module_to_jax_variables(tm)
    for a, b in zip(jax.tree.leaves(stats),
                    jax.tree.leaves(new["batch_stats"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=1e-7)


@pytest.mark.parametrize("train", [True, False])
def test_critic_matches_flax(train):
    x = np.random.RandomState(1).randn(3, 16, 64, 2).astype(np.float32)
    jm = JD(ndf=8, n_extra_layers=1)
    v = _stepped(jm, jm.init(jax.random.key(1), jnp.asarray(x)),
                 jnp.asarray(x) * 2)
    want, new = jm.apply(v, jnp.asarray(x), train=train,
                         mutable=["batch_stats"])
    tm = _load(DCGAN_D(ndf=8, n_extra_layers=1), v).train(train)
    got = tm(torch.from_numpy(x))
    assert got.dim() == 0
    assert abs(got.item() - float(want)) < TOL * max(abs(float(want)), 1e-3)
    _, stats = module_to_jax_variables(tm)
    for a, b in zip(jax.tree.leaves(stats),
                    jax.tree.leaves(new["batch_stats"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=1e-7)


def test_rmsprop_matches_optax():
    """optax.rmsprop(decay 0.99, eps 1e-8): eps inside the root, nu from
    0 (torch.optim.RMSprop divides by sqrt(v) + eps)."""
    rng = np.random.RandomState(2)
    p0 = rng.randn(6).astype(np.float32)
    tx = optax.rmsprop(5e-5, decay=0.99, eps=1e-8)
    jp = jnp.asarray(p0)
    st = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = Optimizer([("w", tp)], OptimConfig(optimizer="RMSProp", lr=5e-5))
    for scale in (1.0, 1e-3, 1e-5):  # the small gradients meet the eps
        g = (rng.randn(6) * scale).astype(np.float32)
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-9)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One JAX `train_wgan` epoch (2 boosted critic steps, 1 generator
    step) on 16 channels, its checkpoint, and its draws."""
    jcfg = JConfig(data=JDataConfig(num_channels=16))
    jtc = JTC(**TINY)
    path = str(tmp_path_factory.mktemp("wgan") / "wgan.npz")
    state, logs = jax_train(jcfg, jtc, checkpoint_path=path, n_epochs=1,
                            log_fn=lambda s: None)
    key = jax.random.key(jtc.seed)
    key, kg, kd, _ = jax.random.split(key, 4)
    g0 = JG(nz=8, ngf=8, n_extra_layers=1).init(kg, jnp.zeros((2, 8)),
                                               train=True)
    d0 = JD(ndf=8, n_extra_layers=1).init(kd, jnp.zeros((2, 16, 64, 2)),
                                          train=True)
    ds = JDataset(1234, dataclasses.replace(jcfg.data, noise_std=0.0),
                  norm="entrywise")
    H = np.stack([ds.normalized().real, ds.normalized().imag], -1)
    draws = {}
    for i in range(2):
        key, k_idx, k_z = jax.random.split(key, 3)
        draws[("real", i)] = H[np.asarray(jax.random.choice(
            k_idx, 16, (8,), replace=False))].astype(np.float32)
        draws[("z", i)] = jax.random.normal(k_z, (8, 8))
    key, k_g = jax.random.split(key)
    draws[("zg", 0)] = jax.random.normal(k_g, (8, 8))
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    return dict(state=state, logs=logs, g0=g0, d0=d0, draws=draws,
                path=path, jcfg=jcfg)


def test_train_wgan_epoch_matches_jax(jax_run):
    """The critic's clip before its gradient, the two critic applies
    threading the statistics, the generator step on the critic's running
    averages, RMSprop: parameters and statistics after the epoch."""
    st = jax_run["state"]
    state, logs = train_wgan(
        Config(data=DataConfig(num_channels=16)), WGANTrainConfig(**TINY),
        n_epochs=1, log_fn=lambda s: None, device="cpu",
        _init=(jax_variables_to_state_dict(jax_run["g0"]["params"],
                                           jax_run["g0"]["batch_stats"]),
               jax_variables_to_state_dict(jax_run["d0"]["params"],
                                           jax_run["d0"]["batch_stats"])),
        _draws=lambda kind, i: jax_run["draws"][(kind, i)])
    assert state.gen_iterations == 1
    for net, params, stats in ((state.netG, st.g_params, st.g_stats),
                               (state.netD, st.d_params, st.d_stats)):
        p, s = module_to_jax_variables(net)
        for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(params)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
        for a, b in zip(jax.tree.leaves(s), jax.tree.leaves(stats)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(logs["d_log"], jax_run["logs"]["d_log"],
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(logs["g_log"], jax_run["logs"]["g_log"],
                               rtol=1e-4, atol=1e-7)


def test_wgan_invert_matches_jax(jax_run):
    """50 steps of the per-sample Adam on z, per-sample lambda and lr."""
    gen = load_generator(jax_run["path"], Config(), "cpu")
    st = jax_run["state"]
    netG = JG(nz=8, ngf=8, n_extra_layers=1)
    japply = lambda z: netG.apply({"params": st.g_params,
                                   "batch_stats": st.g_stats}, z, train=False)
    rng = np.random.RandomState(3)
    B = 4
    z0 = rng.randn(B, 8).astype(np.float32)
    P = (np.sign(rng.randn(B, 64, 20, 2)) * np.sqrt(0.5)).astype(np.float32)
    X = rng.randn(B, 16, 64, 2).astype(np.float32) * 0.1
    Y = np.asarray(jcplx.matmul(jnp.asarray(X), jnp.asarray(P)))
    Y = Y + 0.01 * rng.randn(*Y.shape).astype(np.float32)
    lam = np.array([0.1, 0.3, 1.0, 3.0], np.float32)
    lr = np.array([0.03, 0.01, 0.003, 0.001], np.float32)
    _, (wo, wm, wr) = jax_invert(japply, jnp.asarray(z0), jnp.asarray(P),
                                 jnp.asarray(Y), lam, lr, num_steps=50,
                                 oracle2=jnp.asarray(X))
    _, (go, gm, gr) = wgan_invert(gen, torch.from_numpy(z0),
                                  torch.from_numpy(P), torch.from_numpy(Y),
                                  torch.from_numpy(lam), torch.from_numpy(lr),
                                  num_steps=50, oracle2=torch.from_numpy(X))
    for got, want in ((go, wo), (gm, wm), (gr, wr)):
        assert got.shape == (50, B)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-7)


def test_eval_wgan_reads_the_jax_checkpoint(jax_run):
    """run_wgan_eval of both packages on the JAX-written checkpoint, the
    port fed the JAX run's z inits, channels, pilots and noise: the same
    traces, restart pick and NMSE."""
    jcfg = jax_run["jcfg"]
    kw = dict(snr_range=np.array([0.0, 10.0]), l2lam_range=(0.1,),
              lr_range=(0.03, 0.01), num_steps=50, num_channels=3,
              restarts=2, chunk_size=5)
    want = jax_eval(jcfg, jax_run["path"], **kw)
    # the JAX run's draws (eval/wgan.py:185-215)
    train_ds = JDataset(1234, jcfg.data, norm="entrywise")
    val_ds = JDataset(4321, jcfg.data, norm=list(train_ds.norm_stats),
                      num_pilots=38)
    key = jax.random.key(2021)
    k_z, key = jax.random.split(key)
    z_init = jax.random.normal(k_z, (2, 3, 8))
    kp, km = jax.random.split(jax.random.fold_in(key, 0))
    X2 = jcplx.from_complex(val_ds.normalized()[:3])
    P2 = jcplx.qpsk_pilots(kp, 3, 64, 38)
    w = jcplx.randn(km, (6, 16, 38))
    t = lambda a: torch.from_numpy(np.array(a))
    got = run_wgan_eval(Config(data=DataConfig(num_channels=16)),
                        jax_run["path"], device="cpu",
                        _draws=(t(z_init), [(t(X2), t(P2), t(w))]), **kw)
    for name in ("oracle_log", "meas_log", "reg_log"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got.best_nmse_db(), want.best_nmse_db(),
                               atol=1e-4)


def test_train_and_eval_wgan_commands(tmp_path, monkeypatch):
    """The port's own draws through both commands on the CPU (narrow
    networks and 2 boosted critic steps, for the CPU's time)."""
    from score_based_channels_torch.eval.wgan import main as eval_main
    from score_based_channels_torch.train import wgan as wgan_mod

    monkeypatch.setattr(wgan_mod, "WGANTrainConfig", lambda nz: (
        WGANTrainConfig(nz=nz, ndf=8, ngf=8, d_iters_boost=2)))
    train_main = wgan_mod.main

    ck = str(tmp_path / "w.npz")
    train_main(["--epochs", "1", "--train_size", "8", "--nz", "8",
                "--output", ck, "--device", "cpu"])
    from score_based_channels_torch.utils.checkpoint import load_checkpoint

    c = load_checkpoint(ck)
    assert sorted(c["params"]) == ["disc", "disc_stats", "gen", "gen_stats"]
    out = str(tmp_path / "res.npz")
    eval_main(["--checkpoint", ck, "--steps", "5", "--num_channels", "2",
               "--l2lam_range", "0.1", "--lr_range", "0.01", "--snr", "10",
               "--restarts", "2", "--device", "cpu", "--output", out])
    with np.load(out) as f:
        assert f["oracle_log"].shape == (1, 1, 1, 1, 5, 2)
        assert np.isfinite(f["oracle_log"]).all()


def test_wgan_commands_run_with_tf32_off(tmp_path, monkeypatch):
    """train-wgan and eval-wgan run the generator with TF32 off for cuDNN
    and matmul (the config's matmul_precision "highest", as train-score),
    and give the settings back after."""
    from score_based_channels_torch.eval.wgan import main as eval_main
    from score_based_channels_torch.train import wgan as wgan_mod

    monkeypatch.setattr(wgan_mod, "WGANTrainConfig", lambda nz: (
        WGANTrainConfig(nz=nz, ndf=8, ngf=8, d_iters_boost=2)))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen, forward = [], DCGAN_G.forward

    def spy(self, *args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return forward(self, *args, **kwargs)

    monkeypatch.setattr(DCGAN_G, "forward", spy)
    ck = str(tmp_path / "w.npz")
    wgan_mod.main(["--epochs", "1", "--train_size", "8", "--nz", "8",
                   "--output", ck, "--device", "cpu"])
    n_train = len(seen)
    eval_main(["--checkpoint", ck, "--steps", "2", "--num_channels", "2",
               "--l2lam_range", "0.1", "--lr_range", "0.01", "--snr", "10",
               "--device", "cpu", "--output", str(tmp_path / "res.npz")])
    assert 0 < n_train < len(seen)
    assert set(seen) == {(False, False)}
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32
