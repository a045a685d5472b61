"""Score training of the PyTorch port against the JAX package on the CPU
(checkpoints, resume and the entry points: tests/test_torch_train_resume.py).

A small network (ngf 8, 12 sigma-levels) from a JAX init, converted with
jax_params_to_state_dict; the same batch, labels and noise (JAX's own
draws, as diffusion/dsm.py:43-48 makes them) go through both packages.
Bars: DSM loss 2e-4 relative (tests/test_model_parity.py:92-94), each
parameter's gradient within 1e-3 of that tensor's max|g|, the optimizers
1e-6 relative, three full train steps 1e-6 absolute on the parameters.
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
from score_based_channels_tpu.diffusion.dsm import anneal_dsm_loss as jax_dsm
from score_based_channels_tpu.diffusion.ema import ema_update as jax_ema_update
from score_based_channels_tpu.diffusion.sigmas import sigmas_from_config as jax_sigmas
from score_based_channels_tpu.models import make_score_model as jax_model
from score_based_channels_tpu.train import score as jax_train
from score_based_channels_torch.config import Config, OptimConfig
from score_based_channels_torch.diffusion.dsm import anneal_dsm_loss
from score_based_channels_torch.diffusion.ema import ema_init, ema_update
from score_based_channels_torch.kernels import conv
from score_based_channels_torch.kernels import instance_norm as inorm
from score_based_channels_torch.models import (
    jax_params_to_state_dict, make_score_model, state_dict_to_jax_params,
)
from score_based_channels_torch.models.convert import tree_paths
from score_based_channels_torch.train import ScoreTrainer, make_optimizer

torch.set_num_threads(1)

CFG = dict(model=dict(ngf=8, num_classes=12),
           training=dict(batch_size=8, n_epochs=2, log_every_steps=2),
           data=dict(num_channels=16))


def _cfg(cls_cfg, **over):
    """The tiny config of tests/test_train_eval.py:21-28 in either package."""
    base = cls_cfg()
    secs = {k: dataclasses.replace(getattr(base, k), **v) for k, v in CFG.items()}
    for k, v in over.items():
        secs[k] = dataclasses.replace(secs.get(k, getattr(base, k)), **v)
    return base.replace(**secs)


def _leaves(tree):
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(tree)]


def _rel_close(got, want, rtol):
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def jax_setup():
    cfg = _cfg(JConfig)
    model = jax_model(cfg.model)
    params = model.init(jax.random.key(0), jnp.zeros((1, 64, 16, 2)),
                        jnp.float32(1.0))["params"]
    sigmas = jax_sigmas(cfg.model)

    def apply_fn(p, x, s):
        return model.apply({"params": p}, x, s)

    loss_grad = jax.jit(jax.value_and_grad(
        lambda p, x, key, labels: jax_dsm(apply_fn, p, x, sigmas, key,
                                          labels=labels)))
    return cfg, model, params, sigmas, loss_grad


def _batch(seed=1, B=4):
    return np.random.RandomState(seed).randn(B, 64, 16, 2).astype(np.float32)


def _jax_draws(key, B, L, shape):
    """labels and unit noise as the JAX package's anneal_dsm_loss draws
    them from `key`."""
    k_label, k_noise = jax.random.split(key)
    labels = jax.random.randint(k_label, (B,), 0, L)
    noise = jax.random.normal(k_noise, shape, jnp.float32)
    return np.asarray(labels), np.asarray(noise)


def _port(params):
    m = make_score_model(Config().model.__class__(ngf=8, num_classes=12),
                         device="cpu")
    m.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return m


def test_dsm_loss_and_every_gradient_match_jax(jax_setup):
    cfg, _, params, sigmas, loss_grad = jax_setup
    x = _batch()
    key = jax.random.key(5)
    labels, noise = _jax_draws(key, 4, 12, x.shape)
    j_loss, j_grads = loss_grad(params, jnp.asarray(x), key,
                                jnp.asarray(labels))
    model = _port(params)
    loss = anneal_dsm_loss(model, torch.from_numpy(x),
                           torch.from_numpy(np.asarray(sigmas)),
                           labels=torch.from_numpy(labels),
                           noise=torch.from_numpy(noise))
    assert abs(loss.item() - float(j_loss)) <= 2e-4 * abs(float(j_loss))
    loss.backward()
    got = state_dict_to_jax_params(
        {n: p.grad for n, p in model.named_parameters()})
    paths = tree_paths(got)
    assert paths == tree_paths(jax.tree.map(np.asarray, j_grads))
    want = jax.tree.map(np.asarray, j_grads)
    for path in paths:
        g, w = got, want
        for t in path:
            g, w = g[t], w[t]
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max(), path


def test_dsm_draws_from_the_generator():
    model = lambda x, s: torch.zeros_like(x)
    x = torch.from_numpy(_batch())
    sig = torch.tensor([1.0, 2.0, 3.0])
    a = anneal_dsm_loss(model, x, sig, torch.Generator().manual_seed(3))
    b = anneal_dsm_loss(model, x, sig, torch.Generator().manual_seed(3))
    c = anneal_dsm_loss(model, x, sig, torch.Generator().manual_seed(4))
    assert a.item() == b.item() != c.item()
    # zero score: 1/2 sum (z / sigma)^2 sigma^2 = 1/2 sum z^2 per sample
    g = torch.Generator().manual_seed(3)
    labels = torch.randint(0, 3, (4,), generator=g)
    z = torch.randn(x.shape, generator=g)
    assert abs(a.item() - 0.5 * z.pow(2).sum().item() / 4) < 1e-3 * a.item()


OPTIMIZERS = {
    "adam": (dict(), lambda c: optax.adam(c.lr, b1=c.beta1, b2=c.beta2,
                                          eps=c.eps)),
    "adam_wd": (dict(weight_decay=0.1), lambda c: optax.chain(
        optax.add_decayed_weights(c.weight_decay),
        optax.adam(c.lr, b1=c.beta1, b2=c.beta2, eps=c.eps))),
    "amsgrad": (dict(amsgrad=True, eps=1e-8), lambda c: optax.amsgrad(
        c.lr, b1=c.beta1, b2=c.beta2, eps=c.eps)),
    "rmsprop": (dict(optimizer="RMSProp", lr=1e-3), None),
    "sgd": (dict(optimizer="SGD", lr=1e-2), None),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax_over_five_steps(name):
    over, _ = OPTIMIZERS[name]
    ocfg = dataclasses.replace(OptimConfig(), **over)
    # the JAX package's make_optimizer is the oracle
    tx = jax_train.make_optimizer(dataclasses.replace(JOptimConfig(), **over))
    model = make_score_model(Config().model.__class__(ngf=4, num_classes=12),
                             device="cpu",
                             generator=torch.Generator().manual_seed(1))
    params = state_dict_to_jax_params(model.state_dict())
    opt = make_optimizer(model, ocfg)
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = tx.init(j_params)
    rng = np.random.RandomState(2)
    for _ in range(5):
        grads = jax.tree.map(
            lambda p: (rng.randn(*p.shape) * 10 ** rng.uniform(-6, 0)
                       ).astype(np.float32), params)
        sd = jax_params_to_state_dict(grads)
        for n, p in model.named_parameters():
            p.grad = sd[n].clone()
        opt.step()
        upd, j_state = tx.update(jax.tree.map(jnp.asarray, grads), j_state,
                                 j_params)
        j_params = optax.apply_updates(j_params, upd)
    got = state_dict_to_jax_params(model.state_dict())
    want = jax.tree.map(np.asarray, j_params)
    for path in tree_paths(want):
        g, w = got, want
        for t in path:
            g, w = g[t], w[t]
        _rel_close(g, w, 1e-6)
    # the state leaves come in optax's flattening order and layout
    j_leaves = _leaves(j_state)
    leaves = opt.state_leaves()
    assert len(leaves) == len(j_leaves)
    for a, b in zip(leaves, j_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        _rel_close(a, b, 1e-6)


def test_unknown_optimizer_is_refused():
    model = make_score_model(Config().model.__class__(ngf=4), device="cpu")
    with pytest.raises(NotImplementedError, match="not understood"):
        make_optimizer(model, dataclasses.replace(OptimConfig(),
                                                  optimizer="Lion"))


def test_ema_update_matches_jax(jax_setup):
    _, _, params, _, _ = jax_setup
    model = _port(params)
    shadow = ema_init(model)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.5).add_(0.25)
    ema_update(shadow, model, 0.999)
    new = state_dict_to_jax_params(model.state_dict())
    want = jax_ema_update(jax.tree.map(jnp.asarray, params),
                          jax.tree.map(jnp.asarray, new), 0.999)
    got = state_dict_to_jax_params(shadow.state_dict())
    for a, b in zip(_leaves(got), _leaves(want)):
        _rel_close(a, b, 1e-6)
    assert all(not p.requires_grad for p in shadow.parameters())
    assert all(conv.has_kernel_layout(m.weight) for m in shadow.modules()
               if hasattr(m, "dilation"))


def test_three_train_steps_match_jax(jax_setup):
    jcfg, model, params, sigmas, _ = jax_setup
    tx = jax_train.make_optimizer(jcfg.optim)
    j_step, _ = jax_train.make_score_train_step(
        model, tx, sigmas, jcfg.model.ema_rate, jcfg.training.anneal_power)
    p0 = jax.tree.map(jnp.array, params)  # a copy: the step donates it
    j_state = jax_train.ScoreTrainState(
        params=p0, opt_state=tx.init(p0), ema_params=jax.tree.map(jnp.copy, p0),
        step=jnp.zeros((), jnp.int32))
    trainer = ScoreTrainer(_cfg(Config), device="cpu")
    state = trainer.init_state(0)
    state.model.load_state_dict(jax_params_to_state_dict(params))
    state.ema.load_state_dict(jax_params_to_state_dict(params))
    for s in range(3):
        x = _batch(10 + s, B=8)
        key = jax.random.key(100 + s)
        labels, noise = _jax_draws(key, 8, 12, x.shape)
        j_state, j_loss = j_step(j_state, jnp.asarray(x), key)
        loss = trainer.train_step(state, torch.from_numpy(x),
                                  labels=torch.from_numpy(labels),
                                  noise=torch.from_numpy(noise))
        assert abs(loss.item() - float(j_loss)) <= 2e-4 * float(j_loss)
    assert state.step == int(j_state.step) == 3
    for mine, theirs in ((state.model, j_state.params),
                         (state.ema, j_state.ema_params)):
        got = _leaves(state_dict_to_jax_params(mine.state_dict()))
        for a, b in zip(got, _leaves(theirs)):
            assert np.abs(a - b).max() <= 1e-6
    assert state.opt.count == 3


@pytest.mark.parametrize("B", [32, 4])
def test_every_training_conv_and_its_dgrad_has_an_f32_plan(B):
    """The f32 kernel's tile plan takes every conv of a full-width training
    step and its input-gradient conv (Cin and Cout swapped), at the
    training batch and the card-vs-CPU gradient check's batch."""
    from score_based_channels_torch.models.layers import Conv2d

    model = make_score_model(Config().model, device="cpu")
    shapes = set()
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: shapes.add((*args[0].shape[2:], args[0].shape[1],
                                      mod.weight.shape[0], mod.weight.shape[-1],
                                      mod.dilation)))
        for m in model.modules() if isinstance(m, Conv2d)]
    with torch.no_grad():
        model(torch.zeros(1, 64, 16, 2), 1.0)
    for h in hooks:
        h.remove()
    assert len(shapes) == 19
    for H, W, Cin, Cout, k, d in shapes:
        for ci, co in ((Cin, Cout), (Cout, Cin)):
            p = conv._launch_args(B, H, W, ci, co, k, d, False)[0]
            assert p.smem <= conv.MAX_SMEM_OPTIN
            assert p.threads <= conv.F32_MAX_THREADS


def test_transposed_weight_is_the_flipped_swap_in_kernel_layout():
    w = conv.kernel_layout(torch.randn(5, 3, 3, 3, dtype=torch.float64))
    t = conv.transposed_weight(w)
    assert t.shape == (3, 5, 3, 3) and conv.has_kernel_layout(t)
    assert torch.equal(t, w.flip(2, 3).transpose(0, 1))


@pytest.mark.parametrize("H,W,Cin,Cout,k,d,bias,elu", [
    (8, 2, 6, 4, 3, 1, True, True), (8, 2, 4, 6, 3, 2, True, False),
    (8, 2, 5, 5, 3, 4, False, False), (16, 4, 4, 3, 3, 1, False, True),
    (6, 5, 3, 4, 1, 1, True, True), (12, 6, 2, 4, 3, 1, True, False)])
def test_conv_backward_equals_autograd_in_float64(H, W, Cin, Cout, k, d,
                                                  bias, elu):
    """conv2d_backward (dgrad through conv2d_plain on the transposed
    weight, wgrad over the live taps, the ELU from the output) against
    autograd through the plain conv, float64 on the CPU."""
    g = torch.Generator().manual_seed(H * Cin + d)
    x = torch.randn(3, Cin, H, W, generator=g, dtype=torch.float64)
    w = conv.kernel_layout(torch.randn(Cout, Cin, k, k, generator=g,
                                       dtype=torch.float64))
    b = torch.randn(Cout, generator=g, dtype=torch.float64) if bias else None
    leaves = [t.clone().requires_grad_() for t in (x, w, b) if t is not None]
    out = conv.conv2d_plain(*leaves[:2], leaves[2] if bias else None, d, elu)
    gout = torch.randn(out.shape, generator=g, dtype=torch.float64)
    want = torch.autograd.grad(out, leaves, gout)
    got = conv.conv2d_backward(x, w, bias, d, elu, out.detach(), gout)
    for a, r in zip(got, want):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, r, rtol=1e-12, atol=1e-12)
    assert conv.has_kernel_layout(got[1])
    # a dead tap (dilation past the image) gets exactly zero gradient
    if d >= H or d >= W:
        live = conv._live_window(k, d, H, W)[:2]
        dead = torch.ones_like(got[1], dtype=torch.bool)
        dead[:, :, live[0], live[1]] = False
        assert dead.any() and (got[1][dead] == 0).all()
    none = conv.conv2d_backward(x, w, bias, d, elu, out.detach(), gout,
                                (False, True, False))
    assert none[0] is None and none[2] is None


@pytest.mark.parametrize("elu", [False, True])
@pytest.mark.parametrize("B,C,H,W", [(3, 8, 8, 2), (2, 16, 16, 4),
                                     (2, 4, 5, 3), (1, 2, 4, 4)])
def test_norm_backward_equals_autograd_in_float64(B, C, H, W, elu):
    """instance_norm_plus_backward's closed form against autograd through
    the plain version, float64 on the CPU."""
    g = torch.Generator().manual_seed(C + H)
    f64 = dict(generator=g, dtype=torch.float64)
    x = torch.randn(B, C, H, W, **f64) * 2 + 0.5
    a, gm = 1 + 0.1 * torch.randn(2, C, **f64)
    bt = 0.1 * torch.randn(C, **f64)
    leaves = [t.clone().requires_grad_() for t in (x, a, gm, bt)]
    out = inorm.instance_norm_plus_plain(*leaves, elu=elu)
    gout = torch.randn(out.shape, **f64)
    want = torch.autograd.grad(out, leaves, gout)
    got = inorm.instance_norm_plus_backward(x, a, gm, bt, out.detach(), gout,
                                            elu)
    for p, r in zip(got, want):
        assert p.dtype == torch.float64
        torch.testing.assert_close(p, r, rtol=1e-10, atol=1e-12)
