"""The port's unconditional, inpainting and interpolation samplers and the
complex posterior wrapper against the JAX package's.

The JAX draws are rebuilt from the same jax.random splits the JAX
samplers make (diffusion/sampling.py:224-231, 266-274, 309-320; the
posterior core's :143-146) and injected through noise_fn; the score is a
small NCSNv2 (ngf 4) with the same parameters in both packages. Bar: 1e-5
of the largest magnitude, room for the f32 round-off of two conv orders
over the steps of a short schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_based_channels_tpu import cplx as jcplx
from score_based_channels_tpu.config import ModelConfig as JModelConfig
from score_based_channels_tpu.diffusion import sampling as jsampling
from score_based_channels_tpu.models import make_score_model as jax_model
from score_based_channels_torch.config import ModelConfig
from score_based_channels_torch.diffusion import (
    annealed_langevin_inpainting, annealed_langevin_interpolation,
    annealed_langevin_posterior, annealed_langevin_unconditional,
    get_sigmas,
)
from score_based_channels_torch.models import (
    jax_params_to_state_dict, make_score_model,
)

torch.set_num_threads(1)

TOL = 1e-5
B, L, STEPS = 2, 3, 2
SIGMAS = np.asarray(get_sigmas(2.0, 0.1, L), np.float32)
STEP_LR = 2e-3


@pytest.fixture(scope="module")
def scores():
    cfg = dict(arch="ncsnv2", ngf=4, num_classes=L)
    jm = jax_model(JModelConfig(**cfg))
    params = jm.init(jax.random.key(0), jnp.zeros((1, 64, 16, 2)),
                     jnp.float32(1.0))["params"]
    tm = make_score_model(ModelConfig(**cfg), device="cpu")
    tm.load_state_dict(jax_params_to_state_dict(params), strict=True)
    jfn = lambda x, s: jm.apply({"params": params}, x, s)
    return jfn, torch.no_grad()(lambda x, s: tm(x, s))


def _x0(seed, n=B):
    return np.random.RandomState(seed).randn(n, 64, 16, 2).astype(np.float32)


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)))
                 / np.max(np.abs(np.asarray(b))))


def _replay(key, n_split, shapes):
    """{(level, step): draws} of a JAX sampler whose inner step splits its
    carried key into n_split and draws `shapes` from the last keys."""
    out = {}
    for lvl in range(L):
        for i in range(STEPS):
            ks = jax.random.split(key, n_split)
            key = ks[0]
            out[(lvl, i)] = tuple(
                torch.from_numpy(np.array(jax.random.normal(k, s)))
                for k, s in zip(ks[1:], shapes))
    return lambda lvl, i: out[(lvl, i)]


@pytest.mark.parametrize("denoise", [True, False])
def test_unconditional_matches_jax(scores, denoise):
    jfn, tfn = scores
    x0, key = _x0(1), jax.random.key(3)
    want = jsampling.annealed_langevin_unconditional(
        jfn, jnp.asarray(x0), jnp.asarray(SIGMAS), key, n_steps_each=STEPS,
        step_lr=STEP_LR, denoise=denoise)
    got = annealed_langevin_unconditional(
        tfn, torch.from_numpy(x0), torch.from_numpy(SIGMAS),
        n_steps_each=STEPS, step_lr=STEP_LR, denoise=denoise,
        noise_fn=_replay(key, 2, [x0.shape]))
    assert _rel(got, want) < TOL


def test_inpainting_matches_jax(scores):
    jfn, tfn = scores
    x0, refer, key = _x0(4), _x0(5), jax.random.key(6)
    mask = np.zeros((1, 64, 16, 1), np.float32)
    mask[:, :, :8] = 1.0  # the known half
    want = jsampling.annealed_langevin_inpainting(
        jfn, jnp.asarray(x0), jnp.asarray(refer), jnp.asarray(mask),
        jnp.asarray(SIGMAS), key, n_steps_each=STEPS, step_lr=STEP_LR)
    got = annealed_langevin_inpainting(
        tfn, torch.from_numpy(x0), torch.from_numpy(refer),
        torch.from_numpy(mask), torch.from_numpy(SIGMAS), n_steps_each=STEPS,
        step_lr=STEP_LR, noise_fn=_replay(key, 3, [refer.shape, x0.shape]))
    assert _rel(got, want) < TOL


def test_interpolation_matches_jax(scores):
    jfn, tfn = scores
    x0, key, ni = _x0(7), jax.random.key(8), 3
    want = jsampling.annealed_langevin_interpolation(
        jfn, jnp.asarray(x0), jnp.asarray(SIGMAS), key, n_interpolations=ni,
        n_steps_each=STEPS, step_lr=STEP_LR)
    got = annealed_langevin_interpolation(
        tfn, torch.from_numpy(x0), torch.from_numpy(SIGMAS),
        n_interpolations=ni, n_steps_each=STEPS, step_lr=STEP_LR,
        noise_fn=_replay(key, 3, [x0.shape, x0.shape]))
    assert got.shape == (B * ni, 64, 16, 2)
    assert _rel(got, want) < TOL


def test_complex_posterior_wrapper_matches_jax(scores):
    jfn, tfn = scores
    rng = np.random.RandomState(9)
    cx = lambda *s: (rng.randn(*s) + 1j * rng.randn(*s)).astype(np.complex64)
    X, x0 = cx(B, 64, 16), cx(B, 64, 16)
    A = cx(B, 20, 64) / 8
    Y = np.einsum("bpt,btr->bpr", A, X)
    key = jax.random.key(10)
    want_x, want_tr = jsampling.annealed_langevin_posterior(
        jfn, jnp.asarray(A), jnp.asarray(Y), jnp.asarray(SIGMAS), 0.1,
        jnp.asarray(x0), key, alpha_step=1e-3, beta_noise=0.5,
        steps_each=STEPS, oracle=jnp.asarray(X))
    draws, k = {}, key
    for lvl in range(L):  # sampling.py:143-146
        for i in range(STEPS):
            k, kn = jax.random.split(k)
            draws[(lvl, i)] = torch.from_numpy(
                np.array(jcplx.randn(kn, (B, 64, 16))))
    got_x, got_tr = annealed_langevin_posterior(
        tfn, torch.from_numpy(A), torch.from_numpy(Y),
        torch.from_numpy(SIGMAS), 0.1, torch.from_numpy(x0),
        alpha_step=1e-3, beta_noise=0.5, steps_each=STEPS,
        oracle=torch.from_numpy(X), noise_fn=lambda l, i: draws[(l, i)])
    assert got_x.dtype == torch.complex64 and got_x.shape == X.shape
    assert _rel(got_x.numpy(), np.asarray(want_x)) < TOL
    assert _rel(got_tr.numpy(), np.asarray(want_tr)) < TOL


def test_samplers_draw_from_a_generator(scores):
    _, tfn = scores
    x0 = torch.from_numpy(_x0(11))
    sig = torch.from_numpy(SIGMAS)
    runs = [annealed_langevin_interpolation(
        tfn, x0, sig, torch.Generator().manual_seed(s), n_interpolations=2,
        n_steps_each=1) for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    out = annealed_langevin_inpainting(
        tfn, x0, x0, 1.0, sig, torch.Generator().manual_seed(0),
        n_steps_each=1)
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError, match="Generator"):
        annealed_langevin_unconditional(tfn, x0, sig, n_steps_each=1)
