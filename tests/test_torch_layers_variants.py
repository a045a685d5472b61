"""The activations and norms that the config chooses (models/layers.py
get_act / get_normalization), the unused pooling blocks, and the NCSNv2
archs built with them, in the PyTorch port against the JAX package.

Bars: activations rtol 1e-5 / atol 1e-6 and norms rtol 1e-4 / atol 1e-5
(tests/test_model_parity.py:159,174-175); blocks and forwards 2e-4
relative (tests/test_model_parity.py:92-94). Parameters are the port's
random init carried to flax by the converter (a flax init of a network
takes ~20 s on the CPU).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from score_based_channels_tpu.config import Config as JConfig
from score_based_channels_tpu.config import ModelConfig as JModelConfig
from score_based_channels_tpu.diffusion.sampling import (
    annealed_langevin_posterior_c2 as jax_sampler,
)
from score_based_channels_tpu.eval.estimate import (
    score_fn_from_params as jax_score_fn,
)
from score_based_channels_tpu.kernels.fused_forward import (
    fused_forward as jax_fused_forward,
)
from score_based_channels_tpu.models import layers as jl
from score_based_channels_tpu.models import make_score_model as jax_model
from score_based_channels_tpu.utils.checkpoint import save_checkpoint
from score_based_channels_torch.config import ModelConfig
from score_based_channels_torch.diffusion.sigmas import get_sigmas
from score_based_channels_torch.eval.estimate import (
    langevin_chunked, load_score_fn,
)
from score_based_channels_torch.kernels import conv as conv_kernel
from score_based_channels_torch.kernels import counts, reset_counts
from score_based_channels_torch.kernels.fused_forward import fused_forward
from score_based_channels_torch.models import (
    jax_params_to_state_dict, make_score_model, state_dict_to_jax_params,
)
from score_based_channels_torch.models import layers as tl
from score_based_channels_torch.models.convert import tree_paths

torch.set_num_threads(1)

ACTS = ["elu", "relu", "lrelu", "swish"]
NORMS = ["InstanceNorm++", "InstanceNorm", "VarianceNorm", "None"]
ARCHS = ["ncsnv2", "ncsnv2_deeper", "ncsnv2_deepest"]
# each arch with relu (InstanceNorm++) and with each other norm (ELU), and
# the two other activations on the channel-estimation network
VARIANTS = ([(a, "relu", "InstanceNorm++") for a in ARCHS]
            + [(a, "elu", n) for a in ARCHS for n in NORMS[1:]]
            + [("ncsnv2_deepest", act, "InstanceNorm++")
               for act in ("lrelu", "swish")])


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _nchw(x_nhwc):
    """NHWC numpy -> the port's NCHW tensor in channels_last memory."""
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("act", ACTS)
def test_activation_matches_jax(act):
    x = np.linspace(-3, 3, 101).astype(np.float32)
    want = np.asarray(jl.get_act(act)(jnp.asarray(x)))
    got = tl.get_act(act)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_unknown_activation_and_norm_are_refused():
    with pytest.raises(NotImplementedError):
        tl.get_act("gelu")
    with pytest.raises(NotImplementedError):
        tl.get_normalization("GroupNorm")
    with pytest.raises(NotImplementedError):
        make_score_model(ModelConfig(ngf=4, nonlinearity="tanh"), device="cpu")


def _norm_pair(norm, C, seed):
    """The JAX norm's params (random) and the port's module holding them."""
    rng = np.random.RandomState(seed)
    jmod = jl.get_normalization(norm)(C)
    init = jmod.init(jax.random.key(0), jnp.zeros((1, 4, 4, C)))
    params = jax.tree.map(
        lambda a: (1 + 0.3 * rng.randn(*a.shape)).astype(np.float32),
        dict(init.get("params", {})))
    tmod = tl.get_normalization(norm)(C)
    tmod.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return jmod, params, tmod


@pytest.mark.parametrize("norm", NORMS)
def test_norm_matches_jax(norm):
    jmod, params, tmod = _norm_pair(norm, 8, 3)
    x = (np.random.RandomState(0).randn(3, 6, 4, 8) * 2 + 0.5).astype(np.float32)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
        fused = _nhwc(tmod(_nchw(x), elu=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # elu=True is ELU after the norm (the fused kernel on the card)
    np.testing.assert_allclose(fused, np.asarray(jax.nn.elu(want)),
                               rtol=1e-4, atol=1e-5)
    # the same parameter names both ways
    assert tree_paths(state_dict_to_jax_params(tmod.state_dict())) == \
        tree_paths(params)


@pytest.mark.parametrize("norm", ["InstanceNorm", "VarianceNorm"])
def test_plain_norm_keeps_the_activation_dtype(norm):
    _, _, tmod = _norm_pair(norm, 4, 1)
    x = _nchw(np.random.RandomState(2).randn(2, 5, 3, 4).astype(np.float32))
    with torch.no_grad():
        out = tmod.to(torch.bfloat16)(x.to(torch.bfloat16))
        want = tmod.float()(x)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), want, rtol=2e-2, atol=2e-2)


def test_avg_pool_5x5_matches_jax():
    x = np.random.RandomState(4).randn(2, 7, 5, 3).astype(np.float32)
    want = np.asarray(jl.avg_pool_5x5(jnp.asarray(x)))
    got = _nhwc(tl.avg_pool_5x5(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,bias", [("MeanPoolConv", True),
                                       ("MeanPoolConv", False),
                                       ("UpsampleConv", True),
                                       ("UpsampleConv", False)])
def test_resampling_conv_matches_jax(name, bias):
    x = np.random.RandomState(5).randn(2, 8, 4, 3).astype(np.float32)
    jmod = getattr(jl, name)(6, 3, use_bias=bias)
    params = jmod.init(jax.random.key(1), jnp.asarray(x))["params"]
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = getattr(tl, name)(3, 6, 3, bias=bias)
    tmod.load_state_dict(jax_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    assert got.shape == want.shape
    assert _rel(got, want) < 2e-4


@pytest.mark.parametrize("act", ["relu", "swish"])
def test_crp_with_mean_pooling_matches_jax(act):
    x = np.random.RandomState(6).randn(2, 8, 4, 5).astype(np.float32)
    jmod = jl.CRPBlock(5, n_stages=2, act=jl.get_act(act), maxpool=False)
    params = jmod.init(jax.random.key(2), jnp.asarray(x))["params"]
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = tl.CRPBlock(5, n_stages=2, act=tl.get_act(act), maxpool=False)
    tmod.load_state_dict(jax_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    assert _rel(got, want) < 2e-4


def _inputs(seed=1, B=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, 64, 16, 2).astype(np.float32)
    sig = np.array([0.05, 0.7, 20.0][:B], np.float32)
    return x, sig


def _pair(arch, act, norm, seed=0):
    """The port's model (random init from `seed`) and its flax twin."""
    cfg = dict(arch=arch, ngf=8, num_classes=50, nonlinearity=act,
               normalization=norm)
    tm = make_score_model(ModelConfig(**cfg), device="cpu",
                          generator=torch.Generator().manual_seed(seed))
    params = state_dict_to_jax_params(tm.state_dict())
    return tm, jax_model(JModelConfig(**cfg)), params


@pytest.mark.parametrize("arch,act,norm", VARIANTS)
def test_variant_forward_matches_jax(arch, act, norm):
    tm, jm, params = _pair(arch, act, norm)
    # the JAX tree of this config has the port's names, leaf for leaf
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 64, 16, 2)), jnp.float32(1.0)))
    assert tree_paths(params) == tree_paths(shapes["params"])
    x, sig = _inputs()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               jnp.asarray(sig)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(sig)).numpy()
    assert _rel(got, want) < 2e-4


@pytest.mark.parametrize("act,norm,n_norm", [
    ("elu", "InstanceNorm++", 25), ("relu", "InstanceNorm++", 25),
    ("elu", "VarianceNorm", 1), ("swish", "None", 1)])
def test_variant_forward_calls_the_kernels(act, norm, n_norm):
    """113 convs a forward whatever the variant; InstanceNorm++ only where
    the norm is InstanceNorm++ (the final normalizer always is). On the
    CPU the wrappers count their plain calls."""
    m = make_score_model(ModelConfig(ngf=4, nonlinearity=act,
                                     normalization=norm), device="cpu")
    fused = {"conv": 0, "norm": 0}
    for mod in m.modules():
        if isinstance(mod, (tl.Conv2d, tl.InstanceNorm2dPlus)):
            key = "conv" if isinstance(mod, tl.Conv2d) else "norm"
            mod.register_forward_pre_hook(
                lambda _m, a, kw, k=key: fused.__setitem__(
                    k, fused[k] + bool(kw.get("elu"))), with_kwargs=True)
    reset_counts()
    with torch.no_grad():
        m(torch.zeros(2, 64, 16, 2), 1.0)
    c = counts()
    assert c["conv2d_taps"]["plain"] == 113
    assert c["instance_norm_plus"]["plain"] == n_norm
    # ELU rides on the kernels; another activation never asks them for it
    if act == "elu":
        assert fused["norm"] == n_norm and fused["conv"] > 0
    else:
        assert fused == {"conv": 0, "norm": 0}


def test_default_forward_is_unchanged():
    """The default ELU / InstanceNorm++ model fuses ELU as before: 25 norms
    and the first conv of each RCU stage pair take elu=True."""
    m = make_score_model(ModelConfig(ngf=4), device="cpu")
    seen = []
    for mod in m.modules():
        if isinstance(mod, (tl.Conv2d, tl.InstanceNorm2dPlus)):
            mod.register_forward_pre_hook(
                lambda _m, a, kw, t=type(mod).__name__: seen.append(
                    (t, kw.get("elu", False))), with_kwargs=True)
    with torch.no_grad():
        m(torch.zeros(1, 64, 16, 2), 1.0)
    assert seen.count(("InstanceNorm2dPlus", True)) == 25
    assert seen.count(("Conv2d", True)) == 30  # one an RCU block
    assert len(seen) == 138


@pytest.mark.parametrize("act", ["relu", "lrelu"])
def test_fused_forward_threads_the_activation(act):
    """The port's fused_forward with act equals the module forward of the
    same config, and the JAX model of that config."""
    tm, jm, params = _pair("ncsnv2_deepest", act, "InstanceNorm++", seed=4)
    x, sig = _inputs(2)
    with torch.no_grad():
        want = tm(torch.from_numpy(x), torch.from_numpy(sig))
        got = fused_forward(tm.state_dict(), torch.from_numpy(x),
                            torch.from_numpy(sig), act=tl.get_act(act))
    assert conv_kernel.has_kernel_layout(tm.begin_conv.weight)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    jwant = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                                jnp.asarray(sig)))
    assert _rel(got.numpy(), jwant) < 2e-4


def test_jax_fused_forward_keeps_elu_in_its_deep_segment():
    """A deviation of the reference, recorded: the JAX fused_forward calls
    its segment without `act` (kernels/fused_forward.py:217 of the JAX
    package), so with act=relu its 8x2 segment still runs ELU and it
    departs from the JAX model of that config. The port threads act into
    the segment and matches the model (test above)."""
    tm, jm, params = _pair("ncsnv2_deepest", "relu", "InstanceNorm++", seed=4)
    x, sig = _inputs(2)
    model = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                                jnp.asarray(sig)))
    jfused = np.asarray(jax_fused_forward(params, jnp.asarray(x),
                                          jnp.asarray(sig), act=jax.nn.relu))
    with torch.no_grad():
        port = fused_forward(tm.state_dict(), torch.from_numpy(x),
                             torch.from_numpy(sig), act=F.relu).numpy()
    assert _rel(port, model) < 2e-4
    assert _rel(jfused, model) > 1e-3


@pytest.mark.parametrize("act,norm", [("relu", "VarianceNorm"),
                                      ("swish", "InstanceNorm")])
def test_jax_checkpoint_of_a_variant_estimates_as_jax_at_beta0(tmp_path, act,
                                                               norm):
    """A JAX checkpoint with a non-default config loads into the port's
    estimate path (load_score_fn -> langevin_chunked) and gives the JAX
    sampler's trace at beta 0 (deterministic), on the same inputs."""
    L, B, steps = 6, 4, 2
    cfg = JConfig(model=JModelConfig(ngf=8, num_classes=L, nonlinearity=act,
                                     normalization=norm))
    tm, jm, params = _pair("ncsnv2_deepest", act, norm, seed=7)
    jm = jax_model(cfg.model)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, cfg, params)
    config, score_fn = load_score_fn(path, "cpu")
    assert (config.model.nonlinearity, config.model.normalization) == (act,
                                                                       norm)
    rng = np.random.RandomState(0)
    X = (rng.randn(B, 64, 16, 2) * np.sqrt(0.5)).astype(np.float32)
    A = (np.sign(rng.randn(B, 38, 64, 2)) * np.sqrt(0.5)).astype(np.float32)
    Y = np.asarray(jax.vmap(lambda a, x: jnp.stack([
        a[..., 0] @ x[..., 0] - a[..., 1] @ x[..., 1],
        a[..., 0] @ x[..., 1] + a[..., 1] @ x[..., 0]], -1))(A, X))
    x0 = (rng.randn(B, 64, 16, 2) * np.sqrt(0.5)).astype(np.float32)
    npow = np.float32(0.64)
    sig = get_sigmas(cfg.model.sigma_begin, cfg.model.sigma_end, L)
    _, want = jax_sampler(jax_score_fn(jm, params), jnp.asarray(A),
                          jnp.asarray(Y), jnp.asarray(sig.numpy()), npow,
                          jnp.asarray(x0), jax.random.key(0),
                          alpha_step=5e-7, beta_noise=0.0, steps_each=steps,
                          oracle=jnp.asarray(X))
    _, got = langevin_chunked(score_fn, *(torch.tensor(t) for t in
                                          (A, Y)), sig, float(npow),
                              torch.from_numpy(x0), seed=0, alpha_step=5e-7,
                              beta_noise=0.0, steps_each=steps,
                              oracle2=torch.from_numpy(X), device="cpu")
    want = np.asarray(want)
    assert got.shape == want.shape == (L * steps, B)
    assert _rel(got, want) < 1e-5


def test_variant_trains_on_the_cpu():
    """A non-default config trains (plain torch norms under autograd)."""
    from score_based_channels_torch.config import (
        Config, DataConfig, TrainingConfig,
    )
    from score_based_channels_torch.train import ScoreTrainer

    cfg = Config(model=ModelConfig(ngf=4, num_classes=10, nonlinearity="swish",
                                   normalization="VarianceNorm"),
                 data=DataConfig(num_channels=8),
                 training=TrainingConfig(batch_size=4, n_epochs=1,
                                         log_every_steps=2))
    state, logs = ScoreTrainer(cfg, device="cpu").train(log_fn=lambda s: None)
    assert state.step == 2 and np.isfinite(logs["train_loss"]).all()
    assert dataclasses.asdict(cfg.model)["normalization"] == "VarianceNorm"
