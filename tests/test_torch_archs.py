"""NCSNv2 and NCSNv2Deeper (and NCSNv2Deepest, through the same code) in
the PyTorch port against the flax models.

Random flax parameters (ngf=8) are converted and loaded with strict=True;
each forward must match within the JAX package's model bar, 2e-4 relative
(tests/test_model_parity.py:92-94). The training and estimation entry
points take the arch from the config and from the checkpoint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_based_channels_tpu.config import Config as JConfig
from score_based_channels_tpu.config import ModelConfig as JModelConfig
from score_based_channels_tpu.models import make_score_model as jax_model
from score_based_channels_tpu.utils.checkpoint import save_checkpoint
from score_based_channels_torch.config import (
    Config, DataConfig, ModelConfig, TrainingConfig,
)
from score_based_channels_torch.eval.estimate import load_score_fn
from score_based_channels_torch.models import (
    NCSNv2, NCSNv2Deeper, NCSNv2Deepest, jax_params_to_state_dict,
    make_score_model, state_dict_to_jax_params,
)
from score_based_channels_torch.models.convert import tree_paths
from score_based_channels_torch.train import ScoreTrainer

torch.set_num_threads(1)

ARCHS = {"ncsnv2": NCSNv2, "ncsnv2_deeper": NCSNv2Deeper,
         "ncsnv2_deepest": NCSNv2Deepest}
# (params at ngf 32, convs and norms of one forward), counted on the CPU
CENSUS = {"ncsnv2": (1_859_554, 75, 17), "ncsnv2_deeper": (5_221_218, 94, 21),
          "ncsnv2_deepest": (5_890_082, 113, 25)}


def _inputs(seed=1, B=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, 64, 16, 2).astype(np.float32)
    sig = np.array([0.05, 0.7, 2.3, 20.0][:B], np.float32)
    return x, sig


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module", params=sorted(ARCHS))
def pair(request):
    arch = request.param
    jm = jax_model(JModelConfig(arch=arch, ngf=8, num_classes=50))
    params = jm.init(jax.random.key(0), jnp.zeros((1, 64, 16, 2)),
                     jnp.float32(1.0))["params"]
    tm = make_score_model(ModelConfig(arch=arch, ngf=8, num_classes=50),
                          device="cpu")
    tm.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return arch, jm, params, tm


def test_make_score_model_builds_each_arch(pair):
    arch, _, _, tm = pair
    assert type(tm) is ARCHS[arch]


def test_forward_matches_flax(pair):
    _, jm, params, tm = pair
    x, sig = _inputs()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               jnp.asarray(sig)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(sig)).numpy()
    assert _rel(got, want) < 2e-4


def test_parameter_names_round_trip(pair):
    """The port's state dict maps onto the flax tree leaf for leaf (res5_*
    of NCSNv2Deeper, res1..res4 and refine1..refine4 of NCSNv2) and back."""
    _, _, params, tm = pair
    back = state_dict_to_jax_params(tm.state_dict())
    assert tree_paths(back) == tree_paths(jax.tree.map(np.asarray, params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_jax_checkpoint_reads_into_the_port(pair, tmp_path):
    arch, jm, params, _ = pair
    cfg = JConfig(model=JModelConfig(arch=arch, ngf=8, num_classes=50))
    path = str(tmp_path / "ck.npz")
    ema = jax.tree.map(lambda p: p * 0.5, params)
    save_checkpoint(path, cfg, params, ema_params=ema)
    config, score_fn = load_score_fn(path, "cpu")
    assert config.model.arch == arch
    x, sig = _inputs(2)
    want = np.asarray(jm.apply({"params": ema}, jnp.asarray(x),
                               jnp.asarray(sig)))
    got = score_fn(torch.from_numpy(x), torch.from_numpy(sig)).numpy()
    assert _rel(got, want) < 2e-4


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_full_width_census(arch):
    """Parameters, convs and norms of one forward at the config's ngf 32:
    the counts the card's launch checks hold the kernels to."""
    from score_based_channels_torch.models.layers import (
        Conv2d, InstanceNorm2dPlus,
    )

    m = make_score_model(ModelConfig(arch=arch), device="cpu")
    seen = {"conv": 0, "norm": 0}
    for mod in m.modules():
        kind = ("conv" if isinstance(mod, Conv2d) else "norm"
                if isinstance(mod, InstanceNorm2dPlus) else None)
        if kind:
            mod.register_forward_pre_hook(
                lambda *a, k=kind: seen.__setitem__(k, seen[k] + 1))
    with torch.no_grad():
        out = m(torch.zeros(1, 64, 16, 2), 1.0)
    assert out.shape == (1, 64, 16, 2)
    assert (sum(p.numel() for p in m.parameters()), seen["conv"],
            seen["norm"]) == CENSUS[arch]


@pytest.mark.parametrize("arch", ["ncsnv2", "ncsnv2_deeper"])
def test_trainer_and_estimate_take_the_arch_from_the_config(arch, tmp_path):
    cfg = Config(model=ModelConfig(arch=arch, ngf=8, num_classes=50),
                 data=DataConfig(num_channels=8),
                 training=TrainingConfig(batch_size=4, n_epochs=1,
                                         log_every_steps=2))
    path = str(tmp_path / "ck.npz")
    state, logs = ScoreTrainer(cfg, device="cpu").train(
        checkpoint_path=path, log_fn=lambda s: None)
    assert type(state.model) is ARCHS[arch] and state.step == 2
    assert np.isfinite(logs["train_loss"]).all()
    config, score_fn = load_score_fn(path, "cpu")
    assert config.model.arch == arch
    x, sig = _inputs(3, B=2)
    with torch.no_grad():
        want = state.ema(torch.from_numpy(x), torch.from_numpy(sig))
    got = score_fn(torch.from_numpy(x), torch.from_numpy(sig))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
