"""Reading a reference `final_model.pt` into the PyTorch port
(models/convert.py::load_reference_checkpoint) against the JAX package's
models/torch_compat.py::load_reference_checkpoint, on a file the test
writes itself: torch.save of a randomly initialised module's state dict
with the `sigmas` buffer and a config, as train_score.py:211-216 saves
one. No reference weights are needed. Bars: equal parameters, forwards
within 2e-4 relative (tests/test_model_parity.py:92-94).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_based_channels_tpu.config import ModelConfig as JModelConfig
from score_based_channels_tpu.models import make_score_model as jax_model
from score_based_channels_tpu.models.torch_compat import (
    load_reference_checkpoint as jax_load_reference,
)
from score_based_channels_torch.config import ModelConfig
from score_based_channels_torch.diffusion.sigmas import sigmas_from_config
from score_based_channels_torch.models import (
    make_score_model, state_dict_to_jax_params,
)
from score_based_channels_torch.models.convert import (
    load_reference_checkpoint, tree_leaves, tree_paths,
)

torch.set_num_threads(1)

MCFG = dict(ngf=8, num_classes=50)


def _write_reference(path, seed=3, with_sigmas=True):
    """A reference-style final_model.pt: contiguous (O, I, kh, kw) conv
    weights, the sigmas buffer among the model's state, an optimizer state
    and a config, from a random module."""
    src = make_score_model(ModelConfig(**MCFG), device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    state = {k: v.detach().contiguous().clone()
             for k, v in src.state_dict().items()}
    if with_sigmas:
        state["sigmas"] = sigmas_from_config(ModelConfig(**MCFG))
    config = {"model": dict(MCFG, nonlinearity="elu"), "training": {}}
    torch.save({"model_state": state, "optim_state": {"state": {}},
                "config": config}, path)
    return src, state, config


def test_port_and_jax_read_the_same_parameters(tmp_path):
    path = str(tmp_path / "final_model.pt")
    src, written, config = _write_reference(path)
    sd, sigmas, cfg = load_reference_checkpoint(path)
    j_params, j_sigmas, j_cfg = jax_load_reference(path)
    assert "sigmas" not in sd and cfg == j_cfg == config
    np.testing.assert_array_equal(sigmas, j_sigmas)
    np.testing.assert_array_equal(sigmas, written["sigmas"].numpy())
    mine = state_dict_to_jax_params(sd)
    assert tree_paths(mine) == tree_paths(j_params)
    for a, b in zip(tree_leaves(mine), tree_leaves(j_params)):
        np.testing.assert_array_equal(a, b)
    # it loads with strict=True and holds exactly the written parameters
    model = make_score_model(ModelConfig(**MCFG), device="cpu")
    model.load_state_dict(sd, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, src.state_dict()[k]), k


def test_forward_of_the_loaded_checkpoint_matches_jax(tmp_path):
    path = str(tmp_path / "final_model.pt")
    _write_reference(path, seed=5)
    sd, sigmas, _ = load_reference_checkpoint(path)
    model = make_score_model(ModelConfig(**MCFG), device="cpu")
    model.load_state_dict(sd, strict=True)
    j_params, _, _ = jax_load_reference(path)
    jm = jax_model(JModelConfig(**MCFG))
    rng = np.random.RandomState(1)
    x = rng.randn(3, 64, 16, 2).astype(np.float32)
    used = sigmas[[0, 20, 49]]
    want = np.asarray(jm.apply({"params": j_params}, jnp.asarray(x),
                               jnp.asarray(used)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(used)).numpy()
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 2e-4


def test_a_checkpoint_without_sigmas_gives_none(tmp_path):
    path = str(tmp_path / "final_model.pt")
    _write_reference(path, with_sigmas=False)
    sd, sigmas, _ = load_reference_checkpoint(path)
    assert sigmas is None
    assert all(v.dtype == torch.float32 and v.device.type == "cpu"
               for v in sd.values())


def test_a_mismatched_checkpoint_does_not_load(tmp_path):
    path = str(tmp_path / "final_model.pt")
    _write_reference(path)
    sd, _, _ = load_reference_checkpoint(path)
    model = make_score_model(ModelConfig(ngf=8, num_classes=50,
                                         arch="ncsnv2"), device="cpu")
    with pytest.raises(RuntimeError):
        model.load_state_dict(sd, strict=True)
