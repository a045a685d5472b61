"""NCSNv2-Deepest in the PyTorch port against the flax model.

Random flax parameters (ngf=8) are converted with jax_params_to_state_dict
and loaded with strict=True; the forward must match within the JAX
package's model bar, 2e-4 relative (tests/test_model_parity.py).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_based_channels_tpu.config import Config as JConfig
from score_based_channels_tpu.config import ModelConfig as JModelConfig
from score_based_channels_tpu.models import make_score_model as jax_model
from score_based_channels_tpu.utils.checkpoint import save_checkpoint
from score_based_channels_torch.config import ModelConfig
from score_based_channels_torch.eval.estimate import score_fn_from_params
from score_based_channels_torch.kernels import conv, instance_norm
from score_based_channels_torch.models import (
    jax_params_to_state_dict, make_score_model,
)
from score_based_channels_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    jm = jax_model(JModelConfig(ngf=8, num_classes=50))
    params = jm.init(jax.random.key(0), jnp.zeros((1, 64, 16, 2)),
                     jnp.float32(1.0))["params"]
    tm = make_score_model(ModelConfig(ngf=8, num_classes=50), device="cpu")
    tm.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return jm, params, tm


def _inputs(seed=1, B=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, 64, 16, 2).astype(np.float32)
    sig = np.array([0.05, 0.7, 2.3, 20.0][:B], np.float32)
    return x, sig


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def test_forward_matches_flax(pair):
    jm, params, tm = pair
    x, sig = _inputs()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               jnp.asarray(sig)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(sig)).numpy()
    assert _rel(got, want) < 2e-4


def test_jax_checkpoint_reads_into_the_port(pair, tmp_path):
    jm, params, _ = pair
    cfg = JConfig(model=JModelConfig(ngf=8, num_classes=50))
    path = str(tmp_path / "ck.npz")
    ema = jax.tree.map(lambda p: p * 0.5, params)
    save_checkpoint(path, cfg, params, ema_params=ema, metadata={"step": 7})
    ck = load_checkpoint(path)
    assert ck["config"].to_dict() == cfg.to_dict()
    assert ck["metadata"] == {"step": 7}
    tm = make_score_model(ck["config"].model, device="cpu")
    tm.load_state_dict(jax_params_to_state_dict(ck["ema"]), strict=True)
    x, sig = _inputs(2)
    want = np.asarray(jm.apply({"params": ema}, jnp.asarray(x),
                               jnp.asarray(sig)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(sig)).numpy()
    assert _rel(got, want) < 2e-4


def test_full_size_parameter_count():
    model = make_score_model(ModelConfig(), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 5_890_082


def test_bf16_tracks_f32_and_returns_f32(pair):
    _, _, tm = pair
    x = torch.from_numpy(_inputs(3)[0])
    sigma = torch.tensor(0.7)
    f32 = score_fn_from_params(tm)(x, sigma)
    b16 = score_fn_from_params(tm, dtype=torch.bfloat16)(x, sigma)
    assert b16.dtype == torch.float32
    rel = float(torch.linalg.norm(b16 - f32) / torch.linalg.norm(f32))
    assert rel < 0.05, f"bf16 forward deviates {rel:.3%} from f32"
    assert next(tm.parameters()).dtype == torch.float32  # cast into a copy


def test_forward_runs_113_convs_and_25_norms_channels_last(pair, monkeypatch):
    """Every conv and norm of a forward goes through the kernel wrappers,
    on channels-last activations, in the counts the card must show."""
    _, _, tm = pair
    seen = collections.Counter()
    for mod, name in ((conv, "conv2d_plain"),
                      (instance_norm, "instance_norm_plus_plain")):
        orig = getattr(mod, name)

        def spy(x, *a, _orig=orig, _name=name, **k):
            assert x.is_contiguous(memory_format=torch.channels_last), _name
            seen[_name] += 1
            return _orig(x, *a, **k)

        monkeypatch.setattr(mod, name, spy)
    with torch.no_grad():
        tm(torch.from_numpy(_inputs(4, B=2)[0]), 1.0)
    assert seen == {"conv2d_plain": 113, "instance_norm_plus_plain": 25}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_gives_the_kernels_what_they_take(pair, monkeypatch, dtype):
    """Through score_fn_from_params (load_state_dict, deepcopy, cast), every
    conv and norm call passes the checks the card's wrappers make before a
    launch: the weight in the kernel's layout, one dtype for activation and
    parameters."""
    _, _, tm = pair
    seen = collections.Counter()
    for mod, name in ((conv, "conv2d_plain"),
                      (instance_norm, "instance_norm_plus_plain")):
        orig = getattr(mod, name)

        def spy(x, *a, _orig=orig, _mod=mod, **k):
            _mod._check_cuda(x, *(t for t in a[:3]
                                  if isinstance(t, torch.Tensor)))
            seen[_mod.__name__] += 1
            return _orig(x, *a, **k)

        monkeypatch.setattr(mod, name, spy)
    score_fn_from_params(tm, dtype)(torch.from_numpy(_inputs(5, B=2)[0]), 1.0)
    assert sorted(seen.values()) == [25, 113]


def test_other_archs_are_refused():
    with pytest.raises(ValueError, match="unknown arch"):
        make_score_model(ModelConfig(arch="ncsnv3"), device="cpu")
