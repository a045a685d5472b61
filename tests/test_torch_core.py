"""The port's c2 algebra, physics, sigma schedules, config, channel files and
dataset, LMMSE covariance and parameter converter against the JAX package.

The same numpy inputs go through both packages. Deterministic functions
agree to float32 round-off (1e-6) or exactly where both compute the same
numpy expression; random draws come from different generators, so they
are compared by their statistics.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_based_channels_tpu import config as jconfig
from score_based_channels_tpu import cplx as jcplx
from score_based_channels_tpu import physics as jphysics
from score_based_channels_tpu.baselines.lmmse import (
    empirical_covariance as jax_covariance,
)
from score_based_channels_tpu.data.dataset import ChannelDataset as JDataset
from score_based_channels_tpu.data.io import load_output_h as jax_load
from score_based_channels_tpu.diffusion import sigmas as jsigmas
from score_based_channels_tpu.models.torch_compat import (
    flax_params_to_torch_state_dict, torch_state_dict_to_flax,
)
from score_based_channels_torch import config, cplx, physics
from score_based_channels_torch.baselines.lmmse import empirical_covariance
from score_based_channels_torch.data.dataset import ChannelDataset
from score_based_channels_torch.data.io import load_output_h, save_output_h
from score_based_channels_torch.diffusion import sigmas
from score_based_channels_torch.models import (
    jax_params_to_state_dict, make_score_model,
)

torch.set_num_threads(1)

PROFILES = ["CDL-A", "CDL-B", "CDL-C", "CDL-D", "CDL-E"]


@pytest.mark.parametrize("profile", PROFILES)
def test_config_matches_jax(profile):
    want = jconfig.default_score_config(profile, ray_coupling="fixed")
    got = config.default_score_config(profile, ray_coupling="fixed")
    assert got.to_dict() == want.to_dict()
    assert config.Config.from_json(want.to_json()) == got
    assert got.model.sigma_end == want.model.sigma_end
    assert got.data.image_size == want.data.image_size


CPLX_OPS = {
    "matmul": lambda m, a, b, s: m.matmul(a, b),
    "conj_transpose": lambda m, a, b, s: m.conj_transpose(a),
    "sum_abs2": lambda m, a, b, s: m.sum_abs2(b, (-1, -2)),
    "scale": lambda m, a, b, s: m.scale(b, s),
    "nmse": lambda m, a, b, s: m.nmse(m.scale(b, s), b),
}


@pytest.mark.parametrize("op", sorted(CPLX_OPS))
def test_cplx_matches_jax(op):
    rng = np.random.RandomState(1)
    a = rng.randn(3, 5, 7, 2).astype(np.float32)
    b = rng.randn(3, 7, 4, 2).astype(np.float32)
    s = rng.rand(3, 1, 1).astype(np.float32)
    fn = CPLX_OPS[op]
    want = np.asarray(fn(jcplx, jnp.asarray(a), jnp.asarray(b), jnp.asarray(s)))
    got = fn(cplx, *map(torch.from_numpy, (a, b, s))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_cplx_complex_round_trip_matches_jax():
    rng = np.random.RandomState(2)
    z = (rng.randn(4, 6) + 1j * rng.randn(4, 6)).astype(np.complex64)
    c2 = cplx.from_complex(z)
    np.testing.assert_array_equal(c2.numpy(), np.asarray(jcplx.from_complex(z)))
    np.testing.assert_array_equal(cplx.to_complex(c2), z)


def test_cplx_draws_have_the_jax_statistics():
    g = torch.Generator().manual_seed(0)
    z = cplx.randn(g, (4096, 64))
    assert z.shape == (4096, 64, 2) and z.dtype == torch.float32
    assert abs(float(cplx.abs2(z).mean()) - 1.0) < 0.01  # unit power
    assert abs(float(z[..., 0].var()) - 0.5) < 0.01
    assert abs(float((z[..., 0] * z[..., 1]).mean())) < 0.01  # circular
    p = cplx.qpsk_pilots(g, 16, 64, 38)
    assert p.shape == (16, 64, 38, 2)
    np.testing.assert_allclose(p.abs().numpy(), np.sqrt(0.5), rtol=1e-6)
    assert abs(float(p.mean())) < 0.02
    # the JAX pilots take the same values
    jp = np.asarray(jcplx.qpsk_pilots(jax.random.key(0), 2, 8, 4))
    np.testing.assert_allclose(np.unique(np.abs(jp)), np.sqrt(0.5), rtol=1e-6)


def test_physics_matches_jax():
    snr = np.array([-10.0, 0.0, 12.5, 30.0])
    np.testing.assert_allclose(physics.snr_to_noise_power(snr, 64),
                               np.asarray(jphysics.snr_to_noise_power(snr, 64)),
                               rtol=1e-6)
    rng = np.random.RandomState(3)
    est = (rng.randn(5, 8, 4) + 1j * rng.randn(5, 8, 4)).astype(np.complex64)
    ora = (rng.randn(5, 8, 4) + 1j * rng.randn(5, 8, 4)).astype(np.complex64)
    np.testing.assert_allclose(
        physics.nmse(torch.from_numpy(est), torch.from_numpy(ora)).numpy(),
        np.asarray(jphysics.nmse(jnp.asarray(est), jnp.asarray(ora))),
        rtol=1e-6)


def test_measure_c2_is_the_jax_product_plus_noise_of_the_given_power():
    rng = np.random.RandomState(4)
    A = rng.randn(4, 64, 32, 2).astype(np.float32)
    X = rng.randn(4, 32, 64, 2).astype(np.float32)
    npow = np.array([0.0, 0.1, 1.0, 4.0], np.float32)
    g = torch.Generator().manual_seed(1)
    Y = physics.measure_c2(g, torch.from_numpy(A), torch.from_numpy(X),
                           torch.from_numpy(npow)).numpy()
    AX = np.asarray(jcplx.matmul(jnp.asarray(A), jnp.asarray(X)))
    np.testing.assert_allclose(Y[0], AX[0], rtol=1e-5, atol=1e-4)
    power = ((Y - AX) ** 2).sum(-1).mean(axis=(1, 2))  # 4096 entries each
    np.testing.assert_allclose(power[1:], npow[1:], rtol=0.08)


@pytest.mark.parametrize("dist", ["geometric", "uniform"])
def test_sigmas_match_jax(dist):
    want = np.asarray(jsigmas.get_sigmas(39.15, 0.0107, 2311, dist))
    got = sigmas.get_sigmas(39.15, 0.0107, 2311, dist)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("stride", [1, 7, 64, 2311])
def test_subsample_schedule_matches_jax(stride):
    full = sigmas.sigmas_from_config(config.ModelConfig())
    jfull = jsigmas.sigmas_from_config(jconfig.ModelConfig())
    np.testing.assert_array_equal(full.numpy(), np.asarray(jfull))
    got, got_scale = sigmas.subsample_schedule(full, stride)
    want, want_scale = jsigmas.subsample_schedule(jfull, stride)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got_scale == want_scale
    assert float(got[-1]) == float(full[-1])


def _write_files(data_dir, ext):
    """Two spacings of one (profile, seed), in the reference file naming."""
    rng = np.random.RandomState(5)
    for spacing in (0.5, 0.6):
        h = (rng.randn(6, 2, 16, 64) + 1j * rng.randn(6, 2, 16, 64)) * 0.4
        save_output_h(str(data_dir / f"CDL-B_Nt64_Nr16_ULA{spacing:.2f}"
                                     f"_seed7.{ext}"), h + 0.1)


@pytest.mark.parametrize("ext", ["npz", "mat"])
@pytest.mark.parametrize("norm", ["global", "entrywise", None, "train"])
def test_file_dataset_matches_jax(tmp_path, ext, norm):
    _write_files(tmp_path, ext)
    path = tmp_path / f"CDL-B_Nt64_Nr16_ULA0.50_seed7.{ext}"
    np.testing.assert_array_equal(load_output_h(str(path)),
                                  jax_load(str(path)))
    fields = dict(source="file", data_dir=str(tmp_path), channel="CDL-B",
                  spacing_list=(0.5, 0.6))
    jcfg = dataclasses.replace(jconfig.DataConfig(), **fields)
    cfg = dataclasses.replace(config.DataConfig(), **fields)
    if norm == "train":  # the stats of another set, passed as a list
        stats = [np.complex64(0.05 + 0.02j), 1.7]
        want, got = (JDataset(7, jcfg, norm=stats, num_pilots=38),
                     ChannelDataset(7, cfg, norm=stats, num_pilots=38))
    else:
        want, got = JDataset(7, jcfg, norm=norm), ChannelDataset(7, cfg,
                                                                  norm=norm)
    assert len(got) == len(want) == 12 and got.num_pilots == want.num_pilots
    np.testing.assert_array_equal(got.hermitian_c2().numpy(),
                                  np.asarray(want.hermitian_c2()))
    np.testing.assert_array_equal(got.hermitian(normalized=False),
                                  want.hermitian(normalized=False))
    np.testing.assert_allclose(empirical_covariance(got),
                               jax_covariance(want), rtol=1e-12)


def test_cdl_source_is_refused():
    # source="cdl" is ported (tests/test_torch_cdl.py); an unknown source
    # is what is refused now
    ds = ChannelDataset(1, dataclasses.replace(config.DataConfig(),
                                               num_channels=2))
    assert ds.channels.shape == (2, 16, 64)
    with pytest.raises(ValueError, match="unknown data source"):
        ChannelDataset(1, config.DataConfig(source="matlab"))


def test_converter_matches_jax():
    model = make_score_model(config.ModelConfig(ngf=4), device="cpu",
                             generator=torch.Generator().manual_seed(2))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, _ = torch_state_dict_to_flax(sd)
    got = jax_params_to_state_dict(params)
    want = flax_params_to_torch_state_dict(params)
    assert sorted(got) == sorted(want) == sorted(sd)
    for k, v in got.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), want[k])
        np.testing.assert_array_equal(v.numpy(), sd[k])
