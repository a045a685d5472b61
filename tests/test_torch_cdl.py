"""CDL data generation of the PyTorch port against the JAX package.

The two packages draw from different random streams, so the deterministic
core (`cdl_core`) is held against the JAX package's _generate_one on JAX's
own draws (the same key splits as cdl.py:238-258), within 1e-5 of max|H|,
and the ensembles against each other by the bars of tests/test_cdl.py and
tests/test_cdl_native.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_based_channels_tpu.config import DataConfig as JDataConfig
from score_based_channels_tpu.data.cdl import CDL_PROFILES as J_PROFILES
from score_based_channels_tpu.data.cdl import _generate_one
from score_based_channels_tpu.data.cdl import (
    generate_cdl_channels as jax_generate,
)
from score_based_channels_tpu.data.dataset import ChannelDataset as JDataset
from score_based_channels_torch import config
from score_based_channels_torch.data import ChannelDataset
from score_based_channels_torch.data.cdl import (
    CDL_PROFILES, RAY_OFFSETS_PM, cdl_core, cdl_draws, generate_cdl_channels,
)
from score_based_channels_torch.data.generate import main as generate_main
from score_based_channels_torch.data.io import load_output_h
from score_based_channels_torch.diffusion.sigmas import song_step_size
from score_based_channels_tpu.diffusion.sigmas import (
    song_step_size as jax_song_step_size,
)

torch.set_num_threads(1)
PROFILES = ["CDL-A", "CDL-B", "CDL-C", "CDL-D", "CDL-E"]


def test_tables_are_the_jax_packages():
    assert sorted(CDL_PROFILES) == sorted(J_PROFILES) == PROFILES
    for name, prof in CDL_PROFILES.items():
        want = J_PROFILES[name]
        np.testing.assert_array_equal(prof.rows, want.rows)
        assert prof[1:] == want[1:]


def _jax_draws(key, profile, coupling):
    """The draws _generate_one makes from `key` (cdl.py:238-258)."""
    n_clusters, n_rays = J_PROFILES[profile].rows.shape[0], 20
    k_phase, _, k_coup_z = jax.random.split(key, 3)
    if coupling == "random":
        perm = jax.vmap(lambda k: jax.random.permutation(k, n_rays))(
            jax.random.split(k_coup_z, n_clusters))
    else:
        perm = jnp.broadcast_to(jnp.arange(n_rays), (n_clusters, n_rays))
    phases = jax.random.uniform(k_phase, (n_clusters, n_rays), jnp.float32,
                                0.0, 2.0 * jnp.pi)
    return np.asarray(phases), np.asarray(perm)


@pytest.mark.parametrize("coupling", ["random", "fixed"])
@pytest.mark.parametrize("profile", PROFILES)
def test_core_matches_jax_generate_one(profile, coupling):
    keys = jax.random.split(jax.random.key(11), 3)
    phases, perms, want = [], [], []
    for k in keys:
        ph, pm = _jax_draws(k, profile, coupling)
        phases.append(ph.copy())
        perms.append(pm.copy())
        want.append(np.asarray(_generate_one(
            k, profile, 16, 64, 0.5, 30e-9, 15e3, 10, 24,
            ray_coupling=coupling)))
    want = np.stack(want)
    got = cdl_core(profile, torch.from_numpy(np.stack(phases)),
                   torch.from_numpy(np.stack(perms)).long()).numpy()
    assert got.shape == want.shape == (3, 10, 16, 64)
    assert got.dtype == np.complex64
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # one realization at a time gives the same as the batch
    one = cdl_core(profile, torch.from_numpy(phases[1]),
                   torch.from_numpy(perms[1]).long()).numpy()
    assert np.abs(one - want[1]).max() <= 1e-5 * np.abs(want[1]).max()


def test_draws_are_permutations_and_phases():
    g = torch.Generator().manual_seed(0)
    ph, pm = cdl_draws(g, 50, "CDL-C", "random")
    assert ph.shape == pm.shape == (50, 24, 20)
    assert 0 <= ph.min() and ph.max() < 2 * np.pi
    assert torch.equal(pm.sort(dim=-1).values,
                       torch.arange(20).expand(50, 24, 20))
    assert not torch.equal(pm[0], pm[1])
    _, fixed = cdl_draws(g, 2, "CDL-D", "fixed")
    assert torch.equal(fixed, torch.arange(20).expand(2, 14, 20))
    with pytest.raises(ValueError):
        cdl_draws(g, 2, "CDL-D", "other")
    with pytest.raises(ValueError, match="CDL-C takes"):
        cdl_core("CDL-C", ph[:, :3], pm[:, :3])
    assert RAY_OFFSETS_PM.shape == (20,)


@pytest.mark.parametrize("profile", ["CDL-A", "CDL-B", "CDL-C", "CDL-D"])
def test_generate_shapes_and_power(profile):
    """tests/test_cdl.py:19-27: shape, dtype, unit-order entry power."""
    H = generate_cdl_channels(seed=1234, profile=profile, num_channels=8)
    assert H.shape == (8, 10, 16, 64) and H.dtype == np.complex64
    assert 0.3 < np.mean(np.abs(H) ** 2) < 3.0


def test_determinism_and_streams_by_seed_and_profile():
    a = generate_cdl_channels(seed=7, profile="CDL-C", num_channels=2)
    np.testing.assert_array_equal(
        a, generate_cdl_channels(seed=7, profile="CDL-C", num_channels=2))
    assert np.abs(a - generate_cdl_channels(seed=8, profile="CDL-C",
                                            num_channels=2)).max() > 1e-3
    assert np.abs(a - generate_cdl_channels(seed=7, profile="CDL-B",
                                            num_channels=2)).max() > 1e-3


def test_spatial_correlation_structure():
    """tests/test_cdl.py:36-48: 90% of a realization's energy in <= 8 modes."""
    H = generate_cdl_channels(seed=0, profile="CDL-C", num_channels=32)[:, 0]
    s = np.linalg.svd(H[0], compute_uv=False)
    energy = np.cumsum(s**2) / np.sum(s**2)
    assert int(np.searchsorted(energy, 0.9)) + 1 <= 8


def _tx_cov(H):
    X = H[:, 0].reshape(-1, H.shape[-1])
    C = X.conj().T @ X / X.shape[0]
    return C / np.trace(C).real


@pytest.mark.parametrize("coupling", ["random", "fixed"])
@pytest.mark.parametrize("profile", ["CDL-A", "CDL-C", "CDL-D"])
def test_ensemble_statistics_match_jax(profile, coupling):
    """The bars of tests/test_cdl_native.py:30-48: entry power within 25%,
    normalised tx covariance correlation > 0.9."""
    N = 64
    Ht = generate_cdl_channels(seed=3, profile=profile, num_channels=N,
                               ray_coupling=coupling)
    Hj = jax_generate(seed=3, profile=profile, num_channels=N,
                      ray_coupling=coupling)
    pt, pj = (np.mean(np.abs(H[:, 0]) ** 2) for H in (Ht, Hj))
    assert abs(pt - pj) / pj < 0.25, (pt, pj)
    Ct, Cj = _tx_cov(Ht), _tx_cov(Hj)
    corr = np.abs(np.vdot(Ct, Cj)) / (np.linalg.norm(Ct) * np.linalg.norm(Cj))
    assert corr > 0.9, corr


def test_cdl_dataset_views():
    data = dataclasses.replace(config.DataConfig(), num_channels=12)
    ds = ChannelDataset(1234, data, norm="global")
    jds = JDataset(1234, dataclasses.replace(JDataConfig(), num_channels=12),
                   norm="global")
    assert len(ds) == len(jds) == 12 and ds.mean == 0.0
    np.testing.assert_allclose(np.std(ds.normalized()), 1.0, rtol=1e-3)
    x = ds.network_input()
    assert x.dtype == torch.float32 and tuple(x.shape) == (12, 64, 16, 2)
    assert x.is_contiguous()  # the model's layout, NHWC
    assert tuple(x.shape) == np.asarray(jds.network_input()).shape
    herm = ds.hermitian()
    np.testing.assert_array_equal(x[..., 0].numpy(), herm.real)
    np.testing.assert_array_equal(x[..., 1].numpy(), herm.imag)
    np.testing.assert_array_equal(
        ds.channels, generate_cdl_channels(seed=1234, num_channels=12)[:, 0])
    # train stats normalise a validation set
    val = ChannelDataset(4321, data, norm=list(ds.norm_stats))
    assert val.std == ds.std
    fixed = ChannelDataset(1234, dataclasses.replace(
        data, ray_coupling="fixed"), norm="global")
    assert np.abs(fixed.channels - ds.channels).max() > 1e-3


def test_generate_data_cli_writes_reference_files(tmp_path, capsys):
    generate_main(["--profiles", "CDL-D", "--seeds", "5", "--num_channels",
                   "3", "--out_dir", str(tmp_path), "--backend", "torch"])
    H = load_output_h(str(tmp_path / "CDL-D_Nt64_Nr16_ULA0.50_seed5.npz"))
    np.testing.assert_array_equal(
        H, generate_cdl_channels(seed=5, profile="CDL-D", num_channels=3))
    assert "wrote" in capsys.readouterr().out
    # a file data set reads it back as the generator made it
    data = dataclasses.replace(config.DataConfig(), source="file",
                               data_dir=str(tmp_path), channel="CDL-D",
                               num_channels=3)
    np.testing.assert_array_equal(
        ChannelDataset(5, data).channels,
        ChannelDataset(5, dataclasses.replace(data, source="cdl")).channels)


@pytest.mark.parametrize("num_classes,rate", [(2311, 0.995), (500, 0.99)])
def test_song_step_size_matches_jax(num_classes, rate):
    end = 39.15 * rate ** (num_classes - 1)
    assert song_step_size(end, num_classes, rate) == jax_song_step_size(
        end, num_classes, rate)
