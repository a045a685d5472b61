"""The port's tuner (eval/tune.py, the `tune` command) against the JAX
package on the CPU, and the files either package reads.

- run_hparam_search with the JAX package's own draws (pilots, init,
  measurements of its tune.py:143-160) fed through the port's draws seam,
  beta = 0 (the Langevin update is then deterministic) and a converted
  tiny NCSNv2-Deepest (ngf 8, 5 levels): nmse_log within rtol 1e-4, the
  per-SNR selection and the blind selection identical.
- The selection arithmetic on one synthetic nmse_log with diverged (NaN,
  inf) combos, through both packages' run_hparam_search with the sampler
  replaced by that log: every field, the blind selection and the slim
  file identical.
"""

import dataclasses
import hashlib
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_based_channels_tpu import cplx as jcplx
from score_based_channels_tpu import physics as jphysics
from score_based_channels_tpu.config import Config as JConfig
from score_based_channels_tpu.config import DataConfig as JDataConfig
from score_based_channels_tpu.config import ModelConfig as JModelConfig
from score_based_channels_tpu.data.dataset import (
    ChannelDataset as JChannelDataset,
)
from score_based_channels_tpu.eval import tune as jtune
from score_based_channels_tpu.eval.estimate import (
    score_fn_from_params as jax_score_fn,
)
from score_based_channels_tpu.models import make_score_model as jax_model
from score_based_channels_tpu.models.torch_compat import (
    torch_state_dict_to_flax,
)
from score_based_channels_tpu.utils.checkpoint import save_checkpoint
from score_based_channels_torch.config import Config, DataConfig, ModelConfig
from score_based_channels_torch.eval import tune
from score_based_channels_torch.eval.estimate import (
    main as estimate_main, score_fn_from_params,
)
from score_based_channels_torch.eval.tune import (
    TuneResults, run_hparam_search,
)
from score_based_channels_torch.models import (
    jax_params_to_state_dict, make_score_model,
)

torch.set_num_threads(1)

LEVELS, RATE = 5, 0.25  # 39.15 down to 0.153
ALPHAS = (1e-5, 1e-4, 3e-4)
SNRS = np.array([0.0, 20.0])
C = 2
COMMITTED = "results/score/CDL-C-hyperparameters.npz"
COMMITTED_SLIM = "results/score/CDL-C-fixed-hyperparameters-a0.6.npz"


@pytest.fixture(scope="module")
def net():
    """A tiny NCSNv2-Deepest with the port's random init, carried to flax
    by the JAX package's converter."""
    tm = make_score_model(ModelConfig(ngf=8, num_classes=LEVELS,
                                      sigma_rate=RATE), device="cpu",
                          generator=torch.Generator().manual_seed(3))
    params, _ = torch_state_dict_to_flax(
        {k: v.numpy() for k, v in tm.state_dict().items()})
    tm.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return tm, params


def _jcfg():
    return JConfig(model=JModelConfig(ngf=8, num_classes=LEVELS,
                                      sigma_rate=RATE),
                   data=JDataConfig(num_channels=8))


def _cfg():
    return Config(model=ModelConfig(ngf=8, num_classes=LEVELS,
                                    sigma_rate=RATE),
                  data=DataConfig(num_channels=8))


def _jax_draws(jcfg, seed=2023):
    """(A, Y, X, x_init) as the JAX package's run_hparam_search draws them
    (tune.py:125-160, default seeds and pilot density)."""
    train = JChannelDataset(1234, jcfg.data, norm="global")
    num_pilots = int(np.floor(64 * 0.6))
    val_cfg = dataclasses.replace(jcfg.data, spacing_list=(0.5,))
    val = JChannelDataset(4321, val_cfg, norm=list(train.norm_stats),
                          num_pilots=num_pilots)
    k_pilot, k_init, k_meas, _ = jax.random.split(jax.random.key(seed), 4)
    X = val.hermitian_c2(normalized=True)[:C]
    A = jcplx.conj_transpose(jcplx.qpsk_pilots(k_pilot, C, 64, num_pilots))
    x0 = jcplx.randn(k_init, X.shape[:-1])
    S = len(SNRS)
    npow = np.asarray(jphysics.snr_to_noise_power(SNRS, 64), np.float32)
    Y = jphysics.measure_c2(k_meas, jnp.tile(A, (S, 1, 1, 1)),
                            jnp.tile(X, (S, 1, 1, 1)),
                            jnp.repeat(jnp.asarray(npow), C))
    return tuple(np.asarray(a) for a in (A, Y, X, x0))


def test_search_with_the_jax_draws_matches_jax(net):
    tm, params = net
    jcfg = _jcfg()
    want = jtune.run_hparam_search(
        jax_score_fn(jax_model(jcfg.model), params), jcfg, snr_range=SNRS,
        alpha_step_range=ALPHAS, beta_noise_range=(0.0,), num_channels=C)
    got = run_hparam_search(
        score_fn_from_params(tm), _cfg(), snr_range=SNRS,
        alpha_step_range=ALPHAS, beta_noise_range=(0.0,), num_channels=C,
        chunk_size=5, device="cpu", _draws=_jax_draws(jcfg))
    assert got.nmse_log.shape == (3, 1, 2, LEVELS * 3, C)
    assert np.isfinite(want.nmse_log).all()
    ends = want.avg_nmse[..., -1]
    assert ends.max() / ends.min() > 1.5  # the grid matters
    np.testing.assert_allclose(got.nmse_log, want.nmse_log, rtol=1e-4)
    for k in ("best_alpha_snr", "best_beta_snr", "best_step_snr"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.blind_selection() == want.blind_selection()


def _synthetic_log(rng, nA=3, nB=2, S=4, steps=6):
    log = rng.uniform(0.01, 1.0, (nA, nB, S, steps, 3)).astype(np.float32)
    log[1, 0] = np.nan           # a combo that diverged everywhere
    log[2, 1, :, 4:] = np.inf    # one that blew up late
    log[0, 1, 2, 3] = 1e-3       # a clear winner at one SNR
    return log


def test_selection_arithmetic_matches_jax(monkeypatch, tmp_path):
    log = _synthetic_log(np.random.default_rng(7))
    nA, nB, S, steps, Cs = log.shape
    trace = np.transpose(log, (3, 0, 1, 2, 4)).reshape(steps, -1)
    fake = lambda *a, **k: (None, trace.copy())
    monkeypatch.setattr(jtune, "langevin_chunked", fake)
    monkeypatch.setattr(tune, "langevin_chunked", fake)
    snrs = np.arange(S) * 5.0
    grid = dict(snr_range=snrs, alpha_step_range=(1e-11, 2e-11, 3e-11),
                beta_noise_range=(0.1, 0.01), num_channels=Cs)
    want = jtune.run_hparam_search(None, _jcfg(), **grid)
    draws = (np.zeros((Cs, 38, 64, 2)), np.zeros((S * Cs, 38, 16, 2)),
             np.zeros((Cs, 64, 16, 2)), np.zeros((Cs, 64, 16, 2)))
    got = run_hparam_search(None, _cfg(), device="cpu", _draws=draws, **grid)
    for k, v in vars(want).items():
        np.testing.assert_array_equal(getattr(got, k), v, err_msg=k)
    assert got.blind_selection() == want.blind_selection()
    got.save_slim(str(tmp_path / "port.npz"))
    want.save_slim(str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the JAX package reads the port's full file
    got.save(str(tmp_path / "full.npz"))
    back = jtune.TuneResults.load(str(tmp_path / "full.npz"))
    np.testing.assert_array_equal(back.nmse_log, log)
    assert back.blind_selection() == got.blind_selection()


def test_slim_keys_are_the_committed_tables():
    """The port's slim keys are those of the JAX package's save_slim, as in
    the committed per-density tables; the older committed CDL-C table
    predates the blind selection and holds the per-SNR keys only."""
    rng = np.random.default_rng(1)
    res = tune.select(_synthetic_log(rng), np.arange(4.0),
                      np.array([1e-11, 2e-11, 3e-11]), np.array([0.1, 0.01]))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "slim.npz")
        res.save_slim(path)
        with np.load(path) as f:
            keys = set(f.files)
    with np.load(COMMITTED_SLIM) as f:
        assert keys == set(f.files)
    with np.load(COMMITTED) as f:
        assert set(f.files) == keys - {"blind_alpha", "blind_beta",
                                       "blind_step", "blind_nmse"}


def _checkpoint(tmp_path, params, num_classes):
    ck = str(tmp_path / f"ck{num_classes}.npz")
    save_checkpoint(ck, JConfig(
        model=JModelConfig(ngf=8, num_classes=num_classes,
                           sigma_rate=RATE if num_classes == LEVELS else 0.995),
        data=JDataConfig(num_channels=8)), params)
    return ck


def test_tune_cli_then_estimate_hparams(net, tmp_path, capsys):
    """`tune --device cpu` writes a slim table that `estimate --hparams`
    (per-SNR and --blind) reads; the JAX package reads its full log."""
    ck = _checkpoint(tmp_path, net[1], LEVELS)
    slim = str(tmp_path / "slim.npz")
    tune.main(["--device", "cpu", "--checkpoint", ck, "--snr", "0", "20",
               "--num_channels", "2", "--alpha_step_range", "1e-5", "1e-4",
               "--beta_noise_range", "0.01", "0.001", "--chunk", "8",
               "--output", slim])
    out = capsys.readouterr().out
    assert "blind-SNR selection" in out and "saved" in out
    with np.load(slim) as f:
        assert f["best_step_snr"].shape == (2,)
        assert 0 <= int(f["blind_step"]) < LEVELS * 3
    for extra in ([], ["--blind"]):
        res = str(tmp_path / f"est{len(extra)}.npz")
        estimate_main(["--device", "cpu", "--checkpoint", ck, "--hparams",
                       slim, "--num_channels", "2", "--init", "noise",
                       "--chunk", "4", "--dtype", "float32", "--output", res]
                      + extra)
        with np.load(res) as f:
            assert f["nmse_log"].shape == (1, 1, 2, LEVELS * 3, 2)
            assert np.isfinite(f["nmse_log"]).all()
    full = str(tmp_path / "full.npz")
    tune.main(["--device", "cpu", "--checkpoint", ck, "--snr", "10",
               "--num_channels", "1", "--alpha_step_range", "1e-5",
               "--beta_noise_range", "0.01", "--chunk", "1", "--full_log",
               "--output", full])
    assert jtune.TuneResults.load(full).nmse_log.shape == (1, 1, 1,
                                                           LEVELS * 3, 1)


def test_estimate_reads_the_committed_table_unchanged(net, tmp_path, capsys):
    """The committed table (17 SNRs, stop steps of the 2311-level
    schedule) drives the port's estimate at stride 256 and stays as it
    was."""
    with open(COMMITTED, "rb") as f:
        before = hashlib.sha256(f.read()).hexdigest()
    ck = _checkpoint(tmp_path, net[1], 2311)
    res = str(tmp_path / "est.npz")
    estimate_main(["--device", "cpu", "--checkpoint", ck, "--hparams",
                   COMMITTED, "--num_channels", "1", "--init", "noise",
                   "--chunk", "17", "--stride", "256", "--dtype", "float32", "--output", res])
    assert "known-SNR stop" in capsys.readouterr().out
    with np.load(res) as f, np.load(COMMITTED) as h:
        # random weights at the table's steps diverge; the table is read
        np.testing.assert_array_equal(f["snr_range"], h["snr_range"])
        assert f["nmse_log"].shape[:3] == (1, 1, 17)
    with open(COMMITTED, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == before
