"""The port's baselines (ls, lasso, amp, mmse, lmmse) against the JAX
package on the CPU.

Inputs come from numpy with a seed, or from the JAX package's own draws,
and go through both packages' functions. Tolerances:
  - ls_estimate: 1e-4 of max|h| against JAX at noise 0.5; NMSE < 1e-4 in
    the near-noiseless overdetermined case; rtol 2e-2 / atol 2e-3 against
    a float64 numpy solve (the JAX package's own bar,
    tests/test_baselines.py:24-42);
  - lifted_fourier_dicts: rtol 1e-6;
  - fista_l1_lifted, 50 iterations at the default lambda and lr: 1e-4 of
    max|H| and the trace within 1e-4 relative;
  - em_gm_amp / em_bg_amp on the sparse cases of tests/test_baselines.py
    (180 and 80 iterations): 1e-3 of max|H|, final NMSE within 0.01 dB.
    The accept/reject step is a per-sample decision on two f32 sums; on
    these cases every decision agrees (the estimates would be far apart
    otherwise).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_based_channels_tpu import cplx as jcplx
from score_based_channels_tpu import physics as jphysics
from score_based_channels_tpu.baselines.amp import (
    em_bg_amp as jax_em_bg_amp, em_gm_amp as jax_em_gm_amp,
)
from score_based_channels_tpu.baselines.lasso import (
    fista_l1_lifted as jax_fista, lifted_fourier_dicts as jax_dicts,
)
from score_based_channels_tpu.baselines.lmmse import (
    analytic_covariance as jax_analytic_covariance,
    empirical_covariance as jax_empirical_covariance,
)
from score_based_channels_tpu.baselines.ls import ls_estimate as jax_ls
from score_based_channels_tpu.baselines.mmse import (
    run_mmse_estimation as jax_run_mmse,
)
from score_based_channels_tpu.config import Config as JConfig
from score_based_channels_tpu.config import DataConfig as JDataConfig
from score_based_channels_tpu.config import ModelConfig as JModelConfig
from score_based_channels_tpu.data.dataset import (
    ChannelDataset as JChannelDataset,
)
from score_based_channels_tpu.eval.estimate import (
    score_fn_from_params as jax_score_fn,
)
from score_based_channels_tpu.models import make_score_model as jax_model
from score_based_channels_tpu.models.torch_compat import (
    torch_state_dict_to_flax,
)
from score_based_channels_torch import cplx
from score_based_channels_torch.baselines.amp import (
    em_bg_amp, em_gm_amp, run_amp_baseline,
)
from score_based_channels_torch.baselines.lasso import (
    fista_l1_lifted, lifted_fourier_dicts, run_lasso_baseline,
)
from score_based_channels_torch.baselines.lmmse import analytic_covariance
from score_based_channels_torch.baselines.ls import (
    ls_estimate, run_ls_baseline,
)
from score_based_channels_torch.baselines.mmse import (
    auto_coef_cap, run_mmse_estimation,
)
from score_based_channels_torch.baselines import lmmse as lmmse_mod
from score_based_channels_torch.config import Config, DataConfig, ModelConfig
from score_based_channels_torch.eval.estimate import (
    run_estimation, score_fn_from_params,
)
from score_based_channels_torch.models import (
    jax_params_to_state_dict, make_score_model,
)

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _pilots(rng, B, Nt, Np):
    """A = conj(P)^T of QPSK pilots, c2 float32 (B, Np, Nt, 2)."""
    P = (np.sign(rng.standard_normal((B, Nt, Np, 2)))
         * np.sqrt(0.5)).astype(np.float32)
    return np.array(jcplx.conj_transpose(jnp.asarray(P)))


def _c2(rng, shape, scale=1.0):
    return (rng.standard_normal(shape + (2,)) * np.sqrt(0.5)
            * scale).astype(np.float32)


def _measure(A, X, noise, rng):
    Y = np.asarray(jcplx.matmul(jnp.asarray(A), jnp.asarray(X)))
    return (Y + _c2(rng, Y.shape[:-1], np.sqrt(noise))).astype(np.float32)


def tiny_cfg():
    return Config(model=ModelConfig(ngf=8, num_classes=6),
                  data=DataConfig(num_channels=8))


# -- ls -----------------------------------------------------------------------

def test_ls_estimate_matches_jax():
    rng = np.random.default_rng(0)
    A = _pilots(rng, 3, 64, 38)
    X = _c2(rng, (3, 64, 16))
    Y = _measure(A, X, 0.5, rng)
    want = np.asarray(jax_ls(jnp.asarray(A), jnp.asarray(Y), 0.5))
    got = ls_estimate(t(A), t(Y), 0.5).numpy()
    assert got.shape == (3, 64, 16, 2)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_ls_estimate_matches_float64_normal_equations():
    rng = np.random.default_rng(1)
    A = _pilots(rng, 3, 64, 38)
    X = _c2(rng, (3, 64, 16))
    noise = np.array([0.5, 0.05, 2.0], np.float32)  # per sample
    Y = _measure(A, X, 0.1, rng)
    est = jcplx.to_complex(ls_estimate(t(A), t(Y), t(noise)).numpy())
    Ac, Yc = jcplx.to_complex(A), jcplx.to_complex(Y)
    for b in range(3):
        Ab = Ac[b].astype(np.complex128)
        G = Ab.conj().T @ Ab + float(noise[b]) * np.eye(64)
        want = np.linalg.solve(G, Ab.conj().T @ Yc[b])
        np.testing.assert_allclose(est[b], want, rtol=2e-2, atol=2e-3)


def test_ls_overdetermined_noiseless_recovers_exactly():
    rng = np.random.default_rng(2)
    A = _pilots(rng, 2, 64, 64)
    X = _c2(rng, (2, 64, 16))
    Y = np.asarray(jcplx.matmul(jnp.asarray(A), jnp.asarray(X)))
    est = ls_estimate(t(A), t(Y), 1e-6)
    assert float(cplx.nmse(est, t(X)).max()) < 1e-4


def test_ls_estimate_raises_on_a_failed_factorisation():
    rng = np.random.default_rng(3)
    A = _pilots(rng, 2, 8, 4)
    Y = _c2(rng, (2, 4, 3))
    with pytest.raises(torch.linalg.LinAlgError, match="Cholesky"):
        ls_estimate(t(A), t(Y), -100.0)  # indefinite: no jitter, no retry


def test_ls_baseline_runner():
    res = run_ls_baseline(tiny_cfg(), snr_range=np.array([0.0, 10.0]),
                          num_channels=4, device="cpu")
    assert res.nmse.shape == (1, 1, 2, 4)
    assert res.nmse.mean(-1)[0, 0, 1] < res.nmse.mean(-1)[0, 0, 0]
    again = run_ls_baseline(tiny_cfg(), snr_range=np.array([0.0, 10.0]),
                            num_channels=4, device="cpu")
    np.testing.assert_array_equal(again.nmse, res.nmse)  # seeded draws


def test_estimate_init_ls_starts_at_the_ls_estimate():
    """--init ls runs; with alpha 0 the chain holds the LS estimate, so
    every step of the trace is its NMSE, below the noise init's."""
    cfg = tiny_cfg()
    zero = lambda x, s: torch.zeros_like(x)
    kw = dict(snr_range=np.array([20.0]), num_channels=3, alpha_step=0.0,
              device="cpu")
    ls = run_estimation(zero, cfg, init="ls", **kw).avg_nmse[0, 0, 0]
    noise = run_estimation(zero, cfg, init="noise", **kw).avg_nmse[0, 0, 0]
    assert np.isfinite(ls).all()
    np.testing.assert_allclose(ls, ls[0], rtol=1e-6)
    assert ls[0] < noise[0]


# -- lasso --------------------------------------------------------------------

@pytest.mark.parametrize("rows,cols,lift", [(64, 16, 4), (8, 4, 2)])
def test_lifted_dicts_match_jax(rows, cols, lift):
    L, R = lifted_fourier_dicts(rows, cols, lift)
    jL, jR = jax_dicts(rows, cols, lift)
    assert L.dtype == np.complex64 and L.shape == (rows, rows * lift)
    np.testing.assert_allclose(L, jL, rtol=1e-6)
    np.testing.assert_allclose(R, jR, rtol=1e-6)


def test_fista_matches_jax():
    rng = np.random.default_rng(4)
    B = 3
    A = _pilots(rng, B, 64, 38)
    X = _c2(rng, (B, 64, 16))
    Y = _measure(A, X, 0.64, rng)
    L2, R2 = (jcplx.from_complex(d) for d in jax_dicts(64, 16, 4))
    lm = np.array([0.3, 0.1, 0.3], np.float32)  # per-sample lambda
    want, wtr = jax_fista(jnp.asarray(A), jnp.asarray(Y), L2, R2, lm, 3e-3,
                          num_iters=50, oracle2=jnp.asarray(X))
    got, gtr = fista_l1_lifted(t(A), t(Y), t(np.asarray(L2)),
                               t(np.asarray(R2)), t(lm), 3e-3, num_iters=50,
                               oracle2=t(X))
    want, wtr = np.asarray(want), np.asarray(wtr)
    assert gtr.shape == (50, B)
    assert wtr[-1].mean() < 0.9 * wtr[0].mean()  # it moved
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(gtr.numpy(), wtr, rtol=1e-4)


def test_fista_recovers_sparse_signal():
    rng = np.random.default_rng(0)
    Nt, Nr, lift = 16, 8, 2
    L, R = lifted_fourier_dicts(Nt, Nr, lift)
    Z = np.zeros((Nt * lift, Nr * lift), np.complex64)
    for _ in range(3):
        Z[rng.integers(Nt * lift), rng.integers(Nr * lift)] = (
            rng.standard_normal() + 1j * rng.standard_normal())
    X2 = cplx.from_complex((L @ Z @ R)[None])
    A2 = t(_pilots(rng, 1, Nt, Nt))
    _, trace = fista_l1_lifted(A2, cplx.matmul(A2, X2), cplx.from_complex(L),
                               cplx.from_complex(R), 1e-4, 2e-2,
                               num_iters=400, oracle2=X2)
    assert float(trace[-1, 0]) < 1e-2 and trace[-1, 0] < trace[0, 0]


def test_lasso_runner():
    res = run_lasso_baseline(tiny_cfg(), snr_range=np.array([0.0, 20.0]),
                             lmbda_range=(0.3, 0.1), num_iters=20,
                             num_channels=3, chunk_size=5, device="cpu")
    assert res.nmse_log.shape == (1, 2, 1, 2, 3)
    assert res.complete_log.shape == (1, 2, 1, 2, 20, 3)
    np.testing.assert_array_equal(res.nmse_log, res.complete_log[..., -1, :])
    assert np.isfinite(res.best_nmse).all()
    assert set(res.best_lmbda.ravel()) <= {0.3, 0.1}


# -- amp ----------------------------------------------------------------------

def _sparse_case(seed, pilot_seed, noise, strong, weak, scale):
    """The sparse cases of tests/test_baselines.py:136-200 (16x8, lift 2,
    full pilots), drawn with numpy."""
    rng = np.random.default_rng(seed)
    Nt, Nr, lift = 16, 8, 2
    L, R = lifted_fourier_dicts(Nt, Nr, lift)
    Z = np.zeros((Nt * lift, Nr * lift), np.complex64)
    crand = lambda: rng.standard_normal() + 1j * rng.standard_normal()
    for _ in range(strong):
        Z[rng.integers(Nt * lift), rng.integers(Nr * lift)] = scale * crand()
    for _ in range(weak):
        Z[rng.integers(Nt * lift), rng.integers(Nr * lift)] = crand()
    X = np.asarray(cplx.from_complex((L @ Z @ R)[None]))
    prng = np.random.default_rng(pilot_seed)
    A = _pilots(prng, 1, Nt, Nt)
    Y = _measure(A, X, noise ** 2 * 1.0, prng)
    return A, Y, X, cplx.from_complex(L).numpy(), cplx.from_complex(R).numpy()


AMP_CASES = {  # (seed, pilot seed, noise std, strong, weak, scale), iters
    "bg": ((0, 2, 1e-3, 3, 0, 1.0), 180),
    "gm_heavy_tailed": ((42, 5, 1e-2, 4, 12, 30.0), 80),
}


@pytest.mark.parametrize("case", sorted(AMP_CASES))
@pytest.mark.parametrize("K", [1, 3])
def test_amp_matches_jax(case, K):
    args, iters = AMP_CASES[case]
    A, Y, X, L, R = _sparse_case(*args)
    fn_j = jax_em_bg_amp if K == 1 else jax_em_gm_amp
    fn_t = em_bg_amp if K == 1 else em_gm_amp
    kw = {} if K == 1 else dict(num_components=K)
    want, wtr = fn_j(*(jnp.asarray(a) for a in (A, Y, L, R)), num_iters=iters,
                     oracle2=jnp.asarray(X), **kw)
    got, gtr = fn_t(*(t(a) for a in (A, Y, L, R)), num_iters=iters,
                    oracle2=t(X), **kw)
    want, wtr = np.asarray(want), np.asarray(wtr)
    assert gtr.shape == (iters, 1)
    assert np.abs(got.numpy() - want).max() <= 1e-3 * np.abs(X).max()
    assert abs(10 * np.log10(gtr[-1, 0].item() / wtr[-1, 0])) <= 0.01
    assert wtr[-1, 0] < 0.2 * wtr[0, 0]  # the recursion moved


def test_amp_runner():
    res = run_amp_baseline(tiny_cfg(), snr_range=np.array([-10.0, 30.0]),
                           num_iters=8, num_channels=3, device="cpu")
    assert res.nmse_trace.shape == (2, 8, 3)
    db = res.best_db()
    assert np.isfinite(db).all() and db[1] < db[0]


@pytest.mark.parametrize("name", ["lasso", "amp"])
def test_runner_channel_slice_matches_the_whole_run(name):
    """The _channels seam solves the same draws' rows of those channels
    only: per-channel traces equal the whole run's within rtol 1e-5."""
    kw = dict(snr_range=np.array([0.0, 20.0]), num_channels=4, device="cpu")
    if name == "lasso":
        run = lambda **k: run_lasso_baseline(tiny_cfg(), num_iters=12,
                                             **kw, **k).complete_log
    else:
        run = lambda **k: run_amp_baseline(tiny_cfg(), num_iters=6,
                                           **kw, **k).nmse_trace
    whole, part = run(), run(_channels=(3, 1))
    assert part.shape[-1] == 2
    np.testing.assert_allclose(part, whole[..., [3, 1]], rtol=1e-5)


# -- mmse ---------------------------------------------------------------------

def _zero(x, s):
    return torch.zeros_like(x)


def test_mmse_shapes_and_averaging():
    res = run_mmse_estimation(_zero, tiny_cfg(), snr_range=np.array([10.0]),
                              num_channels=3, mmse_avg=4, device="cpu")
    assert res.nmse_mean_est.shape == res.nmse_single.shape == (1, 3)
    assert res.nmse_mean_est.mean() <= res.nmse_single.mean() * 1.2


def test_mmse_chunk_padding_larger_than_the_batch():
    kw = dict(snr_range=np.array([10.0]), num_channels=2, mmse_avg=3,
              device="cpu")
    a = run_mmse_estimation(_zero, tiny_cfg(), **kw)  # B = 6, one chunk
    b = run_mmse_estimation(_zero, tiny_cfg(), chunk_size=16, **kw)  # 6 -> 16
    np.testing.assert_allclose(a.nmse_mean_est, b.nmse_mean_est,
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("init", ["adjoint", "ls", "lmmse"])
def test_mmse_warm_inits_auto_cap_and_stop(init):
    res = run_mmse_estimation(
        _zero, tiny_cfg(), snr_range=np.array([0.0, 20.0]), num_channels=2,
        mmse_avg=2, init=init, coef_cap="auto", stop_step=np.array([5, 17]),
        sigma_start=38.9, alpha_step=np.array([3e-11, 1e-10]),
        device="cpu")
    assert res.nmse_mean_est.shape == (2, 2)
    assert np.isfinite(res.nmse_mean_est).all()


MMSE_LEVELS, MMSE_RATE = 5, 0.25  # sigma 39.15 down to 0.153
MMSE_SNRS = np.array([0.0, 20.0])
MMSE_C, MMSE_R = 2, 3


@pytest.fixture(scope="module")
def mmse_net():
    """A tiny NCSNv2-Deepest (ngf 8, 5 levels) with the port's random
    init, carried to flax by the JAX package's converter."""
    tm = make_score_model(ModelConfig(ngf=8, num_classes=MMSE_LEVELS,
                                      sigma_rate=MMSE_RATE), device="cpu",
                          generator=torch.Generator().manual_seed(4))
    params, _ = torch_state_dict_to_flax(
        {k: v.numpy() for k, v in tm.state_dict().items()})
    tm.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return tm, params


def _jax_mmse_draws(jcfg, seed=31):
    """(A, Y, X, z) as the JAX package's run_mmse_estimation draws them
    (mmse.py:98-127, default seeds and pilot density): z is its noise init
    and its warm inits' perturbation, one draw of one key."""
    train = JChannelDataset(1234, jcfg.data, norm="global")
    num_pilots = int(np.floor(64 * 0.6))
    val_cfg = dataclasses.replace(jcfg.data, spacing_list=(0.5,))
    val = JChannelDataset(4321, val_cfg, norm=list(train.norm_stats),
                          num_pilots=num_pilots)
    kp, km, ki, _ = jax.random.split(jax.random.key(seed), 4)
    X = val.hermitian_c2()[:MMSE_C]
    A = jcplx.conj_transpose(jcplx.qpsk_pilots(kp, MMSE_C, 64, num_pilots))
    S = len(MMSE_SNRS)
    npow = np.asarray(jphysics.snr_to_noise_power(MMSE_SNRS, 64), np.float32)
    Y = jphysics.measure_c2(km, jnp.tile(A, (S, 1, 1, 1)),
                            jnp.tile(X, (S, 1, 1, 1)),
                            jnp.repeat(jnp.asarray(npow), MMSE_C))
    z = jcplx.randn(ki, (MMSE_R * S * MMSE_C,) + X.shape[1:-1])
    return tuple(np.asarray(a) for a in (A, Y, X, z))


@pytest.mark.parametrize("init", ["noise", "adjoint", "ls", "lmmse"])
def test_mmse_with_the_jax_draws_matches_jax(init, mmse_net, monkeypatch):
    """run_mmse_estimation against the JAX package's, fed its draws, at
    beta = 0 (the Langevin update is then deterministic): per-SNR alpha
    (tiled over the rows r*(S*C) + s*C + c), coef_cap "auto" (binding at
    the top levels), per-SNR stop steps as capture levels, the 0.01
    perturbation of a warm init, padding (chunks of 5 over 12 rows), and
    for lmmse the sigma_start truncation. nmse_mean_est and nmse_single
    within rtol 1e-4. The two packages' generators draw different training
    channels, so the lmmse init is given the JAX train set's empirical
    covariance."""
    tm, params = mmse_net
    jcfg = JConfig(model=JModelConfig(ngf=8, num_classes=MMSE_LEVELS,
                                      sigma_rate=MMSE_RATE),
                   data=JDataConfig(num_channels=8))
    cfg = Config(model=ModelConfig(ngf=8, num_classes=MMSE_LEVELS,
                                   sigma_rate=MMSE_RATE),
                 data=DataConfig(num_channels=8))
    kw = dict(snr_range=MMSE_SNRS, num_channels=MMSE_C, mmse_avg=MMSE_R,
              init=init, alpha_step=np.array([1e-4, 3e-4]), beta_noise=0.0,
              stop_step=np.array([5, 11]), coef_cap="auto",
              sigma_start=10.0 if init == "lmmse" else None)
    if init == "lmmse":
        cov = jax_empirical_covariance(
            JChannelDataset(1234, jcfg.data, norm="global"))
        monkeypatch.setattr(lmmse_mod, "empirical_covariance",
                            lambda train_ds: cov)
    want = jax_run_mmse(jax_score_fn(jax_model(jcfg.model), params), jcfg,
                        **kw)
    got = run_mmse_estimation(score_fn_from_params(tm), cfg, chunk_size=5,
                              device="cpu", _draws=_jax_mmse_draws(jcfg),
                              **kw)
    assert np.isfinite(want.nmse_mean_est).all()
    assert got.nmse_mean_est.shape == (2, MMSE_C)
    np.testing.assert_allclose(got.nmse_mean_est, want.nmse_mean_est,
                               rtol=1e-4)
    np.testing.assert_allclose(got.nmse_single, want.nmse_single, rtol=1e-4)


def test_auto_coef_cap_is_half_over_the_largest_eigenvalue():
    rng = np.random.default_rng(5)
    A = _pilots(rng, 4, 64, 38)
    Ac = jcplx.to_complex(A).astype(np.complex128)
    want = 0.5 / np.linalg.svd(Ac, compute_uv=False)[:, 0] ** 2
    np.testing.assert_allclose(auto_coef_cap(t(A)), want, rtol=1e-6)


# -- lmmse --------------------------------------------------------------------

def test_analytic_covariance_matches_jax():
    got = analytic_covariance("CDL-B", num_rx=4, num_tx=8, spacing=0.5)
    want = jax_analytic_covariance("CDL-B", num_rx=4, num_tx=8, spacing=0.5)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-13)


# -- the commands, on the CPU at tiny sizes -----------------------------------

@pytest.mark.parametrize("cmd,argv", [
    ("ls", ["--snr", "0", "10", "--num_channels", "2"]),
    ("lasso", ["--snr", "10", "--num_channels", "2", "--steps", "5"]),
    ("amp", ["--snr", "10", "--num_channels", "2", "--iters", "3"]),
    ("lmmse", ["--snr", "10", "--num_channels", "2", "--cov", "analytic"]),
    ("lmmse", ["--snr", "10", "--num_channels", "2"]),
])
def test_baseline_cli_on_the_cpu(cmd, argv, tmp_path, capsys):
    import importlib

    mod = importlib.import_module(f"score_based_channels_torch.baselines.{cmd}")
    out = str(tmp_path / "res.npz")
    mod.main(argv + ["--device", "cpu", "--output", out])
    printed = capsys.readouterr().out
    assert "NMSE" in printed and "saved" in printed
    with np.load(out) as f:
        assert all(np.isfinite(f[k]).all() for k in f.files)


def test_mmse_cli_on_the_cpu(tmp_path, capsys):
    from score_based_channels_torch.baselines.mmse import main
    from score_based_channels_torch.models import (
        make_score_model, state_dict_to_jax_params,
    )
    from score_based_channels_torch.utils.checkpoint import save_checkpoint

    cfg = tiny_cfg()
    model = make_score_model(cfg.model, device="cpu",
                             generator=torch.Generator().manual_seed(1))
    ck = str(tmp_path / "ck.npz")
    save_checkpoint(ck, cfg, state_dict_to_jax_params(model.state_dict()))
    out = str(tmp_path / "mmse.npz")
    main(["--device", "cpu", "--checkpoint", ck, "--snr", "10",
          "--num_channels", "2", "--mmse_avg", "2", "--init", "ls",
          "--coef_cap", "auto", "--chunk", "4", "--output", out])
    assert "MMSE-avg NMSE" in capsys.readouterr().out
    with np.load(out) as f:
        assert f["nmse_mean_est"].shape == (1, 2)
