"""The port's posterior sampler and estimate harness against the JAX
package.

beta = 0 makes the update deterministic, so x_final and the NMSE trace of
both packages must agree; beta > 0 is checked by rebuilding the JAX draws
(the split / cplx.randn sequence of diffusion/sampling.py:143-146) and
injecting them through noise_fn. Tolerance: measured on the CPU at this
size, x_final agrees to 2.9e-7 and the trace to 1.2e-6 of their largest
magnitude; the bar is 1e-5, room for the f32 round-off of two different
conv and matmul orders accumulated over 72 steps.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_based_channels_tpu import cplx as jcplx
from score_based_channels_tpu.baselines.lmmse import (
    lmmse_estimate_c2 as jax_lmmse_c2,
)
from score_based_channels_tpu.config import Config as JConfig
from score_based_channels_tpu.config import DataConfig as JDataConfig
from score_based_channels_tpu.config import ModelConfig as JModelConfig
from score_based_channels_tpu.diffusion.sampling import (
    annealed_langevin_posterior_c2 as jax_sampler,
)
from score_based_channels_tpu.eval.estimate import (
    EstimationResults as JaxResults, score_fn_from_params as jax_score_fn,
)
from score_based_channels_tpu.models import make_score_model as jax_model
from score_based_channels_tpu.models.torch_compat import (
    torch_state_dict_to_flax,
)
from score_based_channels_tpu.utils.checkpoint import save_checkpoint
from score_based_channels_torch.baselines.lmmse import lmmse_estimate_c2
from score_based_channels_torch.config import ModelConfig
from score_based_channels_torch.diffusion.sampling import (
    annealed_langevin_posterior_c2,
)
from score_based_channels_torch.diffusion.sigmas import get_sigmas
from score_based_channels_torch.eval.estimate import (
    langevin_chunked, main, score_fn_from_params,
)
from score_based_channels_torch.models import (
    jax_params_to_state_dict, make_score_model,
)

torch.set_num_threads(1)

TOL = 1e-5
B, L, STEPS = 8, 24, 3
# 24 levels from 39.15 down to 0.0107: alpha_step 5e-7 moves the state by
# both the score and the data term without crossing the data term's
# stability bound
SIGMA_RATE = 0.7
ALPHA = 5e-7


@pytest.fixture(scope="module")
def setup():
    mcfg = JModelConfig(ngf=8, num_classes=L, sigma_rate=SIGMA_RATE)
    jm = jax_model(mcfg)
    # the port's random init, carried to flax by the JAX package's own
    # converter (a flax init of this model takes ~20 s on the CPU)
    tm = make_score_model(ModelConfig(ngf=8, num_classes=L,
                                      sigma_rate=SIGMA_RATE), device="cpu",
                          generator=torch.Generator().manual_seed(3))
    params, _ = torch_state_dict_to_flax(
        {k: v.numpy() for k, v in tm.state_dict().items()})
    tm.load_state_dict(jax_params_to_state_dict(params), strict=True)
    rng = np.random.RandomState(0)
    X = (rng.randn(B, 64, 16, 2) * np.sqrt(0.5)).astype(np.float32)
    P = (np.sign(rng.randn(B, 64, 38, 2)) * np.sqrt(0.5)).astype(np.float32)
    A = np.array(jcplx.conj_transpose(jnp.asarray(P)))
    npow = np.full((B,), 10 ** -2 * 64, np.float32)  # 20 dB
    Y = (np.asarray(jcplx.matmul(jnp.asarray(A), jnp.asarray(X)))
         + rng.randn(B, 38, 16, 2).astype(np.float32)
         * np.sqrt(npow[:, None, None, None] / 2)).astype(np.float32)
    x0 = (rng.randn(B, 64, 16, 2) * np.sqrt(0.5)).astype(np.float32)
    sig = get_sigmas(mcfg.sigma_begin, mcfg.sigma_end, L).numpy()
    return dict(jm=jm, params=params, tm=tm, X=X, A=A, Y=Y, x0=x0,
                npow=npow, sig=sig)


def _jax_run(s, key=None, beta=0.0, **kw):
    score = jax_score_fn(s["jm"], s["params"])
    xf, tr = jax_sampler(score, jnp.asarray(s["A"]), jnp.asarray(s["Y"]),
                         jnp.asarray(s["sig"]), jnp.asarray(s["npow"]),
                         jnp.asarray(s["x0"]),
                         key if key is not None else jax.random.key(5),
                         alpha_step=ALPHA, beta_noise=beta, steps_each=STEPS,
                         oracle=jnp.asarray(s["X"]), **kw)
    return np.asarray(xf), np.asarray(tr)


def _torch_run(s, beta=0.0, noise_fn=None, **kw):
    t = torch.from_numpy
    kw = {k: t(np.asarray(v)) for k, v in kw.items()}
    xf, tr = annealed_langevin_posterior_c2(
        score_fn_from_params(s["tm"]), t(s["A"]), t(s["Y"]), t(s["sig"]),
        t(s["npow"]), t(s["x0"]), generator=torch.Generator().manual_seed(5),
        alpha_step=ALPHA, beta_noise=beta, steps_each=STEPS,
        oracle=t(s["X"]), noise_fn=noise_fn, **kw)
    return xf.numpy(), tr.numpy()


def _close(got, want):
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err < TOL, f"relative error {err:.2e}"


def test_beta0_matches_jax(setup):
    jx, jt = _jax_run(setup)
    tx, tt = _torch_run(setup)
    assert tt.shape == (L * STEPS, B)
    assert abs(np.log(jt[-1].mean() / jt[0].mean())) > 0.2  # it moved
    _close(tx, jx)
    _close(tt, jt)


def test_injected_jax_draws_match_jax(setup):
    key = jax.random.key(9)
    draws, k = [], key
    for _ in range(L * STEPS):  # the sequence of sampling.py:143-146
        k, kn = jax.random.split(k)
        draws.append(np.array(jcplx.randn(kn, (B, 64, 16))))
    jx, jt = _jax_run(setup, key=key, beta=0.5)
    tx, tt = _torch_run(setup, beta=0.5, noise_fn=lambda lvl, st: torch.from_numpy(
        draws[lvl * STEPS + st]))
    _close(tx, jx)
    _close(tt, jt)


def test_capture_start_and_cap_match_jax(setup):
    kw = dict(capture_level=np.array([0, 5, 23, 10, 3, 23, 17, 1], np.int32),
              start_level=np.array([0, 0, 12, 4, 0, 20, 1, 0], np.int32),
              coef_cap=np.float32(2e-4))
    jx, jt = _jax_run(setup, **kw)
    tx, tt = _torch_run(setup, **kw)
    _close(tx, jx)
    _close(tt, jt)


def test_chunked_ragged_tail_equals_unchunked(setup):
    s = setup
    t = torch.from_numpy
    args = (score_fn_from_params(s["tm"]), t(s["A"]), t(s["Y"]),
            t(s["sig"][:6]), t(s["npow"]), t(s["x0"]), 3, ALPHA, 0.0)
    kw = dict(steps_each=2, oracle2=t(s["X"]), device="cpu",
              capture_level=t(np.arange(B) % 6))
    x1, tr1 = langevin_chunked(*args, **kw)
    x3, tr3 = langevin_chunked(*args, chunk_size=3, **kw)  # 8 = 3 + 3 + 2
    assert x1.shape == (B, 64, 16) and x1.dtype == np.complex64
    assert tr3.shape == tr1.shape == (12, B)
    np.testing.assert_allclose(x3, x1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tr3, tr1, rtol=1e-5, atol=1e-7)


def test_lmmse_matches_jax():
    rng = np.random.RandomState(3)
    Bs, Np, Nt, Nr = 3, 5, 8, 4
    A2 = rng.randn(Bs, Np, Nt, 2).astype(np.float32)
    Y2 = rng.randn(Bs, Np, Nr, 2).astype(np.float32)
    G = rng.randn(Nt * Nr, Nt * Nr) + 1j * rng.randn(Nt * Nr, Nt * Nr)
    Cov = G @ G.conj().T / (Nt * Nr)
    npow = np.array([0.1, 1.0, 3.0])
    want, wpred = jax_lmmse_c2(jnp.asarray(A2), jnp.asarray(Y2), npow, Cov,
                               predict_mmse=True)
    got, gpred = lmmse_estimate_c2(torch.from_numpy(A2), torch.from_numpy(Y2),
                                   npow, Cov, predict_mmse=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gpred, wpred, rtol=1e-10)


def _write_channels(data_dir, seed, n, rng):
    h = (rng.randn(n, 1, 16, 64) + 1j * rng.randn(n, 1, 16, 64)) * 0.3
    np.savez(data_dir / f"CDL-C_Nt64_Nr16_ULA0.50_seed{seed}.npz",
             output_h=h.astype(np.complex64))


def test_main_writes_results_the_jax_package_reads(setup, tmp_path, capsys):
    rng = np.random.RandomState(4)
    _write_channels(tmp_path, 1234, 16, rng)  # train: stats + covariance
    _write_channels(tmp_path, 4321, 8, rng)   # test channels
    cfg = JConfig(model=JModelConfig(ngf=8, num_classes=L,
                                     sigma_rate=SIGMA_RATE),
                  data=JDataConfig(source="file", data_dir=str(tmp_path)))
    ck = str(tmp_path / "final_model.npz")
    save_checkpoint(ck, cfg, setup["params"])
    out = str(tmp_path / "res" / "results.npz")
    main(["--device", "cpu", "--checkpoint", ck, "--snr", "10", "30",
          "--num_channels", "4", "--chunk", "8", "--dtype", "float32",
          "--output", out])
    assert "saved" in capsys.readouterr().out
    res = JaxResults.load(out)
    assert res.nmse_log.shape == (1, 1, 2, L * STEPS, 4)
    assert np.isfinite(res.nmse_log).all()
    np.testing.assert_array_equal(res.snr_range, [10.0, 30.0])
    np.testing.assert_allclose(res.best_nmse, res.avg_nmse.min(-1))
