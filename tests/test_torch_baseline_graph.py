"""FISTA (`fista_l1_lifted`) and EM-GM-AMP (`em_gm_amp`) as one iteration
on static buffers (on the card, one captured CUDA graph replayed for
every iteration), on the CPU, against the Python loops they replace
(`*_plain`) and the JAX package's scans.

On the CPU `_graph.run_steps` calls the iteration once an iteration, and
the iteration runs the plain loop's operations on buffers updated in
place: equal bit for bit in the estimate and the trace. FISTA's momentum
factors come from a float32 table made by the host recurrence the loop
ran: equal bit for bit. Against JAX the bars are test_torch_baselines.py's:
FISTA 1e-4 of max|H| and the trace within 1e-4 relative; EM-GM-AMP 1e-3
of max|H| and the final NMSE within 0.01 dB.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_based_channels_tpu import cplx as jcplx
from score_based_channels_tpu.baselines.amp import em_gm_amp as jax_amp
from score_based_channels_tpu.baselines.lasso import (
    fista_l1_lifted as jax_fista, lifted_fourier_dicts as jax_dicts,
)
from score_based_channels_torch import cplx
from score_based_channels_torch.baselines import lasso
from score_based_channels_torch.baselines.amp import (
    em_gm_amp, em_gm_amp_plain,
)
from score_based_channels_torch.baselines.lasso import (
    fista_l1_lifted, fista_l1_lifted_plain, fista_momentum,
    lifted_fourier_dicts, run_lasso_baseline,
)
from score_based_channels_torch.config import Config, DataConfig, ModelConfig

torch.set_num_threads(1)


def _case(seed, B, Nt=64, Nr=16, Np=38, lift=4, noise=0.3):
    """(A, Y, X, L, R) c2 tensors: QPSK pilots, Gaussian channels."""
    g = torch.Generator().manual_seed(seed)
    A = cplx.conj_transpose(cplx.qpsk_pilots(g, B, Nt, Np))
    X = cplx.randn(g, (B, Nt, Nr))
    Y = cplx.matmul(A, X) + noise * cplx.randn(g, (B, Np, Nr))
    L, R = (cplx.from_complex(d) for d in lifted_fourier_dicts(Nt, Nr, lift))
    return A, Y, X, L, R


def _sparse(seed, B, strong=4, weak=12, scale=30.0, noise=1e-2):
    """B heavy-tailed sparse channels in the lifted dictionary (16x8, lift
    2, full pilots), as tests/test_baselines.py:136-200 draws them."""
    rng = np.random.default_rng(seed)
    Nt, Nr, lift = 16, 8, 2
    L, R = lifted_fourier_dicts(Nt, Nr, lift)
    Z = np.zeros((B, Nt * lift, Nr * lift), np.complex64)
    crand = lambda: rng.standard_normal() + 1j * rng.standard_normal()
    for b in range(B):
        for k in range(strong + weak):
            Z[b, rng.integers(Nt * lift), rng.integers(Nr * lift)] = (
                scale if k < strong else 1.0) * crand()
    X = cplx.from_complex(L @ Z @ R)
    P = (np.sign(rng.standard_normal((B, Nt, Nt, 2)))
         * np.sqrt(0.5)).astype(np.float32)
    A = cplx.conj_transpose(torch.from_numpy(P))
    Y = cplx.matmul(A, X) + torch.from_numpy(
        (rng.standard_normal((B, Nt, Nr, 2)) * np.sqrt(0.5) * noise
         ).astype(np.float32))
    return A, Y, X, cplx.from_complex(L), cplx.from_complex(R)


def test_fista_momentum_is_the_host_recurrence_bitwise():
    """The table against the loop's float32 recurrence over 1,000
    iterations (the lasso default)."""
    got = fista_momentum(1000)
    t = np.float32(1.0)
    for it in range(1000):
        tnew = (np.float32(1.0) + np.sqrt(np.float32(1.0)
                                          + np.float32(4.0) * t * t)
                ) / np.float32(2.0)
        assert got[it] == (t - np.float32(1.0)) / tnew, it
        t = tnew
    assert got.dtype == np.float32 and got[0] == 0 and 0.99 < got[-1] < 1


@pytest.mark.parametrize("oracle", [True, False])
def test_fista_equals_the_plain_loop_bitwise(oracle):
    A, Y, X, L, R = _case(0, 3)
    lm = torch.tensor([0.3, 0.1, 0.3])
    kw = dict(num_iters=40, oracle2=X if oracle else None)
    got = fista_l1_lifted(A, Y, L, R, lm, 3e-3, **kw)
    want = fista_l1_lifted_plain(A, Y, L, R, lm, 3e-3, **kw)
    assert torch.equal(got[0], want[0])
    if oracle:
        assert got[1].shape == (40, 3) and torch.equal(got[1], want[1])
    else:
        assert got[1] is None and want[1] is None


@pytest.mark.parametrize("K", [1, 3])
def test_amp_equals_the_plain_loop_bitwise(K):
    """Two heavy-tailed sparse channels and a Gaussian one: a mix of
    accepted and rejected steps."""
    sparse, gauss = _sparse(3, 2), _case(1, 1, 16, 8, 16, 2)
    A, Y, X = (torch.cat(t) for t in zip(sparse[:3], gauss[:3]))
    L, R = sparse[3:]
    got = em_gm_amp(A, Y, L, R, num_iters=30, num_components=K, oracle2=X)
    want = em_gm_amp_plain(A, Y, L, R, num_iters=30, num_components=K,
                           oracle2=X)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].shape == (30, 3)


def test_fista_chunks_match_jax():
    """Five rows in chunks of 3 and 2 (a last chunk of another batch size)
    against the JAX scan over all five, per-sample lambda."""
    A, Y, X, L, R = _case(4, 5, noise=0.8)
    lm = np.array([0.3, 0.1, 0.3, 0.2, 0.3], np.float32)
    L2, R2 = (jcplx.from_complex(d) for d in jax_dicts(64, 16, 4))
    want, wtr = jax_fista(*(jnp.asarray(t.numpy()) for t in (A, Y)), L2, R2,
                          lm, 3e-3, num_iters=50,
                          oracle2=jnp.asarray(X.numpy()))
    want, wtr = np.asarray(want), np.asarray(wtr)
    parts = [fista_l1_lifted(A[s], Y[s], L, R, torch.from_numpy(lm[s]), 3e-3,
                             num_iters=50, oracle2=X[s])
             for s in (slice(0, 3), slice(3, 5))]
    got = torch.cat([p[0] for p in parts]).numpy()
    gtr = torch.cat([p[1] for p in parts], dim=1).numpy()
    assert wtr[-1].mean() < 0.9 * wtr[0].mean()  # it moved
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(gtr, wtr, rtol=1e-4)


def test_amp_matches_jax_at_batch_two():
    """Two heavy-tailed sparse channels in one batch through the
    iteration's buffers, against the JAX scan (K = 3, 80 iterations)."""
    A, Y, X, L, R = _sparse(5, 2)
    want, wtr = jax_amp(*(jnp.asarray(t.numpy()) for t in (A, Y, L, R)),
                        num_iters=80, oracle2=jnp.asarray(X.numpy()))
    got, gtr = em_gm_amp(A, Y, L, R, num_iters=80, oracle2=X)
    want, wtr = np.asarray(want), np.asarray(wtr)
    assert np.abs(got.numpy() - want).max() <= 1e-3 * X.abs().max().item()
    db = np.abs(10 * np.log10(gtr[-1].numpy() / wtr[-1]))
    assert db.max() <= 0.01, db
    assert (wtr[-1] < 0.2 * wtr[0]).all()  # the recursion moved


def test_lasso_last_chunk_of_another_size_equals_the_plain_loop(monkeypatch):
    """run_lasso_baseline in chunks of 5 over 2 SNRs x 2 lambdas x 3
    channels (12 rows: chunks of 5, 5 and 2), through the iteration and
    through the plain loop: the same NMSE, bit for bit."""
    cfg = Config(model=ModelConfig(ngf=8, num_classes=6),
                 data=DataConfig(num_channels=8))
    kw = dict(snr_range=np.array([0.0, 20.0]), lmbda_range=(0.3, 0.1),
              num_iters=15, num_channels=3, chunk_size=5, device="cpu")
    calls = []

    def counted(A2, *args, **kwargs):
        calls.append(A2.shape[0])
        return fista_l1_lifted(A2, *args, **kwargs)

    monkeypatch.setattr(lasso, "fista_l1_lifted", counted)
    got = run_lasso_baseline(cfg, **kw)
    assert calls == [5, 5, 2]
    monkeypatch.setattr(lasso, "fista_l1_lifted", fista_l1_lifted_plain)
    want = run_lasso_baseline(cfg, **kw)
    np.testing.assert_array_equal(got.complete_log, want.complete_log)
    assert np.isfinite(got.nmse_log).all()
