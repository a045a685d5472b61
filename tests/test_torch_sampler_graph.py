"""The posterior runner (`PosteriorRunner`: the schedule as one level step
on static buffers, a CUDA graph on the card) on the CPU, against the plain
loop it replaces and the JAX sampler.

On the CPU the runner calls its level L times. Its arithmetic is the plain
loop's, op for op, so the two agree bit for bit, with and without each
option; `langevin_chunked` reuses one runner for every chunk, so it must
equal the plain loop run chunk by chunk on fresh tensors, bit for bit.
Against the JAX sampler the bar is test_torch_sampler.py's 1e-5 of the
largest magnitude (two conv and matmul orders in f32 over 72 steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from score_based_channels_tpu import cplx as jcplx
from score_based_channels_tpu.config import ModelConfig as JModelConfig
from score_based_channels_tpu.diffusion.sampling import (
    annealed_langevin_posterior_c2 as jax_sampler,
)
from score_based_channels_tpu.eval.estimate import (
    score_fn_from_params as jax_score_fn,
)
from score_based_channels_tpu.models import make_score_model as jax_model
from score_based_channels_tpu.models.torch_compat import (
    torch_state_dict_to_flax,
)
from score_based_channels_torch.config import ModelConfig
from score_based_channels_torch.diffusion import sampling
from score_based_channels_torch.diffusion.sampling import (
    PosteriorRunner, annealed_langevin_posterior_c2_plain,
)
from score_based_channels_torch.diffusion.sigmas import get_sigmas
from score_based_channels_torch.eval.estimate import (
    _generator, langevin_chunked, score_fn_from_params,
)
from score_based_channels_torch.models import (
    jax_params_to_state_dict, make_score_model,
)
from score_based_channels_torch.parallel.mesh import pad_to_multiple

torch.set_num_threads(1)

TOL = 1e-5
B, L, STEPS = 8, 24, 3
SIGMA_RATE = 0.7  # as test_torch_sampler.py: 24 levels, 39.15 to 0.0107
ALPHA = 5e-7


@pytest.fixture(scope="module")
def setup():
    mcfg = JModelConfig(ngf=8, num_classes=L, sigma_rate=SIGMA_RATE)
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
    return dict(jm=jax_model(mcfg), params=params, tm=tm, X=X, A=A, Y=Y,
                x0=x0, npow=npow, sig=sig)


OPTIONS = {
    "none": {},
    "oracle": dict(oracle=True),
    "capture_start_cap": dict(
        oracle=True,
        capture_level=np.array([0, 5, 23, 10, 3, 23, 17, 1], np.int32),
        start_level=np.array([0, 0, 12, 4, 0, 20, 1, 0], np.int32),
        coef_cap=np.float32(2e-4)),
    # rank 1 of 2 of a 12-row chunk: rows 6..11, the last one repeated
    "noise_rows": dict(oracle=True, noise_rows=(12, torch.tensor(
        [6, 7, 8, 9, 10, 11, 11, 11]))),
}


def _inputs(s, opts, beta):
    t = torch.from_numpy
    kw = dict(alpha_step=ALPHA, beta_noise=beta, steps_each=STEPS)
    for k in ("capture_level", "start_level", "coef_cap"):
        if k in opts:
            kw[k] = t(np.asarray(opts[k]))
    if opts.get("oracle"):
        kw["oracle"] = t(s["X"])
    args = (score_fn_from_params(s["tm"]), t(s["A"]), t(s["Y"]),
            t(s["sig"]), t(s["npow"]), t(s["x0"]))
    return args, kw


@pytest.mark.parametrize("option", list(OPTIONS))
def test_runner_equals_plain_loop_bitwise(setup, option):
    opts = OPTIONS[option]
    args, kw = _inputs(setup, opts, beta=0.5)
    noise_rows = opts.get("noise_rows")
    want_x, want_t = annealed_langevin_posterior_c2_plain(
        *args, generator=torch.Generator().manual_seed(5),
        noise_rows=noise_rows, **kw)
    score_fn, A, Y, sig, npow, x0 = args
    runner = PosteriorRunner(score_fn, sig, torch.Generator().manual_seed(5),
                             steps_each=kw.pop("steps_each"),
                             noise_rows=noise_rows)
    got_x, got_t = runner.run(A, Y, npow, x0, **kw)
    assert torch.equal(got_x, want_x)
    if want_t is None:
        assert got_t is None
    else:
        assert got_t.shape == (L * STEPS, B)
        assert torch.equal(got_t, want_t)


def test_chunked_runner_equals_plain_loop_per_chunk(setup):
    """3 chunks of 3 (8 rows: the tail padded) with every per-row input
    and beta > 0: a buffer not refreshed between chunks, or a generator
    not re-seeded, shows as a difference."""
    s, t = setup, torch.from_numpy
    levels, steps, chunk, seed = 6, 2, 3, 11
    sig = t(s["sig"][:levels])
    rng = np.random.RandomState(1)
    per_row = dict(
        noise_power=t(s["npow"] * rng.uniform(0.5, 2, B).astype(np.float32)),
        alpha_step=t(np.full(B, ALPHA, np.float32)
                     * rng.uniform(0.5, 2, B).astype(np.float32)),
        beta_noise=t(rng.uniform(0.1, 1.0, B).astype(np.float32)),
        capture_level=t(np.arange(B) % levels),
        start_level=t(np.array([0, 2, 1, 0, 3, 0, 5, 1])),
        coef_cap=t(np.full(B, 2e-4, np.float32)))
    score_fn = score_fn_from_params(s["tm"])
    calls = [0]

    def counted(x, sigma):
        calls[0] += 1
        return score_fn(x, sigma)

    sampling.reset_stats()
    x_got, tr_got = langevin_chunked(
        counted, t(s["A"]), t(s["Y"]), sig, per_row["noise_power"],
        t(s["x0"]), seed, per_row["alpha_step"], per_row["beta_noise"],
        steps_each=steps, oracle2=t(s["X"]), chunk_size=chunk,
        capture_level=per_row["capture_level"],
        start_level=per_row["start_level"], coef_cap=per_row["coef_cap"],
        device="cpu")
    n_chunks = -(-B // chunk)
    assert sampling.STATS["forwards"] == steps * levels * n_chunks
    assert sampling.STATS["forwards"] == calls[0]
    assert sampling.STATS["levels"] == levels * n_chunks
    assert sampling.STATS["captures"] == sampling.STATS["replays"] == 0

    xs, trs = [], []
    for start in range(0, B, chunk):
        rows = slice(start, min(start + chunk, B))
        pad = lambda v: pad_to_multiple(v[rows], chunk)[0]
        xf, tr = annealed_langevin_posterior_c2_plain(
            score_fn, pad(t(s["A"])), pad(t(s["Y"])), sig,
            pad(per_row["noise_power"]), pad(t(s["x0"])),
            generator=_generator(seed, start),
            alpha_step=pad(per_row["alpha_step"]),
            beta_noise=pad(per_row["beta_noise"]), steps_each=steps,
            oracle=pad(t(s["X"])), capture_level=pad(per_row["capture_level"]),
            start_level=pad(per_row["start_level"]),
            coef_cap=pad(per_row["coef_cap"]))
        n = rows.stop - rows.start
        xs.append(xf[:n])
        trs.append(tr[:, :n])
    want_x = torch.cat(xs).numpy()
    want_tr = torch.cat(trs, dim=1).numpy()
    np.testing.assert_array_equal(x_got.real, want_x[..., 0])
    np.testing.assert_array_equal(x_got.imag, want_x[..., 1])
    np.testing.assert_array_equal(tr_got, want_tr)


def test_runner_rejects_other_inputs_on_a_later_run(setup):
    args, kw = _inputs(setup, OPTIONS["oracle"], beta=0.0)
    score_fn, A, Y, sig, npow, x0 = args
    runner = PosteriorRunner(score_fn, sig[:2], torch.Generator(),
                             steps_each=1)
    kw.pop("steps_each")
    runner.run(A, Y, npow, x0, **kw)
    kw.pop("oracle")
    with pytest.raises(ValueError, match="same inputs"):
        runner.run(A, Y, npow, x0, **kw)


def _jax_run(s, **kw):
    xf, tr = jax_sampler(jax_score_fn(s["jm"], s["params"]),
                         jnp.asarray(s["A"]), jnp.asarray(s["Y"]),
                         jnp.asarray(s["sig"]), jnp.asarray(s["npow"]),
                         jnp.asarray(s["x0"]), jax.random.key(5),
                         alpha_step=ALPHA, beta_noise=0.0, steps_each=STEPS,
                         oracle=jnp.asarray(s["X"]),
                         **{k: jnp.asarray(v) for k, v in kw.items()})
    return np.asarray(xf), np.asarray(tr)


def _close(got, want):
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err < TOL, f"relative error {err:.2e}"


@pytest.mark.parametrize("option", ["oracle", "capture_start_cap"])
def test_runner_matches_jax_at_beta0(setup, option):
    opts = OPTIONS[option]
    args, kw = _inputs(setup, opts, beta=0.0)
    score_fn, A, Y, sig, npow, x0 = args
    runner = PosteriorRunner(score_fn, sig, torch.Generator().manual_seed(5),
                             steps_each=kw.pop("steps_each"))
    got_x, got_t = runner.run(A, Y, npow, x0, **kw)
    want_x, want_t = _jax_run(setup, **{k: v for k, v in opts.items()
                                        if k != "oracle"})
    assert abs(np.log(want_t[-1].mean() / want_t[0].mean())) > 0.2  # moved
    _close(got_x.numpy(), want_x)
    _close(got_t.numpy(), want_t)
