"""The unconditional, inpainting and interpolation samplers' inner step on
static buffers (diffusion/sampling.py::_langevin, `step_table`) on the
CPU, against their eager loops.

Without noise_fn each sampler runs one step on static buffers, its sigma,
step size and noise amplitude read from `step_table` at a device step
counter; on the CPU the step runs once a step (on the card it is one
captured CUDA graph, replayed: tests/test_torch_cuda.py). With noise_fn
the eager loop runs. A noise_fn that draws from a generator as the step
does (standard normals of the same shapes, in the same order) gives the
eager loop the step's draws, so the two must agree bit for bit. The
samplers' JAX parity is tests/test_torch_samplers.py's.
"""

import pytest
import torch

from score_based_channels_torch.config import ModelConfig
from score_based_channels_torch.diffusion import (
    annealed_langevin_inpainting, annealed_langevin_interpolation,
    annealed_langevin_unconditional, get_sigmas, sampling,
)
from score_based_channels_torch.models import make_score_model

torch.set_num_threads(1)

L, STEPS, B = 3, 2, 2


@pytest.mark.parametrize("step_lr,n_steps", [(8e-6, 3), (2e-3, 1)])
def test_step_table_holds_the_eager_loops_values(step_lr, n_steps):
    """The whole default schedule (2311 levels, sigma 50 to 0.01): each
    row equals what the eager loop computes at its level, bit for bit."""
    mc = ModelConfig()
    sigmas = get_sigmas(mc.sigma_begin, mc.sigma_end, mc.num_classes).float()
    table = sampling.step_table(sigmas, step_lr, n_steps)
    assert table.shape == (mc.num_classes * n_steps, 3)
    assert table.dtype == torch.float32
    sigma_end = sigmas[-1]
    want = []
    for lvl in range(sigmas.shape[0]):  # the eager loop's operations
        sigma = sigmas[lvl]
        step = step_lr * (sigma / sigma_end) ** 2
        want += [torch.stack([sigma, step, torch.sqrt(2.0 * step)])] * n_steps
    assert torch.equal(table, torch.stack(want))


@pytest.fixture(scope="module")
def score():
    g = torch.Generator().manual_seed(0)
    model = make_score_model(ModelConfig(arch="ncsnv2", ngf=4, num_classes=L),
                             device="cpu", generator=g)
    return torch.no_grad()(lambda x, s: model(x, s))


def _draws_like_the_step(generator):
    """noise_fn drawing from `generator` what the step draws."""
    return lambda shapes: (lambda lvl, i: tuple(
        torch.randn(s, generator=generator) for s in shapes))


SIGMAS = get_sigmas(2.0, 0.1, L).float()
X0 = torch.randn(B, 64, 16, 2, generator=torch.Generator().manual_seed(1))
REFER = torch.randn(B, 64, 16, 2, generator=torch.Generator().manual_seed(2))
MASK = torch.zeros(1, 64, 16, 1)
MASK[:, :, :8] = 1.0
NI = 3
SAMPLERS = {
    "unconditional": (lambda fn, **k: annealed_langevin_unconditional(
        fn, X0, SIGMAS, n_steps_each=STEPS, step_lr=2e-3, **k),
        [X0.shape]),
    "inpainting": (lambda fn, **k: annealed_langevin_inpainting(
        fn, X0, REFER, MASK, SIGMAS, n_steps_each=STEPS, step_lr=2e-3, **k),
        [REFER.shape, X0.shape]),
    "interpolation": (lambda fn, **k: annealed_langevin_interpolation(
        fn, X0, SIGMAS, n_interpolations=NI, n_steps_each=STEPS,
        step_lr=2e-3, **k), [X0.shape, X0.shape]),
}


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_step_runner_equals_the_eager_loop(score, name):
    run, shapes = SAMPLERS[name]
    got = run(score, generator=torch.Generator().manual_seed(5))
    want = run(score, noise_fn=_draws_like_the_step(
        torch.Generator().manual_seed(5))(shapes))
    assert got.shape == (B * (NI if name == "interpolation" else 1), 64, 16, 2)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)
    # the step's state is its own buffer: the caller's input is untouched
    assert torch.equal(X0, torch.randn(B, 64, 16, 2,
                                       generator=torch.Generator()
                                       .manual_seed(1)))


def test_step_runner_counts_every_step(score):
    """The step counter walks the table: the score sees each level's
    sigma n_steps_each times, in order, then sigma_end once for the
    denoising forward."""
    seen = []

    def zero(x, s):
        seen.append(float(s))
        return torch.zeros_like(x)

    annealed_langevin_unconditional(zero, X0, SIGMAS,
                                    torch.Generator().manual_seed(0),
                                    n_steps_each=STEPS, denoise=True)
    assert seen == [float(s) for s in SIGMAS for _ in range(STEPS)] + [
        float(SIGMAS[-1])]
