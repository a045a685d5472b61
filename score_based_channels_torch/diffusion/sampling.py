"""Annealed-Langevin samplers, the counterpart of the JAX package's
diffusion/sampling.py: the posterior sampler for channel estimation
(:56-171) and its complex wrapper (:174), and the unconditional (:202),
inpainting (:241) and interpolation (:284) samplers of NCSNv2
(ncsnv2/models/__init__.py:20-137).

Update rule (test_score.py:143-165, Algorithm 1 of the paper), per level i
and inner step:
  alpha_i = alpha_step * (sigma_i / sigma_end)^2
  x <- x + alpha_i*s(x, sigma_i) - c_i * A^H(A x - y) + sqrt(2 alpha_i beta) z,
  c_i = alpha_i / (noise/2 + sigma_i^2)  (optionally capped)

The JAX package's `lax.scan` over levels is a Python loop here with no
host synchronisation inside it: sigma and every per-sample value stay
tensors on the state's device, and the per-step NMSE trace is written into
a device tensor that the caller copies to the host once.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from .. import cplx


def _per_sample(v, like: torch.Tensor) -> torch.Tensor:
    """Scalar or (B,) value -> f32 tensor broadcastable against (B, M, N)."""
    v = torch.as_tensor(v, dtype=torch.float32, device=like.device)
    return v if v.dim() == 0 else v.reshape(v.shape + (1, 1))


@torch.no_grad()
def annealed_langevin_posterior_c2(
    score_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    A: torch.Tensor,
    Y: torch.Tensor,
    sigmas: torch.Tensor,
    noise_power,
    x_init: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    alpha_step=3e-11,
    beta_noise=0.01,
    steps_each: int = 3,
    oracle: Optional[torch.Tensor] = None,
    capture_level: Optional[torch.Tensor] = None,
    coef_cap=None,
    start_level: Optional[torch.Tensor] = None,
    noise_fn: Optional[Callable[[int, int], torch.Tensor]] = None,
    noise_rows: Optional[Tuple[int, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the annealed-Langevin posterior schedule (c2).

    Args mirror the JAX function:
      score_fn: (x (B,Nt,Nr,2), sigma 0-d tensor) -> score (B,Nt,Nr,2) f32,
        already divided by sigma.
      A: (B, Np, Nt, 2) pilot operator; Y: (B, Np, Nr, 2) measurements.
      sigmas: (L,) schedule, sigmas[-1] = sigma_end.
      noise_power, alpha_step, beta_noise, coef_cap: scalar or (B,).
      x_init: (B, Nt, Nr, 2); the state's device is the device of the run.
      generator: draws z on its device (must be x_init's device).
      oracle: (B, Nt, Nr, 2); when given, the (L*steps_each, B) NMSE trace
        is returned (on the device).
      capture_level: (B,) int, the level after whose last step the
        returned iterate is taken. start_level: (B,) int, first active
        level per sample (before it the sample holds its init).
      noise_fn: optional (level, step) -> z (B, Nt, Nr, 2) in place of the
        generator's draws (lets a test inject another sampler's draws).
      noise_rows: (n, keep): each step draws z for n rows and keeps rows
        `keep` (a data-parallel rank's rows of its chunk), so a row's
        noise does not depend on how the chunk is split.

    Returns (x_final or the captured iterate, nmse trace or None).
    """
    dev = x_init.device
    if noise_fn is None and (generator is None
                             or generator.device.type != dev.type):
        raise ValueError("pass a torch.Generator on the state's device, or "
                         "noise_fn")
    A, Y = A.to(dev), Y.to(dev)
    sigmas = sigmas.to(dev, torch.float32)
    sigma_end = sigmas[-1]
    Ah = cplx.conj_transpose(A)
    np_b = _per_sample(noise_power, x_init)
    alpha_b = _per_sample(alpha_step, x_init)
    beta_b = _per_sample(beta_noise, x_init)
    cap_b = _per_sample(coef_cap, x_init) if coef_cap is not None else None
    start = (torch.as_tensor(start_level, device=dev)
             if start_level is not None else None)
    cap_lvl = (torch.as_tensor(capture_level, device=dev)
               if capture_level is not None else None)

    L = sigmas.shape[0]
    B = x_init.shape[0]
    x = x_init.to(torch.float32)
    x_cap = x.clone() if cap_lvl is not None else None
    trace = None
    if oracle is not None:
        oracle = oracle.to(dev)
        oracle_energy = cplx.sum_abs2(oracle, dim=(-1, -2))
        trace = torch.empty((L * steps_each, B), dtype=torch.float32,
                            device=dev)

    for lvl in range(L):
        sigma = sigmas[lvl]
        alpha = alpha_b * (sigma / sigma_end) ** 2
        if start is not None:
            alpha = alpha * _per_sample((start <= lvl).float(), x_init)
        coef = alpha / (np_b / 2.0 + sigma ** 2)
        if cap_b is not None:
            coef = torch.minimum(coef, cap_b)
        noise_scale = torch.sqrt(2.0 * alpha * beta_b)
        for step in range(steps_each):
            score = score_fn(x, sigma)
            meas_grad = cplx.matmul(Ah, cplx.matmul(A, x) - Y)
            if noise_fn is not None:
                z = noise_fn(lvl, step).to(dev)
            elif noise_rows is None:
                z = cplx.randn(generator, x.shape[:-1])
            else:
                z = cplx.randn(generator, (noise_rows[0],)
                               + tuple(x.shape[1:-1]))[noise_rows[1]]
            x = (x + cplx.scale(score, alpha) - cplx.scale(meas_grad, coef)
                 + cplx.scale(z, noise_scale))
            if trace is not None:
                err = cplx.sum_abs2(x - oracle, dim=(-1, -2))
                trace[lvl * steps_each + step] = err / oracle_energy
        if x_cap is not None:
            latch = (cap_lvl == lvl).reshape(B, 1, 1, 1)
            x_cap = torch.where(latch, x, x_cap)
    return (x_cap if x_cap is not None else x), trace


def annealed_langevin_posterior(
    score_fn_c2: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    A: torch.Tensor,
    Y: torch.Tensor,
    sigmas: torch.Tensor,
    noise_power,
    x_init: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    alpha_step=3e-11,
    beta_noise=0.01,
    steps_each: int = 3,
    oracle: Optional[torch.Tensor] = None,
    noise_fn: Optional[Callable[[int, int], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Complex wrapper over the c2 core (sampling.py:174): A, Y, x_init and
    oracle are complex tensors; score_fn_c2 still takes and returns the c2
    NHWC state. Returns (complex x_final, NMSE trace or None)."""
    c2 = lambda t: None if t is None else torch.view_as_real(
        t.to(torch.complex64).contiguous())
    x, trace = annealed_langevin_posterior_c2(
        score_fn_c2, c2(A), c2(Y), sigmas, noise_power, c2(x_init),
        generator, alpha_step=alpha_step, beta_noise=beta_noise,
        steps_each=steps_each, oracle=c2(oracle), noise_fn=noise_fn)
    return torch.view_as_complex(x.contiguous()), trace


def _drawer(generator: Optional[torch.Generator], noise_fn, dev):
    """The (level, step) -> draws function of a sampler: noise_fn, or
    standard normal draws of the given shapes from `generator`."""
    if noise_fn is not None:
        return lambda lvl, step, shapes: noise_fn(lvl, step)
    if generator is None or generator.device.type != dev.type:
        raise ValueError("pass a torch.Generator on the state's device, or "
                         "noise_fn")
    return lambda lvl, step, shapes: tuple(
        torch.randn(s, generator=generator, device=dev) for s in shapes)


@torch.no_grad()
def annealed_langevin_unconditional(
    score_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x_init: torch.Tensor,
    sigmas: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    n_steps_each: int = 200,
    step_lr: float = 8e-6,
    denoise: bool = True,
    noise_fn: Optional[Callable[[int, int], Sequence[torch.Tensor]]] = None,
) -> torch.Tensor:
    """Prior sampling (sampling.py:202): per level i and inner step,
      step = step_lr (sigma_i / sigma_end)^2;  x <- x + step s + sqrt(2 step) z,
    then, with `denoise`, x <- x + sigma_end^2 s(x, sigma_end). x is real
    NHWC; noise_fn(level, step) returns (z,)."""
    dev = x_init.device
    draw = _drawer(generator, noise_fn, dev)
    sigmas = sigmas.to(dev, torch.float32)
    sigma_end = sigmas[-1]
    x = x_init.to(torch.float32)
    for lvl in range(sigmas.shape[0]):
        sigma = sigmas[lvl]
        step = step_lr * (sigma / sigma_end) ** 2
        amp = torch.sqrt(2.0 * step)
        for i in range(n_steps_each):
            s = score_fn(x, sigma)
            z, = draw(lvl, i, [x.shape])
            x = x + step * s + amp * z.to(dev)
    if denoise:
        x = x + sigma_end ** 2 * score_fn(x, sigma_end)
    return x


@torch.no_grad()
def annealed_langevin_inpainting(
    score_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x_init: torch.Tensor,
    refer_x: torch.Tensor,
    known_mask,
    sigmas: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    n_steps_each: int = 100,
    step_lr: float = 8e-6,
    noise_fn: Optional[Callable[[int, int], Sequence[torch.Tensor]]] = None,
) -> torch.Tensor:
    """Inpainting (sampling.py:241): at every step the known region
    (known_mask 1.0, broadcastable to x) is re-imposed as
    refer_x + sigma n1, then the Langevin step with noise z.
    noise_fn(level, step) returns (n1, z)."""
    dev = x_init.device
    draw = _drawer(generator, noise_fn, dev)
    sigmas = sigmas.to(dev, torch.float32)
    sigma_end = sigmas[-1]
    refer_x = refer_x.to(dev, torch.float32)
    mask = torch.as_tensor(known_mask, dtype=torch.float32, device=dev)
    x = x_init.to(torch.float32)
    for lvl in range(sigmas.shape[0]):
        sigma = sigmas[lvl]
        step = step_lr * (sigma / sigma_end) ** 2
        amp = torch.sqrt(2.0 * step)
        for i in range(n_steps_each):
            n1, z = draw(lvl, i, [refer_x.shape, x.shape])
            corrupted = refer_x + sigma * n1.to(dev)
            x = mask * corrupted + (1.0 - mask) * x
            s = score_fn(x, sigma)
            x = x + step * s + amp * z.to(dev)
    return x


@torch.no_grad()
def annealed_langevin_interpolation(
    score_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x_init: torch.Tensor,
    sigmas: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    n_interpolations: int = 8,
    n_steps_each: int = 200,
    step_lr: float = 8e-6,
    noise_fn: Optional[Callable[[int, int], Sequence[torch.Tensor]]] = None,
) -> torch.Tensor:
    """Interpolation (sampling.py:284): each of the B rows is repeated
    n_interpolations times, and row j of a group takes the noise
    cos(t_j) zp + sin(t_j) zq, t_j on a quarter circle, from two draws
    zp, zq of shape (B, ...). Returns (B * n_interpolations, ...).
    noise_fn(level, step) returns (zp, zq)."""
    dev = x_init.device
    draw = _drawer(generator, noise_fn, dev)
    sigmas = sigmas.to(dev, torch.float32)
    sigma_end = sigmas[-1]
    B, ni = x_init.shape[0], n_interpolations
    x = x_init.to(torch.float32).repeat_interleave(ni, dim=0)
    angles = torch.linspace(0.0, torch.pi / 2.0, ni, device=dev)
    w_shape = (1, ni) + (1,) * (x.dim() - 1)
    cosw, sinw = angles.cos().reshape(w_shape), angles.sin().reshape(w_shape)
    shape = (B,) + tuple(x.shape[1:])
    for lvl in range(sigmas.shape[0]):
        sigma = sigmas[lvl]
        step = step_lr * (sigma / sigma_end) ** 2
        amp = torch.sqrt(2.0 * step)
        for i in range(n_steps_each):
            zp, zq = draw(lvl, i, [shape, shape])
            z = (zp.to(dev)[:, None] * cosw
                 + zq.to(dev)[:, None] * sinw).reshape(x.shape)
            s = score_fn(x, sigma)
            x = x + step * s + amp * z
    return x
