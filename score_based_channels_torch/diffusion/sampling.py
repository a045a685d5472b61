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

The JAX package runs the posterior schedule as one `lax.scan`, compiled
once per call (sampling.py:159-167). Here `PosteriorRunner` runs it as one
function of one level on static buffers: every value that depends on the
level comes from device tensors (a level counter that the level advances
itself, sigma by index_select, the start gate, the capture latch, the
trace rows), so the same work serves every level. On the CPU the level
runs L times. On the card it is captured once in a CUDA graph and
replayed for every level (`_graph.Replayer`), so the host no longer
launches the ~1,000 kernels of a level one by one: a Python loop over
levels with no host synchronisation still left the host setting the
pace, at 5.3-10 ms of host time against ~4.3 ms of card time per bf16
forward at batch 256. Under `_graph.eager()` the same level runs
eagerly: the yardstick the graph is held against.

The JAX package runs each of the other samplers as one `lax.scan` over
levels of a `lax.fori_loop` over inner steps (sampling.py:232/235,
:277/280, :325/328). Here each runs one inner step on static buffers
(`_langevin`: sigma and step size from `step_table` at a device step
counter), on the card captured once and replayed for every step.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence, Tuple

import torch

from .. import _graph, cplx
from ..utils.spans import span

# Counts of the posterior runner since `reset_stats`: forwards and levels
# run on the device (eager or replayed); its graphs' captures and replays
# are `_graph.STATS`'.
STATS = dict(forwards=0, levels=0)


def reset_stats() -> None:
    """Set the runner's counts in STATS to 0."""
    for k in STATS:
        STATS[k] = type(STATS[k])(0)


def _per_sample(v, like: torch.Tensor) -> torch.Tensor:
    """Scalar or (B,) value -> f32 tensor broadcastable against (B, M, N)."""
    v = torch.as_tensor(v, dtype=torch.float32, device=like.device)
    return v if v.dim() == 0 else v.reshape(v.shape + (1, 1))


def _check_generator(generator: Optional[torch.Generator],
                     dev: torch.device) -> None:
    if generator is None or generator.device.type != dev.type:
        raise ValueError("pass a torch.Generator on the state's device, or "
                         "noise_fn")


class PosteriorRunner:
    """The c2 posterior schedule as one level step on static buffers.

    `run` copies its inputs into the runner's buffers, resets the level
    counter and calls the level once a level of `sigmas` through one
    `_graph.Replayer`:
    - on the CPU (or any device but CUDA), and under `_graph.eager()`,
      the level runs eagerly;
    - on the card, at its first run, level 0 eagerly on a side stream (so
      the first launch of every conv and norm shape of the level, with
      its build, `cudaFuncSetAttribute` and occupancy query, happens
      outside a capture), then one level captured in a CUDA graph,
      replayed for levels 1..L-1; every later run replays it for all L
      levels.
    Nothing inside the level makes a tensor from host data, reads a
    Python int of the level or synchronises with the host, so the replays
    give the bits of the eager level. A capture that fails raises:
    nothing falls back to the eager level.

    The generator draws the Langevin noise on the state's device; on the
    card it is registered with the graph, so each replay draws on from
    where the last one stopped, as the eager levels do. Re-seeding it
    between runs (`langevin_chunked` does, per chunk) starts the next
    run's draws from that seed. `noise_fn(level, step)`, when given,
    makes the draws in its place (a test injects another sampler's
    draws); a draw made in Python cannot be replayed, so such a runner
    runs every level eagerly, reading the level from the host's loop.

    The capture reads the score network's parameters in place: a network
    whose parameters are copied into keeps its graph; one whose parameter
    tensors are replaced needs a new runner. Each
    `annealed_langevin_posterior_c2` and `langevin_chunked` call builds
    its own runner, so it captures anew.

    Every run takes the same inputs (shapes and which options are given)
    as the first. `run` returns the runner's own buffers (the final or
    captured iterate, the trace): the next run overwrites them.

    Launch counts: `kernels.counts()` holds what ran on the card (the
    replayer adds a level's captured launches once a replay). STATS counts
    the forwards and levels run.
    """

    def __init__(self, score_fn: Callable[[torch.Tensor, torch.Tensor],
                                          torch.Tensor],
                 sigmas: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 steps_each: int = 3,
                 noise_rows: Optional[Tuple[int, torch.Tensor]] = None,
                 noise_fn: Optional[Callable[[int, int],
                                             torch.Tensor]] = None):
        self.score_fn = score_fn
        self.sigmas = sigmas
        self.generator = generator
        self.steps_each = steps_each
        self.noise_rows = noise_rows
        self.noise_fn = noise_fn
        self.buf = None          # name -> static input buffer
        self.replayer = None     # the level's `_graph.Replayer`
        self.at = 0              # the level the host's loop is at

    @torch.no_grad()
    def run(self, A: torch.Tensor, Y: torch.Tensor, noise_power,
            x_init: torch.Tensor, alpha_step=3e-11, beta_noise=0.01,
            oracle: Optional[torch.Tensor] = None,
            capture_level: Optional[torch.Tensor] = None,
            start_level: Optional[torch.Tensor] = None, coef_cap=None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Run the schedule on these inputs (as in
        `annealed_langevin_posterior_c2`) -> (x_final or the captured
        iterate, trace or None), the runner's buffers."""
        dev = x_init.device
        if self.noise_fn is None:
            _check_generator(self.generator, dev)
        with span("sampler.run"):
            with span("sampler.load"):
                self._load(dev, A=A, Y=Y, noise_power=noise_power,
                           x_init=x_init, alpha_step=alpha_step,
                           beta_noise=beta_noise, oracle=oracle,
                           capture_level=capture_level,
                           start_level=start_level, coef_cap=coef_cap)
            with (_graph.eager() if self.noise_fn is not None
                  else contextlib.nullcontext()):
                for lvl in range(self.sigmas.shape[0]):
                    self.at = lvl
                    with span("sampler.level"):
                        self.replayer()
                    STATS["levels"] += 1
                    STATS["forwards"] += self.steps_each
        out = self.x_cap if self.x_cap is not None else self.x
        return out, self.trace

    def _load(self, dev: torch.device, **given) -> None:
        """Copy the inputs into the static buffers (made at the first run,
        with the strides of the first inputs) and reset the state."""
        A = given["A"].to(dev)
        x0 = given["x_init"].to(dev, torch.float32)
        t = dict(A=A, Ah=cplx.conj_transpose(A), Y=given["Y"].to(dev), x0=x0,
                 noise_power=_per_sample(given["noise_power"], x0),
                 alpha=_per_sample(given["alpha_step"], x0),
                 beta=_per_sample(given["beta_noise"], x0))
        if given["coef_cap"] is not None:
            t["cap"] = _per_sample(given["coef_cap"], x0)
        for k in ("start_level", "capture_level"):
            if given[k] is not None:
                t[k] = torch.as_tensor(given[k], device=dev)
        if given["oracle"] is not None:
            t["oracle"] = given["oracle"].to(dev)
            t["energy"] = cplx.sum_abs2(t["oracle"], dim=(-1, -2))
        if self.buf is None:
            self.sigmas = self.sigmas.to(dev, torch.float32)
            self.sigma_end = self.sigmas[-1]
            if self.noise_rows is not None:
                self.noise_rows = (self.noise_rows[0],
                                   self.noise_rows[1].to(dev))
            self.buf = {k: torch.empty_like(v) for k, v in t.items()}
            self.x = torch.empty_like(x0)
            self.x_cap = (torch.empty_like(x0) if "capture_level" in t
                          else None)
            self.trace = (torch.empty((self.sigmas.shape[0]
                                       * self.steps_each, x0.shape[0]),
                                      dtype=torch.float32, device=dev)
                          if "oracle" in t else None)
            self.lvl = torch.zeros((), dtype=torch.int64, device=dev)
            self.replayer = _graph.Replayer(self._level, dev, self.generator)
        elif set(t) != set(self.buf):
            raise ValueError("a runner's runs take the same inputs: got "
                             f"{sorted(t)}, first {sorted(self.buf)}")
        for k, v in t.items():
            self.buf[k].copy_(v)
        self.x.copy_(x0)
        if self.x_cap is not None:
            self.x_cap.copy_(x0)
        self.lvl.zero_()

    def _draw(self, x: torch.Tensor, step: int) -> torch.Tensor:
        if self.noise_fn is not None:
            return self.noise_fn(self.at, step).to(x.device)
        if self.noise_rows is None:
            return cplx.randn(self.generator, x.shape[:-1])
        n, keep = self.noise_rows
        return cplx.randn(self.generator, (n,) + tuple(x.shape[1:-1])
                          ).index_select(0, keep)

    def _level(self) -> None:
        """One level on the buffers: steps_each forwards and updates, the
        trace rows lvl * steps_each + step, the capture latch, lvl += 1."""
        b, lvl, S = self.buf, self.lvl, self.steps_each
        sigma = self.sigmas.index_select(0, lvl.view(1)).view(())
        alpha = b["alpha"] * (sigma / self.sigma_end) ** 2
        if "start_level" in b:
            alpha = alpha * _per_sample((b["start_level"] <= lvl).float(),
                                        self.x)
        coef = alpha / (b["noise_power"] / 2.0 + sigma ** 2)
        if "cap" in b:
            coef = torch.minimum(coef, b["cap"])
        noise_scale = torch.sqrt(2.0 * alpha * b["beta"])
        x = self.x
        for step in range(S):
            score = self.score_fn(x, sigma)
            meas_grad = cplx.matmul(b["Ah"], cplx.matmul(b["A"], x) - b["Y"])
            z = self._draw(x, step)
            x = (x + cplx.scale(score, alpha) - cplx.scale(meas_grad, coef)
                 + cplx.scale(z, noise_scale))
            if self.trace is not None:
                err = cplx.sum_abs2(x - b["oracle"], dim=(-1, -2))
                self.trace.index_copy_(0, (lvl * S + step).view(1),
                                       (err / b["energy"]).unsqueeze(0))
        if self.x_cap is not None:
            latch = (b["capture_level"] == lvl).reshape(-1, 1, 1, 1)
            self.x_cap.copy_(torch.where(latch, x, self.x_cap))
        self.x.copy_(x)
        lvl.add_(1)


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
        generator's draws (lets a test inject another sampler's draws);
        with it every level runs eagerly, since a draw made in Python
        cannot be replayed by a graph.
      noise_rows: (n, keep): each step draws z for n rows and keeps rows
        `keep` (a data-parallel rank's rows of its chunk), so a row's
        noise does not depend on how the chunk is split.

    The schedule runs in a `PosteriorRunner` (on the card, one captured
    level replayed L times).

    Returns (x_final or the captured iterate, nmse trace or None).
    """
    runner = PosteriorRunner(score_fn, sigmas, generator,
                             steps_each=steps_each, noise_rows=noise_rows,
                             noise_fn=noise_fn)
    return runner.run(A, Y, noise_power, x_init, alpha_step, beta_noise,
                      oracle=oracle, capture_level=capture_level,
                      start_level=start_level, coef_cap=coef_cap)


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


def step_table(sigmas: torch.Tensor, step_lr: float,
               n_steps_each: int) -> torch.Tensor:
    """(L x n_steps_each, 3) float32 rows (sigma, step, amp) of the other
    samplers' inner steps, row lvl * n_steps_each + i for level lvl:
    step = step_lr (sigma / sigma_end)^2 and amp = sqrt(2 step), by the
    eager loop's operations on the whole schedule, so each row holds the
    bits of the values that loop computes at its level."""
    step = step_lr * (sigmas / sigmas[-1]) ** 2
    rows = torch.stack([sigmas, step, torch.sqrt(2.0 * step)], dim=1)
    return rows.repeat_interleave(n_steps_each, dim=0)


def _langevin(x: torch.Tensor, sigmas: torch.Tensor, n_steps_each: int,
              step_lr: float, generator: Optional[torch.Generator],
              noise_fn, shapes: Sequence[tuple], update) -> torch.Tensor:
    """The inner steps of a sampler: x <- update(x, sigma, step, amp,
    draws) at every level and inner step, draws of `shapes` (standard
    normal, in order) from `generator`, or noise_fn(level, step).

    With noise_fn, the eager loop over levels and steps (draws made in
    Python cannot be replayed by a graph). Otherwise one step on static
    buffers (the state x, a 0-d step counter): sigma, step and amp from
    `step_table` at the counter, the draws from the generator, the
    counter advanced; run by `_graph.run_steps` (on the CPU once a step;
    on the card step 0 eagerly on a side stream, then one capture with
    the generator registered, replayed for every other step, so the
    replays draw what the eager loop draws). Returns x."""
    dev = x.device
    sigmas = sigmas.to(dev, torch.float32)
    if noise_fn is not None:
        sigma_end = sigmas[-1]
        for lvl in range(sigmas.shape[0]):
            sigma = sigmas[lvl]
            step = step_lr * (sigma / sigma_end) ** 2
            amp = torch.sqrt(2.0 * step)
            for i in range(n_steps_each):
                draws = tuple(d.to(dev) for d in noise_fn(lvl, i))
                x = update(x, sigma, step, amp, draws)
        return x
    _check_generator(generator, dev)
    table = step_table(sigmas, step_lr, n_steps_each)
    t = torch.zeros((), dtype=torch.int64, device=dev)
    x = x.clone()

    def one_step():
        sigma, step, amp = table.index_select(0, t.view(1)).view(3).unbind()
        draws = tuple(torch.randn(s, generator=generator, device=dev)
                      for s in shapes)
        x.copy_(update(x, sigma, step, amp, draws))
        t.add_(1)

    _graph.run_steps([one_step], table.shape[0], dev, generator)
    return x


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
    NHWC; noise_fn(level, step) returns (z,). The inner steps run as in
    `_langevin` (on the card one captured step, replayed); the final
    denoising forward runs once, eagerly."""
    x = x_init.to(torch.float32)
    x = _langevin(x, sigmas, n_steps_each, step_lr, generator, noise_fn,
                  [x.shape], lambda x, sigma, step, amp, d: (
                      x + step * score_fn(x, sigma) + amp * d[0]))
    if denoise:
        sigma_end = sigmas.to(x.device, torch.float32)[-1]
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
    noise_fn(level, step) returns (n1, z). The steps run as in
    `_langevin`."""
    dev = x_init.device
    refer_x = refer_x.to(dev, torch.float32)
    mask = torch.as_tensor(known_mask, dtype=torch.float32, device=dev)

    def update(x, sigma, step, amp, draws):
        n1, z = draws
        corrupted = refer_x + sigma * n1
        x = mask * corrupted + (1.0 - mask) * x
        return x + step * score_fn(x, sigma) + amp * z

    return _langevin(x_init.to(torch.float32), sigmas, n_steps_each,
                     step_lr, generator, noise_fn,
                     [refer_x.shape, x_init.shape], update)


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
    noise_fn(level, step) returns (zp, zq). The steps run as in
    `_langevin`."""
    dev = x_init.device
    B, ni = x_init.shape[0], n_interpolations
    x = x_init.to(torch.float32).repeat_interleave(ni, dim=0)
    angles = torch.linspace(0.0, torch.pi / 2.0, ni, device=dev)
    w_shape = (1, ni) + (1,) * (x.dim() - 1)
    cosw, sinw = angles.cos().reshape(w_shape), angles.sin().reshape(w_shape)
    shape = (B,) + tuple(x.shape[1:])

    def update(x, sigma, step, amp, draws):
        zp, zq = draws
        z = (zp[:, None] * cosw + zq[:, None] * sinw).reshape(x.shape)
        return x + step * score_fn(x, sigma) + amp * z

    return _langevin(x, sigmas, n_steps_each, step_lr, generator, noise_fn,
                     [shape, shape], update)
