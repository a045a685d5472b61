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
replayed for every level, so the host no longer launches the ~1,000
kernels of a level one by one: a Python loop over levels with no host
synchronisation (`annealed_langevin_posterior_c2_plain`, the plain
version) still left the host setting the pace, at 5.3-10 ms of host time
against ~4.3 ms of card time per bf16 forward at batch 256.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from .. import _graph, cplx, kernels

# Counts of the posterior runner since `reset_stats`: forwards and levels
# run on the device (eager or replayed), graph captures and replays,
# seconds spent capturing and the largest graph memory pool (bytes the
# capture reserved for one level's intermediates).
STATS = dict(forwards=0, levels=0, captures=0, replays=0,
             capture_seconds=0.0, pool_bytes=0)


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
    counter and runs the L levels of `sigmas`:
    - on the CPU (or any device but CUDA), by calling the level L times;
    - on the card, at its first run, level 0 eagerly on a side stream (so
      the first launch of every conv and norm shape of the level, with
      its build, `cudaFuncSetAttribute` and occupancy query, happens
      outside a capture), then one level captured in a
      `torch.cuda.CUDAGraph`, replayed for levels 1..L-1; every later run
      replays it for all L levels.
    Nothing inside the level makes a tensor from host data, reads a
    Python int of the level or synchronises with the host, so the replays
    give the bits of the eager level. A capture that fails raises:
    nothing falls back to the eager loop.

    The generator draws the Langevin noise on the state's device; on the
    card it is registered with the graph, so each replay draws on from
    where the last one stopped, as the plain loop does. Re-seeding it
    between runs (`langevin_chunked` does, per chunk) starts the next
    run's draws from that seed. The capture reads the score network's
    parameters in place: a network whose parameters are copied into
    keeps its graph; one whose parameter tensors are replaced needs a new
    runner. Each `annealed_langevin_posterior_c2` and `langevin_chunked`
    call builds its own runner, so it captures anew.

    Every run takes the same inputs (shapes and which options are given)
    as the first. `run` returns the runner's own buffers (the final or
    captured iterate, the trace): the next run overwrites them.

    Launch counts: the capture records the kernel launches of a level
    (the wrappers count them as they are recorded); the runner takes them
    back, since a capture launches nothing, and adds them once per
    replay (`recorded`), so `kernels.counts()` holds what ran on the
    card. STATS counts the forwards and levels run.
    """

    def __init__(self, score_fn: Callable[[torch.Tensor, torch.Tensor],
                                          torch.Tensor],
                 sigmas: torch.Tensor, generator: torch.Generator,
                 steps_each: int = 3,
                 noise_rows: Optional[Tuple[int, torch.Tensor]] = None):
        self.score_fn = score_fn
        self.sigmas = sigmas
        self.generator = generator
        self.steps_each = steps_each
        self.noise_rows = noise_rows
        self.buf = None          # name -> static input buffer
        self.graph = None
        self.recorded = None     # kernel name -> launches a replay makes

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
        _check_generator(self.generator, dev)
        self._load(dev, A=A, Y=Y, noise_power=noise_power, x_init=x_init,
                   alpha_step=alpha_step, beta_noise=beta_noise,
                   oracle=oracle, capture_level=capture_level,
                   start_level=start_level, coef_cap=coef_cap)
        L = self.sigmas.shape[0]
        if dev.type != "cuda":
            for _ in range(L):
                self._level()
                self._ran()
        else:
            done = 0
            if self.graph is None:
                self._warm_up()
                self._ran()
                done = 1
                if L > 1:
                    self._capture()
            for _ in range(done, L):
                self.graph.replay()
                kernels.add_launches(self.recorded)
                self._ran(replay=True)
        out = self.x_cap if self.x_cap is not None else self.x
        return out, self.trace

    def _ran(self, replay: bool = False) -> None:
        STATS["levels"] += 1
        STATS["forwards"] += self.steps_each
        STATS["replays"] += replay

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
        elif set(t) != set(self.buf):
            raise ValueError("a runner's runs take the same inputs: got "
                             f"{sorted(t)}, first {sorted(self.buf)}")
        for k, v in t.items():
            self.buf[k].copy_(v)
        self.x.copy_(x0)
        if self.x_cap is not None:
            self.x_cap.copy_(x0)
        self.lvl.zero_()

    def _draw(self, x: torch.Tensor) -> torch.Tensor:
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
            z = self._draw(x)
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

    def _warm_up(self) -> None:
        """Level 0 eagerly, on a side stream."""
        _graph.on_side_stream(self._level, self.x.device)

    def _capture(self) -> None:
        """Capture one level (`_graph.capture`)."""
        cap = _graph.capture(self._level, self.generator, self.x.device)
        self.graph, self.recorded = cap.graph, cap.launches
        STATS["captures"] += 1
        STATS["capture_seconds"] += cap.seconds
        STATS["pool_bytes"] = max(STATS["pool_bytes"], cap.pool_bytes)


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
        with it the plain loop runs (`annealed_langevin_posterior_c2_plain`),
        since a draw made in Python cannot be replayed by a graph.
      noise_rows: (n, keep): each step draws z for n rows and keeps rows
        `keep` (a data-parallel rank's rows of its chunk), so a row's
        noise does not depend on how the chunk is split.

    Without noise_fn the schedule runs in a `PosteriorRunner` (on the
    card, one captured level replayed L times).

    Returns (x_final or the captured iterate, nmse trace or None).
    """
    if noise_fn is not None:
        return annealed_langevin_posterior_c2_plain(
            score_fn, A, Y, sigmas, noise_power, x_init, generator,
            alpha_step=alpha_step, beta_noise=beta_noise,
            steps_each=steps_each, oracle=oracle,
            capture_level=capture_level, coef_cap=coef_cap,
            start_level=start_level, noise_fn=noise_fn,
            noise_rows=noise_rows)
    runner = PosteriorRunner(score_fn, sigmas, generator,
                             steps_each=steps_each, noise_rows=noise_rows)
    return runner.run(A, Y, noise_power, x_init, alpha_step, beta_noise,
                      oracle=oracle, capture_level=capture_level,
                      start_level=start_level, coef_cap=coef_cap)


@torch.no_grad()
def annealed_langevin_posterior_c2_plain(
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
    """The plain version of `annealed_langevin_posterior_c2`, with the same
    arguments: a Python loop over levels and steps that indexes sigma and
    the trace with Python ints. It runs for `noise_fn` callers; the tests
    and chip_smoke.py hold the runner against it."""
    dev = x_init.device
    if noise_fn is None:
        _check_generator(generator, dev)
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
    _check_generator(generator, dev)
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
