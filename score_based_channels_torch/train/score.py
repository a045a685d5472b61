"""DSM trainer of the score network, the counterpart of the JAX package's
train/score.py (make_optimizer:49, make_score_train_step:71,
make_eval_loss:128, ScoreTrainer:140, main:302); the reference recipe of
train_score.py:34-67, 98-101, 145-216: batch 32, 400 epochs, Adam lr 1e-4
eps 1e-3, EMA 0.999, anneal_power 2, geometric sigmas.

On the card every training step's forward runs the port's `conv2d_taps`
and `instance_norm_plus` kernels, and the convs' input gradients run
`conv2d_taps` too (kernels/conv.py, kernels/instance_norm.py). The whole
training tensor is staged on the device once; each step gathers its batch
there. The JAX package runs a `log_every_steps` chunk as one `lax.scan`
of its jitted step (train_chunk:107); here `TrainChunkRunner` runs the
chunk on static buffers, and on the card one step (forward, backward,
optimizer, EMA) is captured once a `train` call in a CUDA graph and
replayed for every later step, so the host no longer issues the step's
~1,700 launches one by one. Losses stay on the device and come to the
host once a chunk, as the scanned chunk returns them.

Random streams: the JAX package splits one key; here each stream is a
`torch.Generator` seeded from (seed, purpose, index) with numpy's
SeedSequence. Parameters are drawn on the CPU, each epoch's shuffle on the
CPU (so both are the same on every device), and each step's labels and
noise on the run's device from (seed, step), so a run does not depend on
its chunk length or on restarts.

Data parallelism (the JAX package's train/score.py:143-182): with
`config.training.data_parallel` and an initialised process group
(parallel/multihost.py), every rank draws the whole batch, its labels and
its noise from the shared seeds, keeps its own rows, and the gradients
are all-reduced to their mean before the update, so a step on k ranks is
the one-process step on the whole batch. Only rank 0 writes checkpoints
and logs.

The optimizers follow optax's update rules (the JAX package's), with
their state kept in optax's leaf order so that a checkpoint resumes in
either package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from .. import _graph, kernels
from .._device import resolve_device
from ..config import Config
from ..data.dataset import ChannelDataset
from ..diffusion.dsm import anneal_dsm_loss
from ..diffusion.ema import ema_init, ema_update
from ..diffusion.sigmas import sigmas_from_config
from ..eval.estimate import derive_seed
from ..models import (
    jax_params_to_state_dict, make_score_model, state_dict_to_jax_params,
)
from ..models.convert import tree_from_leaves, tree_leaves, tree_paths
from ..parallel.mesh import Mesh, make_mesh
from ..parallel.multihost import is_primary
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.metrics import MetricsLogger

# each rule's moment lists, in optax's state order; the Adam family's
# state starts with its step count
_MOMENTS = {"adam": ("mu", "nu"), "amsgrad": ("mu", "nu", "nu_max"),
            "rmsprop": ("nu",), "sgd": ("trace",)}
_ADAM = ("adam", "amsgrad")  # the rules with a count and bias corrections


class Optimizer:
    """optax's update rules over named parameters, in place:

      adam     optax.adam(lr, b1, b2, eps) (eps outside the sqrt), after
               optax.add_decayed_weights(weight_decay) when it is set;
      amsgrad  optax.amsgrad: the max of the BIAS-CORRECTED nu;
      rmsprop  optax.rmsprop(lr, decay=0.99, eps=1e-8): nu starts at 0 and
               eps is INSIDE the sqrt;
      sgd      optax.sgd(lr, momentum=0.9): trace = g + 0.9 trace.

    The rule of reference ncsnv2/losses/__init__.py:3-13 as the JAX
    package's make_optimizer:49 builds it. State: `count` and one list of
    tensors per moment, aligned with `names`.

    `schedule`, when given, maps the update's 0-based index to its
    learning rate in place of `optim_cfg.lr` (optax's
    `scale_by_schedule`, e.g. `staircase_decay`).

    What depends on the count comes from `table`, a float32 device tensor
    made on the host, at the row of `count_t`, a 0-d int64 device counter
    that each update advances. Row r holds, for the update of 0-based
    index r: the Adam family's bias corrections (1 - b1^c, 1 - b2^c) at
    c = r + 1, in optax's float32 arithmetic; with a schedule, last,
    -schedule(r) in float32, the factor optax's `scale_by_learning_rate`
    multiplies by. An update then takes no host value that changes from
    step to step, so a CUDA graph of it (the training runners') serves
    every step. A rule with neither has no table. `count` stays the
    host's int and the checkpoint's.

    The scheduled step is `addcmul` with the rate's 0-d tensor, which
    gives the bits of `add(alpha=-lr)` with the host float on the CPU
    (one fused multiply-add each); without a schedule the step keeps
    `alpha=-lr`.
    """

    def __init__(self, named_params, optim_cfg,
                 schedule: Optional[Callable[[int], float]] = None):
        name = optim_cfg.optimizer.lower()
        if name == "adam":
            self.rule = "amsgrad" if optim_cfg.amsgrad else "adam"
        elif name in ("rmsprop", "sgd"):
            self.rule = name
        else:
            raise NotImplementedError(
                f"Optimizer {optim_cfg.optimizer} not understood.")
        self.cfg = optim_cfg
        self.schedule = schedule
        self.names, self.params = map(list, zip(*named_params))
        self.count = 0
        self.moments: Dict[str, List[torch.Tensor]] = {
            m: [torch.zeros_like(p) for p in self.params]
            for m in _MOMENTS[self.rule]}
        self.table: Optional[torch.Tensor] = None
        self.count_t = torch.zeros((), dtype=torch.int64,
                                   device=self.params[0].device)

    def reserve(self, n: int) -> None:
        """Make `table` hold the rows of the next n updates (a new tensor
        when it grows, or when a schedule was set after it was made: a
        CUDA graph that read the old one no longer serves)."""
        b = ((np.float32(self.cfg.beta1), np.float32(self.cfg.beta2))
             if self.rule in _ADAM else ())
        cols = len(b) + (self.schedule is not None)
        rows = 0 if self.table is None else self.table.shape[0]
        if cols == 0 or (self.count + n <= rows
                         and self.table.shape[1] == cols):
            return
        tab = np.zeros((max(self.count + n, 2 * rows), cols), np.float32)
        for r in range(tab.shape[0]):
            # optax's bias corrections: 1 - decay**count in float32
            tab[r, :len(b)] = [1 - d ** np.float32(r + 1) for d in b]
            if self.schedule is not None:
                tab[r, -1] = -np.float32(self.schedule(r))
        self.table = torch.from_numpy(tab).to(self.count_t.device)

    def reserve_in(self, n: int, table: Optional[torch.Tensor]) -> None:
        """`reserve(n)`, raising if that made the table anew: a runner's
        captured graph reads the table it was built with."""
        self.reserve(n)
        if self.table is not table:
            raise RuntimeError("the optimizer's table grew past the updates "
                               "this runner was built for, or a schedule "
                               "was set after it")

    @torch.no_grad()
    def step(self) -> None:
        """One update from each parameter's .grad."""
        self.update()
        self.count += 1

    @torch.no_grad()
    def update(self) -> None:
        """The update's device work alone (what `step` and a captured
        training step run): `count` is the caller's to advance. The table
        grows here only when it lacks the row of `count`, which a runner
        reserves before its capture."""
        self.reserve(1)
        c, p = self.cfg, self.params
        g = [q.grad for q in p]
        row = None
        if self.table is not None:
            row = self.table.index_select(0, self.count_t.view(1))[0]
            self.count_t.add_(1)
        if self.rule in _ADAM:
            if c.weight_decay:
                g = torch._foreach_add(g, torch._foreach_mul(p, c.weight_decay))
            mu, nu = self.moments["mu"], self.moments["nu"]
            torch._foreach_mul_(mu, c.beta1)
            torch._foreach_add_(mu, g, alpha=1.0 - c.beta1)
            torch._foreach_mul_(nu, c.beta2)
            torch._foreach_add_(nu, torch._foreach_mul(g, g),
                                alpha=1.0 - c.beta2)
            bc1, bc2 = row[0], row[1]
            m_hat = torch._foreach_div(mu, bc1)
            v_hat = torch._foreach_div(nu, bc2)
            if self.rule == "amsgrad":
                nu_max = self.moments["nu_max"]
                torch._foreach_maximum_(nu_max, v_hat)
                v_hat = [v.clone() for v in nu_max]
            torch._foreach_sqrt_(v_hat)
            torch._foreach_add_(v_hat, c.eps)
            torch._foreach_div_(m_hat, v_hat)
            self._descend(m_hat, row)
        elif self.rule == "rmsprop":
            nu = self.moments["nu"]
            torch._foreach_mul_(nu, 0.99)
            torch._foreach_add_(nu, torch._foreach_mul(g, g), alpha=1 - 0.99)
            scale = torch._foreach_add(nu, 1e-8)
            torch._foreach_rsqrt_(scale)
            self._descend(torch._foreach_mul(g, scale), row)
        else:  # sgd with momentum 0.9
            tr = self.moments["trace"]
            torch._foreach_mul_(tr, 0.9)
            torch._foreach_add_(tr, g)
            self._descend(tr, row)

    def _descend(self, direction: List[torch.Tensor],
                 row: Optional[torch.Tensor]) -> None:
        """params -= lr * direction: lr the config's constant, or with a
        schedule the rate of `row` (the table's, a device value)."""
        if self.schedule is None:
            torch._foreach_add_(self.params, direction, alpha=-self.cfg.lr)
        else:
            torch._foreach_addcmul_(self.params, direction,
                                    [row[-1]] * len(direction))

    def zero_grad(self) -> None:
        for q in self.params:
            q.grad = None

    def state_leaves(self) -> List[np.ndarray]:
        """The state as optax flattens it: [count] for the Adam family,
        then each moment's leaves in the JAX package's parameter order and
        layout."""
        leaves = ([np.asarray(self.count, np.int32)]
                  if self.rule in _ADAM else [])
        for m in _MOMENTS[self.rule]:
            leaves += tree_leaves(state_dict_to_jax_params(
                dict(zip(self.names, self.moments[m]))))
        if self.schedule is not None:  # scale_by_schedule's own count
            leaves.append(np.asarray(self.count, np.int32))
        return leaves

    @torch.no_grad()
    def load_state_leaves(self, leaves) -> None:
        """The inverse of `state_leaves`, from either package's checkpoint."""
        leaves = list(leaves)
        if self.schedule is not None:  # scale_by_schedule's own count
            self.count = int(leaves.pop())
        if self.rule in _ADAM:
            self.count = int(leaves.pop(0))
        self.count_t.fill_(self.count)
        paths = tree_paths(state_dict_to_jax_params(dict(zip(self.names,
                                                             self.params))))
        if len(leaves) != len(paths) * len(_MOMENTS[self.rule]):
            raise ValueError(f"{len(leaves)} optimizer leaves do not fit "
                             f"{self.rule} over {len(paths)} parameters")
        for i, m in enumerate(_MOMENTS[self.rule]):
            chunk = leaves[i * len(paths):(i + 1) * len(paths)]
            sd = jax_params_to_state_dict(tree_from_leaves(paths, chunk))
            for name, t in zip(self.names, self.moments[m]):
                t.copy_(sd[name])


def staircase_decay(lr: float, transition_steps: int,
                    decay_rate: float) -> Callable[[int], float]:
    """optax.exponential_decay(lr, transition_steps, decay_rate,
    staircase=True): lr * decay_rate ** (count // transition_steps) in
    float32 (constant lr when transition_steps <= 0, as optax)."""
    if transition_steps <= 0:
        return lambda count: lr
    return lambda count: float(np.float32(lr) * np.float32(decay_rate) ** (
        np.float32(count // transition_steps)))


def make_optimizer(model: nn.Module, optim_cfg) -> Optimizer:
    """The optimizer of the config over the model's parameters."""
    return Optimizer(model.named_parameters(), optim_cfg)


@dataclasses.dataclass
class ScoreTrainState:
    model: nn.Module
    ema: nn.Module
    opt: Optimizer
    step: int


def make_score_update(sigmas: torch.Tensor, ema_rate: float,
                      anneal_power: float,
                      mesh: Optional[Mesh] = None) -> Callable:
    """-> update(state, x, generator, labels=None, noise=None): the DSM loss
    at the current parameters, backward, the optimizer's `update`, the EMA
    update; returns the loss as a 0-dim device tensor. It reads no host
    value that changes between steps and leaves the host's counts
    (`state.step`, `state.opt.count`) to its caller, so one capture of it
    serves every step (`TrainChunkRunner`).

    With a mesh, x, labels and noise are the whole batch; this rank's
    loss is the mean over its rows (`mesh.rows`), and the gradients and
    the returned loss are all-reduced to their mean over the ranks."""

    def update(state: ScoreTrainState, x: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               labels: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        rows = mesh.rows(x.shape[0]) if mesh is not None else None
        loss = anneal_dsm_loss(state.model, x, sigmas, generator, labels,
                               noise, anneal_power, rows=rows)
        state.opt.zero_grad()
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            mesh.mean([p.grad for p in state.opt.params] + [loss])
        state.opt.update()
        ema_update(state.ema, state.model, ema_rate)
        return loss

    return update


def make_score_train_step(sigmas: torch.Tensor, ema_rate: float,
                          anneal_power: float,
                          mesh: Optional[Mesh] = None) -> Callable:
    """-> step(state, x, generator, labels=None, noise=None): one eager
    training step (the JAX package's `train_step`), `make_score_update`'s
    work and the host's counts; returns the loss as a 0-dim device tensor
    (no host sync)."""
    update = make_score_update(sigmas, ema_rate, anneal_power, mesh)

    def step(state: ScoreTrainState, x: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             labels: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        loss = update(state, x, generator, labels, noise)
        state.opt.count += 1
        state.step += 1
        return loss

    return step


# Counts of the training runner since `reset_stats`: steps run on the
# device (eager or replayed), graph captures and replays, seconds spent
# capturing and the largest graph memory pool (bytes the capture reserved
# for one step's activations, gradients and temporaries).
STATS = dict(steps=0, captures=0, replays=0, capture_seconds=0.0,
             pool_bytes=0)


def reset_stats() -> None:
    """Set the runner's counts in STATS to 0."""
    for k in STATS:
        STATS[k] = type(STATS[k])(0)


class TrainChunkRunner:
    """The JAX package's `train_chunk` (train/score.py:107): chunks of DSM
    training steps on static buffers, one `update` (`make_score_update`)
    a step.

    `run(idx, seeds)` copies the chunk's batch indices into the runner's
    (chunk_len, batch) buffer, resets the step-in-chunk counter and runs
    one step per row: the batch gathered from the staged `x_all` at the
    counter's row, the generator seeded from that step's seed first (the
    labels and noise of the step), the loss written into its row of the
    loss buffer, the counter advanced. It returns the loss buffer's first
    n rows (the next run overwrites them) and advances the host's counts
    (`state.step`, `state.opt.count`) once a step.
    - On the CPU, and on the card when `capture` is False (the eager loop
      the graph is held against), it calls the step once a step.
    - On the card, at the first run, step 0 runs eagerly on a side stream
      (so the first launch of every conv, dgrad and norm shape and of
      every cuDNN weight gradient, with its build, `cudaFuncSetAttribute`,
      occupancy query and algorithm choice, happens outside a capture);
      then one step is captured in a `torch.cuda.CUDAGraph`, with the
      generator registered, and replayed for every later step of every
      run. Re-seeding the generator before a replay starts that replay's
      draws from the seed, as the eager step's.
    Nothing inside the step makes a tensor from host data, reads a Python
    value that changes between steps or synchronises with the host: the
    optimizer's bias corrections and a schedule's learning rate come from
    its device table at its device counter (`Optimizer.update`), which
    the runner sets from the count when it is built. A capture
    that fails raises; nothing falls back to the eager loop. The graph
    reads the parameters, EMA, moments, x_all and the optimizer's table
    in place: a state whose tensors are replaced, or an optimizer whose
    table was made anew (it grew, or a schedule was set after it), needs
    a new runner (a run checks the table).

    Every run takes the same inputs as the first: with or without
    `labels` and `noise` (the (n, batch) labels and (n, *x.shape[1:])
    unit noise to use in place of the generator's draws), at most
    chunk_len steps of `batch` rows.

    Counts: the capture records one step's kernel launches and gradient
    work (the wrappers count them as they are recorded); the runner takes
    them back, since a capture launches nothing, and adds them once a
    replay (`recorded`), so `kernels.counts()` and `kernels.grad_counts()`
    hold what ran on the card. STATS counts the steps run.
    """

    def __init__(self, update: Callable, state: ScoreTrainState,
                 x_all: torch.Tensor, batch: int, chunk_len: int,
                 generator: torch.Generator, updates: int,
                 capture: bool = True):
        dev = x_all.device
        if generator.device.type != dev.type:
            raise ValueError("the generator lies on another device than "
                             "x_all")
        self.update, self.state, self.x_all = update, state, x_all
        self.generator = generator
        self.capture = capture and dev.type == "cuda"
        self.idx = torch.zeros((chunk_len, batch), dtype=torch.int64,
                               device=dev)
        self.losses = torch.zeros(chunk_len, dtype=torch.float32, device=dev)
        self.k = torch.zeros((), dtype=torch.int64, device=dev)
        self.draws = None        # (labels, noise) buffers, when given
        self.runs = 0
        self.warmed = False
        self.graph = None
        self.recorded = None     # kernel name -> launches a replay makes
        self.recorded_grad = None  # kernel name -> gradient work a replay
        state.opt.reserve(updates)
        state.opt.count_t.fill_(state.opt.count)
        self.table = state.opt.table

    def run(self, idx: torch.Tensor, seeds,
            labels: Optional[torch.Tensor] = None,
            noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Run len(seeds) steps on the batches idx (n, batch) -> the (n,)
        losses, the runner's buffer."""
        n = len(seeds)
        if tuple(idx.shape) != (n, self.idx.shape[1]) or n > len(self.idx):
            raise ValueError(f"a run takes at most {len(self.idx)} steps of "
                             f"{self.idx.shape[1]} rows: got idx "
                             f"{tuple(idx.shape)} for {n} seeds")
        opt = self.state.opt
        opt.reserve_in(n, self.table)
        self.idx[:n].copy_(idx)
        self._load_draws(labels, noise, n)
        self.k.zero_()
        for seed in seeds:
            self.generator.manual_seed(seed)
            if not self.capture:
                self._step()
            elif not self.warmed:
                self._warm_up()
            else:
                if self.graph is None:
                    self._capture()
                self.graph.replay()
                kernels.add_launches(self.recorded)
                kernels.add_grad_counts(self.recorded_grad)
                STATS["replays"] += 1
            STATS["steps"] += 1
            opt.count += 1
            self.state.step += 1
        self.runs += 1
        return self.losses[:n]

    def _load_draws(self, labels, noise, n) -> None:
        given = labels is not None, noise is not None
        if given[0] != given[1]:
            raise ValueError("pass labels and noise together")
        if self.runs == 0 and given[0]:
            L, B = self.idx.shape
            self.draws = (
                torch.zeros((L, B), dtype=torch.int64, device=self.k.device),
                torch.zeros((L, B) + tuple(self.x_all.shape[1:]),
                            dtype=self.x_all.dtype, device=self.k.device))
        if given[0] != (self.draws is not None):
            raise ValueError("a runner's runs take the same inputs: labels "
                             "and noise in every run or in none")
        if self.draws is not None:
            for buf, v in zip(self.draws, (labels, noise)):
                if tuple(v.shape) != (n,) + tuple(buf.shape[1:]):
                    raise ValueError(f"draws of shape {tuple(v.shape)} for "
                                     f"{n} steps of {tuple(buf.shape[1:])}")
                buf[:n].copy_(v)

    def _step(self) -> None:
        """One step on the buffers: the batch and draws at row k, the
        update, the loss into row k, k += 1."""
        row = self.k.view(1)
        x = self.x_all.index_select(0, self.idx.index_select(0, row).view(-1))
        labels = noise = None
        if self.draws is not None:
            labels, noise = (d.index_select(0, row).squeeze(0)
                             for d in self.draws)
        loss = self.update(self.state, x, self.generator, labels, noise)
        self.losses.index_copy_(0, row, loss.view(1))
        self.k.add_(1)

    def _warm_up(self) -> None:
        """Step 0 eagerly on a side stream, then the gradients dropped, so
        that the captured backward makes its own in the graph's pool."""
        _graph.on_side_stream(self._step, self.k.device)
        self.state.opt.zero_grad()
        self.warmed = True

    def _capture(self) -> None:
        """Capture one step (`_graph.capture`)."""
        cap = _graph.capture(self._step, self.generator, self.k.device)
        self.graph = cap.graph
        self.recorded, self.recorded_grad = cap.launches, cap.grad
        STATS["captures"] += 1
        STATS["capture_seconds"] += cap.seconds
        STATS["pool_bytes"] = max(STATS["pool_bytes"], cap.pool_bytes)


def make_eval_loss(sigmas: torch.Tensor, anneal_power: float,
                   mesh: Optional[Mesh] = None) -> Callable:
    """-> eval_loss(model, x, generator): the DSM loss under no_grad (the
    trainer passes the EMA copy). With a mesh, a batch that divides by the
    ranks is split and its loss all-reduced to the mean; one that does not
    (the fixed validation set) is evaluated whole on every rank, as the
    JAX package replicates it."""

    @torch.no_grad()
    def eval_loss(model: nn.Module, x: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        split = mesh is not None and x.shape[0] % mesh.world_size == 0
        loss = anneal_dsm_loss(model, x, sigmas, generator,
                               anneal_power=anneal_power,
                               rows=mesh.rows(x.shape[0]) if split else None)
        if split:
            mesh.mean([loss])
        return loss

    return eval_loss


@contextlib.contextmanager
def matmul_precision(precision: str):
    """"highest" turns TF32 off for cuDNN and matmul while the block runs
    (cuDNN's f32 convolutions take TF32 by default, which would cost the
    weight gradient its f32 parity); other values leave both as they are."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    if precision == "highest":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


class ScoreTrainer:
    """A full training run (the reference train_score.py recipe) on
    `device` (None: the card). Data-parallel over the ranks of the process
    group (`self.mesh`) when `config.training.data_parallel` is set and one
    is initialised."""

    def __init__(self, config: Config,
                 device: Optional[Union[str, torch.device]] = None):
        self.config = config
        self.device = resolve_device(device)
        self.sigmas = sigmas_from_config(config.model).to(self.device)
        grouped = (torch.distributed.is_available()
                   and torch.distributed.is_initialized())
        self.mesh = (make_mesh() if grouped and config.training.data_parallel
                     else None)
        self.update = make_score_update(
            self.sigmas, config.model.ema_rate, config.training.anneal_power,
            self.mesh)
        self.train_step = make_score_train_step(
            self.sigmas, config.model.ema_rate, config.training.anneal_power,
            self.mesh)
        # `train` captures its step on the card; False runs the same steps
        # eagerly, the loop the graph is held against (tests, chip_smoke)
        self._capture = True
        self.eval_loss = make_eval_loss(self.sigmas,
                                        config.training.anneal_power,
                                        self.mesh)

    def init_state(self, seed: int) -> ScoreTrainState:
        """Random parameters drawn on the CPU from (seed, 0), a fresh
        optimizer, the EMA equal to the parameters, step 0."""
        cfg = self.config
        model = make_score_model(
            cfg.model, cfg.data.channels, device=self.device,
            generator=torch.Generator().manual_seed(derive_seed(seed, 0)))
        return ScoreTrainState(model=model, ema=ema_init(model),
                               opt=make_optimizer(model, cfg.optim), step=0)

    def restore_state(self, checkpoint_path: str) -> ScoreTrainState:
        """Resume from a checkpoint written by either package: parameters,
        EMA (the parameters when absent), optimizer leaves and step."""
        ck = load_checkpoint(checkpoint_path)
        state = self.init_state(0)
        state.model.load_state_dict(jax_params_to_state_dict(ck["params"]),
                                    strict=True)
        state.ema.load_state_dict(jax_params_to_state_dict(
            ck["ema"] if ck["ema"] is not None else ck["params"]), strict=True)
        if ck["opt_leaves"] is not None:
            state.opt.load_state_leaves(ck["opt_leaves"])
        state.step = int(ck["metadata"].get("steps", 0))
        return state

    def save(self, path: str, state: ScoreTrainState,
             extra_arrays: Optional[dict] = None) -> None:
        """A checkpoint in the JAX package's format."""
        save_checkpoint(
            path, self.config,
            params=state_dict_to_jax_params(state.model.state_dict()),
            ema_params=state_dict_to_jax_params(state.ema.state_dict()),
            opt_state_leaves=state.opt.state_leaves(),
            extra_arrays=extra_arrays, metadata={"steps": state.step})

    def train(
        self,
        train_seed: int = 1234,
        val_seed: int = 4321,
        rng_seed: Optional[int] = None,
        checkpoint_path: Optional[str] = None,
        n_epochs: Optional[int] = None,
        resume_from: Optional[str] = None,
        log_fn: Callable[[str], None] = print,
        metrics_path: Optional[str] = None,
    ) -> Tuple[ScoreTrainState, dict]:
        cfg = self.config
        dev = self.device
        n_epochs = n_epochs if n_epochs is not None else cfg.training.n_epochs
        rng_seed = rng_seed if rng_seed is not None else cfg.training.seed

        # the train set's stats normalise the validation set (train_score.py:84)
        train_ds = ChannelDataset(train_seed, cfg, norm=cfg.data.norm_channels)
        val_ds = ChannelDataset(val_seed, cfg, norm=list(train_ds.norm_stats))
        x_all = train_ds.network_input().to(dev)  # staged once
        x_val = val_ds.network_input().to(dev)

        state = (self.restore_state(resume_from) if resume_from
                 else self.init_state(rng_seed))
        start_step = state.step
        primary = is_primary()
        metrics = MetricsLogger(metrics_path if primary else None)
        batch = cfg.training.batch_size
        n = x_all.shape[0]
        steps_per_epoch = n // batch  # drop_last (train_score.py:75)
        total_steps = n_epochs * steps_per_epoch
        chunk_len = max(1, cfg.training.log_every_steps)
        gen = torch.Generator(device=dev)
        perm, perm_epoch = None, -1

        train_loss_log, val_loss_log = [], []
        running = None
        t0 = time.time()
        done = start_step
        with matmul_precision(cfg.training.matmul_precision):
            runner = TrainChunkRunner(self.update, state, x_all, batch,
                                      chunk_len, gen,
                                      max(0, total_steps - done),
                                      capture=self._capture)
            while done < total_steps:
                steps = range(done, min(done + chunk_len, total_steps))
                idx = []
                for s in steps:
                    epoch, i = divmod(s, steps_per_epoch)
                    if epoch != perm_epoch:
                        perm = torch.randperm(n, generator=torch.Generator()
                                              .manual_seed(derive_seed(
                                                  rng_seed, 1, epoch)))
                        perm_epoch = epoch
                    idx.append(perm[i * batch:(i + 1) * batch])
                losses = runner.run(torch.stack(idx),
                                    [derive_seed(rng_seed, 2, s)
                                     for s in steps])
                done += len(losses)
                chunk = losses.cpu().tolist()  # one sync a chunk
                for loss_f in chunk:
                    running = (loss_f if running is None
                               else 0.99 * running + 0.01 * loss_f)
                train_loss_log.extend(chunk)
                epoch = (done - 1) // steps_per_epoch
                gen.manual_seed(derive_seed(rng_seed, 3, done))
                v = float(self.eval_loss(state.ema, x_val, gen))
                val_loss_log.append(v)
                sps = (done - start_step) / (time.time() - t0)
                if primary:
                    log_fn(f"Epoch {epoch}, Step {done}, "
                           f"Train Loss (EMA) {running:.3f}, "
                           f"Val. Loss {v:.3f}, {sps:.2f} steps/s")
                metrics.log("val", epoch=epoch, step=done,
                            train_loss_ema=running, val_loss=v,
                            steps_per_s=sps)

        logs = {"train_loss": np.asarray(train_loss_log),
                "val_loss": np.asarray(val_loss_log),
                "norm_stats": np.asarray([np.real(train_ds.mean),
                                          float(train_ds.std)])}
        if checkpoint_path and primary:
            self.save(checkpoint_path, state, extra_arrays=logs)
            log_fn(f"saved checkpoint to {checkpoint_path}")
        if self.mesh is not None:  # no rank returns before the file is whole
            self.mesh.barrier()
        return state, logs


def main(argv=None):
    """CLI: the reference `train_score --train CDL-C` recipe
    (train_score.py:20-23), with the JAX package's flags and --device."""
    import argparse

    p = argparse.ArgumentParser(description="Train the score model (DSM+EMA)")
    p.add_argument("--train", type=str, default="CDL-C",
                   help="CDL profile to train on")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--train_size", type=int, default=None,
                   help="training realizations (the reference uses 200)")
    p.add_argument("--output", type=str, default=None,
                   help="checkpoint path (default "
                        "models/score/<ch>/final_model.npz)")
    p.add_argument("--ray_coupling", type=str, default="random",
                   choices=["random", "fixed"],
                   help="generator ensemble (DataConfig.ray_coupling)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; --device cpu runs the "
                        "plain PyTorch path)")
    args = p.parse_args(argv)

    from ..config import default_score_config

    cfg = default_score_config(args.train)
    if args.train_size:
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, num_channels=args.train_size))
    if args.ray_coupling != "random":
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, ray_coupling=args.ray_coupling))
    out = args.output or f"models/score/{args.train}/final_model.npz"
    if "WORLD_SIZE" not in os.environ:
        ScoreTrainer(cfg, device=args.device).train(checkpoint_path=out,
                                                    n_epochs=args.epochs)
        return
    # started by torchrun: data-parallel over its ranks
    from ..parallel.multihost import initialize

    initialize(device=args.device)
    try:
        ScoreTrainer(cfg, device=args.device).train(checkpoint_path=out,
                                                    n_epochs=args.epochs)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
