"""LDAMP training, one model per training SNR, the counterpart of the JAX
package's train/ldamp.py (reference train_ldamp.py).

Recipe (train_ldamp.py:38-97): FlippedUNet backbone, 10 unrolls, batch
128, Adam 1e-3 with a x0.1 staircase after `decay_epochs` epochs (optax's
exponential_decay, staircase=True, by the port's `Optimizer`), the e2e
MSE on the UNnormalised Hermitian channel (:117-120), training noise
amplitude 10^(-SNR/20) sqrt(Nt) (:66, an amplitude, as the reference).

On the card every denoiser conv runs `conv2d_taps`, forward and input
gradient, and the JAX package's jitted step is one CUDA graph
(`LDAMPStepRunner`), replayed for every step after the first. The host
makes only a batch's draws (`ldamp_batch`); the step assembles them into
LDAMP's inputs on its device (`ldamp_inputs`: the measurements, the
conjugate transposes, and eig1 by the `pilot_eigmax` kernel on the card).
Random streams: the parameters are drawn on the CPU from (seed, 0), each
step's batch on the CPU from (seed, 1, step), each step's divergence
directions on the run's device from (seed, 2, step).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import (
    Callable, Dict, Iterable, Optional, Sequence, Tuple, Union,
)

import numpy as np
import torch

from .. import _graph, cplx, kernels
from .._device import resolve_device
from ..config import Config, OptimConfig
from ..data.dataset import ChannelDataset
from ..eval.estimate import derive_seed
from ..kernels.eigmax import pilot_eigmax
from ..models.convert import state_dict_to_jax_params
from ..models.ldamp import LDAMP
from ..utils.checkpoint import save_checkpoint
from ..utils.spans import span
from .score import Optimizer, matmul_precision, staircase_decay


@dataclasses.dataclass(frozen=True)
class LDAMPTrainConfig:
    alpha: float = 0.6  # pilot fraction
    max_unrolls: int = 10
    chans: int = 16
    num_pools: int = 3
    shared_nets: bool = False
    lr: float = 1e-3
    batch_size: int = 128
    n_epochs: int = 24
    decay_epochs: int = 16
    decay_gamma: float = 0.1
    seed: int = 0


def make_ldamp_model(tc: LDAMPTrainConfig,
                     device: Optional[Union[str, torch.device]] = None,
                     generator: Optional[torch.Generator] = None) -> LDAMP:
    """The LDAMP of `tc` on `device` (None: the card), its parameters drawn
    from `generator` (a CPU generator; seed 0 when None)."""
    dev = resolve_device(device)
    model = LDAMP(max_unrolls=tc.max_unrolls, shared_nets=tc.shared_nets,
                  chans=tc.chans, num_pools=tc.num_pools)
    model.init_parameters(generator if generator is not None
                          else torch.Generator().manual_seed(0))
    return model.to(dev)


def ldamp_batch(ds: ChannelDataset, generator: torch.Generator,
                batch_size: int, device) -> Dict[str, torch.Tensor]:
    """The draws of a batch (`ChannelDataset.sample_draws` from
    `generator`, a CPU generator) on `device`, for `ldamp_inputs` to
    assemble there:

      H           (B, Nr, Nt, 2)   the raw rows, c2
      pilot_bits  (B, Nt, Np, 2)   the QPSK pilots' bits, uint8
      noise       (B, Nr, Np, 2)   the noise's unit draws (absent at
                                   noise amplitude 0)
      amp         ()               the noise amplitude, float32
    """
    d = ds.sample_draws(generator, batch_size)
    out = {"H": cplx.as_c2(d["H"]), "pilot_bits": d["pilot_bits"],
           "amp": torch.tensor(ds.noise_amp, dtype=torch.float32)}
    if d["noise"] is not None:
        out["noise"] = d["noise"]
    return {k: v.to(device) for k, v in out.items()}


def ldamp_inputs(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """LDAMP's inputs on the batch's device: Y_herm, P_herm, H_herm_cplx
    (c2) and eig1 (the JAX package's train/ldamp.py::_device_batch). A
    batch that carries eig1 is returned as it is; `ldamp_batch`'s draws
    are assembled as the reference loader assembles them
    (loaders.py:77-106), Y = H P + amp n (the product by `torch.matmul` at
    the caller's precision) and eig1 = lambda_max(P P^H) by `pilot_eigmax`
    (eigvalsh on the CPU). Nothing reads a value on the host, so a
    captured step can begin with it."""
    if "eig1" in batch:
        return batch
    H = cplx.as_complex(batch["H"])
    P2 = cplx.qpsk_from_bits(batch["pilot_bits"])
    P = torch.view_as_complex(P2)
    Y = H @ P
    if "noise" in batch:
        Y = Y + batch["amp"] * torch.view_as_complex(batch["noise"])
    herm = lambda t: t.transpose(-1, -2).conj().resolve_conj()
    return {"Y_herm": cplx.as_c2(herm(Y)), "P_herm": cplx.as_c2(herm(P)),
            "H_herm_cplx": cplx.as_c2(herm(H)),
            "eig1": pilot_eigmax(P2)[0]}


def ldamp_losses(model: LDAMP, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None,
                 directions: Optional[Sequence[torch.Tensor]] = None,
                 num_unrolls: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(e2e MSE, mean NMSE) of one batch of LDAMP's inputs
    (train_ldamp.py:117-120)."""
    h = model(batch["Y_herm"], batch["P_herm"], batch["eig1"], generator,
              num_unrolls, directions)
    mse = cplx.sum_abs2(h - batch["H_herm_cplx"], dim=(-1, -2)).mean()
    nmse = cplx.nmse(h, batch["H_herm_cplx"]).mean()
    return mse, nmse


def make_ldamp_optimizer(model: LDAMP, tc: LDAMPTrainConfig,
                         steps_per_epoch: int) -> Optimizer:
    """optax.adam(exponential_decay(lr, decay_epochs * steps_per_epoch,
    decay_gamma, staircase=True)) over the model's parameters."""
    return Optimizer(model.named_parameters(),
                     OptimConfig(optimizer="Adam", lr=tc.lr, eps=1e-8),
                     schedule=staircase_decay(
                         tc.lr, tc.decay_epochs * steps_per_epoch,
                         tc.decay_gamma))


def ldamp_update(model: LDAMP, opt: Optimizer, batch,
                 generator: Optional[torch.Generator] = None,
                 directions: Optional[Sequence[torch.Tensor]] = None):
    """A step's device work: the batch's inputs (`ldamp_inputs`: drawn
    batches are assembled here), loss, backward, the optimizer's `update`
    (the scheduled rate from its table); returns (mse, nmse) as 0-dim
    device tensors. It reads no host value that changes between steps and
    leaves `opt.count` to its caller, so one capture of it serves every
    step (`LDAMPStepRunner`)."""
    mse, nmse = ldamp_losses(model, ldamp_inputs(batch), generator,
                             directions)
    opt.zero_grad()
    mse.backward()
    opt.update()
    return mse.detach(), nmse.detach()


def ldamp_train_step(model: LDAMP, opt: Optimizer, batch,
                     generator: Optional[torch.Generator] = None,
                     directions: Optional[Sequence[torch.Tensor]] = None):
    """One eager step: `ldamp_update` and the optimizer's count; returns
    (mse, nmse) as 0-dim device tensors (no host sync)."""
    out = ldamp_update(model, opt, batch, generator, directions)
    opt.count += 1
    return out


class LDAMPStepRunner:
    """LDAMP training steps on static buffers, the JAX package's jitted
    `train_step` (train/ldamp.py:81-97), one `ldamp_update` a step.

    `run(batches, seeds, directions=None)` runs one step per seed: the
    step's batch (on any device) is copied into the runner's buffers, and
    its directions (max_unrolls tensors) into a (max_unrolls, B, Nt, Nr,
    2) buffer when given; the generator is seeded from the step's seed
    (the divergence directions it draws); the step's (mse, nmse) go into
    row k of a (rows, 2) device buffer at a 0-d device counter k, which
    each run starts at 0. It returns the buffer's first n rows (the next
    run overwrites them) and advances `opt.count` once a step.
    - On the CPU, and on the card when `capture` is False (the eager loop
      the graph is held against), it calls the step once a step.
    - On the card, at the first step, the step runs eagerly on a side
      stream (the first launch of every conv and dgrad shape, of cuDNN's
      transposed conv, its algorithm choice and the weight gradients,
      happens outside a capture) and the gradients are dropped; then one
      step (forward with its divergence probes, losses, backward, the
      optimizer) is captured in a `torch.cuda.CUDAGraph`, with the
      generator registered, and replayed for every later step of every
      run.
    The batch's form is the first step's: `ldamp_batch`'s draws, which
    the step assembles on the device first (`ldamp_inputs`, counted in
    `stats["assembled"]`), or a batch that carries eig1 (as the JAX
    package's batches come through `train_ldamp_snr`'s `_batches`), which
    the step takes as it is. `batches` and `directions` are iterated as
    the steps run, so the host makes step k+1's batch after it launched
    step k: on the card, while replay k runs. On the card a batch on the
    host goes into the buffers through pinned staging buffers by copies
    ordered on the stream after replay k, which do not hold the host
    (`_stage`); directions, a test's seam, are copied as given.

    The graph reads the parameters, the optimizer's moments and its table
    in place: an optimizer whose table was made anew (it grew past
    `updates`, or a schedule was set after) needs a new runner (each step
    checks). A capture that fails raises; nothing falls back to the eager
    loop. Every step takes batches of the first step's shapes, with
    directions or without as the first.

    Counts: the capture records one step's kernel launches and gradient
    work; the runner takes them back (a capture launches nothing) and
    adds them once a replay, so `kernels.counts()` and
    `kernels.grad_counts()` hold what ran on the card (`pilot_eigmax`
    once a step on draws). `stats` counts the steps, the steps whose
    batch the step assembled, captures and replays, the capture's seconds
    and its graph pool's bytes.
    """

    def __init__(self, model: LDAMP, opt: Optimizer,
                 generator: torch.Generator, rows: int, updates: int,
                 capture: bool = True):
        dev = opt.count_t.device
        if generator.device.type != dev.type:
            raise ValueError("the generator lies on another device than "
                             "the model")
        self.model, self.opt, self.generator = model, opt, generator
        self.capture = capture and dev.type == "cuda"
        self.buf: Optional[Dict[str, torch.Tensor]] = None
        self.dirs: Optional[torch.Tensor] = None
        self.shapes = None         # the first step's input shapes
        self.staging = None        # pinned host buffers of the batch
        self.landed = None         # an event after the last staged copies
        self.losses = torch.zeros((rows, 2), dtype=torch.float32, device=dev)
        self.k = torch.zeros((), dtype=torch.int64, device=dev)
        self.warmed = False
        self.graph = None
        self.recorded = None       # kernel name -> launches a replay makes
        self.recorded_grad = None  # kernel name -> gradient work a replay
        self.stats = dict(steps=0, assembled=0, captures=0, replays=0,
                          capture_seconds=0.0, pool_bytes=0)
        opt.reserve(updates)
        opt.count_t.fill_(opt.count)
        self.table = opt.table

    def run(self, batches: Iterable[Dict[str, torch.Tensor]],
            seeds: Sequence[int],
            directions: Optional[Iterable[Sequence[torch.Tensor]]] = None
            ) -> torch.Tensor:
        """len(seeds) steps -> their (n, 2) (mse, nmse) rows, the runner's
        buffer."""
        n = len(seeds)
        if n > len(self.losses):
            raise ValueError(f"a run takes at most {len(self.losses)} "
                             f"steps: got {n}")
        self.k.zero_()
        dirs = iter(directions) if directions is not None else None
        with span("ldamp.run"):
            for seed, batch in zip(seeds, batches):
                with span("ldamp.load"):
                    self._load(batch, next(dirs) if dirs is not None
                               else None)
                with span("ldamp.step"):
                    self.opt.reserve_in(1, self.table)
                    self.generator.manual_seed(seed)
                    if not self.capture:
                        self._step()
                    elif not self.warmed:
                        _graph.on_side_stream(self._step, self.k.device)
                        # the capture makes its own in its pool
                        self.opt.zero_grad()
                        self.warmed = True
                    else:
                        if self.graph is None:
                            self._capture()
                        self.graph.replay()
                        kernels.add_launches(self.recorded)
                        kernels.add_grad_counts(self.recorded_grad)
                        self.stats["replays"] += 1
                self.stats["steps"] += 1
                self.stats["assembled"] += int("eig1" not in self.buf)
                self.opt.count += 1
        return self.losses[:n]

    def _load(self, batch: Dict[str, torch.Tensor],
              directions: Optional[Sequence[torch.Tensor]]) -> None:
        """Copy a step's inputs into the buffers (made at the first step
        with the first inputs' shapes)."""
        shapes = ({k: tuple(v.shape) for k, v in batch.items()},
                  None if directions is None else
                  (len(directions),) + tuple(directions[0].shape))
        if self.buf is None:
            dev = self.k.device
            self.buf = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                        for k, v in batch.items()}
            if directions is not None:
                self.dirs = torch.empty(shapes[1], dtype=torch.float32,
                                        device=dev)
            self.shapes = shapes
        elif shapes != self.shapes:
            raise ValueError("a runner's steps take the inputs of its first "
                             f"step, {self.shapes}: got {shapes}")
        if self.k.device.type == "cuda":
            self._stage(batch)
        else:
            for k, v in batch.items():
                self.buf[k].copy_(v)
        if directions is not None:
            for buf, d in zip(self.dirs, directions):
                buf.copy_(d)

    def _stage(self, batch: Dict[str, torch.Tensor]) -> None:
        """Copy a batch into the card's buffers by copies that do not wait
        for the stream: a host tensor goes through a pinned staging
        buffer, which changes only once the last staged copies landed, so
        the card runs on from replay k into copy and replay k+1 while the
        host makes the next batch."""
        host = [k for k, v in batch.items() if v.device.type == "cpu"]
        if host:
            if self.staging is None:
                self.staging = {k: torch.empty(batch[k].shape,
                                               dtype=batch[k].dtype,
                                               pin_memory=True)
                                for k in host}
                self.landed = torch.cuda.Event()
            self.landed.synchronize()
            for k in host:
                self.staging[k].copy_(batch[k])
        for k, v in batch.items():
            self.buf[k].copy_(self.staging[k] if k in host else v,
                              non_blocking=True)
        if host:
            self.landed.record()

    def _step(self) -> None:
        """One step on the buffers: `ldamp_update`, (mse, nmse) into row
        k, k += 1."""
        mse, nmse = ldamp_update(self.model, self.opt, self.buf,
                                 self.generator, self.dirs)
        self.losses.index_copy_(0, self.k.view(1),
                                torch.stack([mse, nmse]).view(1, 2))
        self.k.add_(1)

    def _capture(self) -> None:
        """Capture one step (`_graph.capture`)."""
        cap = _graph.capture(self._step, self.generator, self.k.device)
        self.graph = cap.graph
        self.recorded, self.recorded_grad = cap.launches, cap.grad
        self.stats["captures"] += 1
        self.stats["capture_seconds"] += cap.seconds
        self.stats["pool_bytes"] = max(self.stats["pool_bytes"],
                                       cap.pool_bytes)


def train_ldamp_snr(
    config: Config,
    train_snr: float,
    tc: LDAMPTrainConfig = LDAMPTrainConfig(),
    train_seed: int = 1234,
    checkpoint_path: Optional[str] = None,
    n_epochs: Optional[int] = None,
    log_fn: Callable[[str], None] = print,
    device: Optional[Union[str, torch.device]] = None,
    _init: Optional[dict] = None,
    _batches: Optional[Callable[[int], dict]] = None,
    _directions: Optional[Callable[[int], Sequence[torch.Tensor]]] = None,
    _capture: bool = True,
) -> Tuple[LDAMP, dict]:
    """Train one LDAMP at one SNR on `device` (None: the card); returns
    (model, logs). The steps run through one `LDAMPStepRunner` (on the
    card one captured step, replayed); `_capture` False runs the same
    steps eagerly, the loop the graph is held against. `_init` (a state
    dict), `_batches(step)` and `_directions(step)` replace the run's own
    draws (a test feeds the JAX package's through them)."""
    dev = resolve_device(device)
    n_epochs = n_epochs if n_epochs is not None else tc.n_epochs
    num_pilots = int(config.data.num_tx * tc.alpha)
    noise_std = 10 ** (-train_snr / 20.0) * np.sqrt(config.data.num_tx)
    data_cfg = dataclasses.replace(config.data, noise_std=float(noise_std),
                                   num_pilots=num_pilots)
    ds = ChannelDataset(train_seed, data_cfg, norm="global")
    batch_size = min(tc.batch_size, len(ds))
    steps_per_epoch = max(1, len(ds) // batch_size)

    model = make_ldamp_model(tc, dev, torch.Generator().manual_seed(
        derive_seed(tc.seed, 0)))
    if _init is not None:
        model.load_state_dict(_init, strict=True)
    opt = make_ldamp_optimizer(model, tc, max(1, len(ds) // tc.batch_size))
    runner = LDAMPStepRunner(model, opt, torch.Generator(device=dev),
                             steps_per_epoch, n_epochs * steps_per_epoch,
                             capture=_capture)

    def batch(s):  # made on the host
        return (_batches(s) if _batches is not None else ldamp_batch(
            ds, torch.Generator().manual_seed(derive_seed(tc.seed, 1, s)),
            batch_size, "cpu"))

    loss_log, nmse_log = [], []
    t0 = time.time()
    step = 0
    with matmul_precision(config.training.matmul_precision):
        for epoch in range(n_epochs):
            steps = range(step, step + steps_per_epoch)
            rows = runner.run(
                (batch(s) for s in steps),
                [derive_seed(tc.seed, 2, s) for s in steps],
                None if _directions is None else map(_directions, steps))
            step += steps_per_epoch
            chunk = rows.cpu().numpy()  # one sync an epoch
            loss_log.extend(chunk[:, 0].tolist())
            nmse_log.extend(chunk[:, 1].tolist())
            log_fn(f"SNR {train_snr:.1f} epoch {epoch} "
                   f"loss {loss_log[-1]:.3f} "
                   f"NMSE {10 * np.log10(max(nmse_log[-1], 1e-12)):.2f} dB "
                   f"({step / (time.time() - t0):.2f} steps/s)")

    logs = {"loss_log": np.asarray(loss_log), "nmse_log": np.asarray(nmse_log)}
    if checkpoint_path:
        save_checkpoint(checkpoint_path, config,
                        params=state_dict_to_jax_params(model.state_dict()),
                        extra_arrays=logs,
                        metadata={"train_snr": train_snr, "alpha": tc.alpha,
                                  "tc": dataclasses.asdict(tc)})
        log_fn(f"saved {checkpoint_path}")
    return model, logs


def checkpoint_name(model_dir: str, channel: str, snr: float,
                    alpha: float) -> str:
    """models/ldamp-FlippedUNet/train-<ch>/model_snr<snr>_alpha<a>.npz."""
    return os.path.join(model_dir, f"train-{channel}",
                        f"model_snr{snr:.2f}_alpha{alpha:.2f}.npz")


def train_ldamp_all_snrs(
    config: Config,
    snr_range: Sequence[float] = tuple(np.arange(-10, 35, 5)),
    tc: LDAMPTrainConfig = LDAMPTrainConfig(),
    out_dir: str = "models/ldamp-FlippedUNet",
    n_epochs: Optional[int] = None,
    log_fn: Callable[[str], None] = print,
    device: Optional[Union[str, torch.device]] = None,
) -> None:
    """Reference sweep: one model per SNR in -10..30 step 5
    (train_ldamp.py:23-24,36)."""
    for snr in snr_range:
        train_ldamp_snr(config, float(snr), tc,
                        checkpoint_path=checkpoint_name(
                            out_dir, config.data.channel, snr, tc.alpha),
                        n_epochs=n_epochs, log_fn=log_fn, device=device)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Train LDAMP (one model per SNR)")
    p.add_argument("--train", type=str, default="CDL-C")
    p.add_argument("--alpha", type=float, default=0.6)
    p.add_argument("--snr_range", nargs="+", type=float,
                   default=list(np.arange(-10, 35, 5)))
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--train_size", type=int, default=None,
                   help="training realizations (the reference uses 200)")
    p.add_argument("--model_dir", type=str,
                   default="models/ldamp-FlippedUNet")
    p.add_argument("--ray_coupling", type=str, default=None,
                   choices=["random", "fixed"],
                   help="dataset ensemble override (fixed = the "
                        "paper-matching per-drop coupling)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; --device cpu runs the "
                        "plain PyTorch path)")
    args = p.parse_args(argv)

    from ..config import default_score_config

    cfg = default_score_config(args.train, ray_coupling=args.ray_coupling)
    if args.train_size:
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, num_channels=args.train_size))
    train_ldamp_all_snrs(cfg, snr_range=args.snr_range,
                         tc=LDAMPTrainConfig(alpha=args.alpha),
                         out_dir=args.model_dir, n_epochs=args.epochs,
                         device=args.device)


if __name__ == "__main__":
    main()
