"""LDAMP training, one model per training SNR, the counterpart of the JAX
package's train/ldamp.py (reference train_ldamp.py).

Recipe (train_ldamp.py:38-97): FlippedUNet backbone, 10 unrolls, batch
128, Adam 1e-3 with a x0.1 staircase after `decay_epochs` epochs (optax's
exponential_decay, staircase=True, by the port's `Optimizer`), the e2e
MSE on the UNnormalised Hermitian channel (:117-120), training noise
amplitude 10^(-SNR/20) sqrt(Nt) (:66, an amplitude, as the reference).

On the card every denoiser conv runs `conv2d_taps`, forward and input
gradient. Random streams: the parameters are drawn on the CPU from
(seed, 0), each step's batch on the CPU from (seed, 1, step), each step's
divergence directions on the run's device from (seed, 2, step).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import cplx
from .._device import resolve_device
from ..config import Config, OptimConfig
from ..data.dataset import ChannelDataset
from ..eval.estimate import derive_seed
from ..models.convert import state_dict_to_jax_params
from ..models.ldamp import LDAMP
from ..utils.checkpoint import save_checkpoint
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
    """A `sample_batch` as the c2 tensors LDAMP takes, on `device` (the
    JAX package's train/ldamp.py::_device_batch)."""
    b = ds.sample_batch(generator, batch_size)
    return {k: cplx.as_c2(b[k]).to(device)
            for k in ("Y_herm", "P_herm", "H_herm_cplx")} | {
        "eig1": b["eig1"].to(device)}


def ldamp_losses(model: LDAMP, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None,
                 directions: Optional[Sequence[torch.Tensor]] = None,
                 num_unrolls: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(e2e MSE, mean NMSE) of one batch (train_ldamp.py:117-120)."""
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


def ldamp_train_step(model: LDAMP, opt: Optimizer, batch,
                     generator: Optional[torch.Generator] = None,
                     directions: Optional[Sequence[torch.Tensor]] = None):
    """One step: loss, backward, Adam; returns (mse, nmse) as 0-dim device
    tensors (no host sync)."""
    mse, nmse = ldamp_losses(model, batch, generator, directions)
    opt.zero_grad()
    mse.backward()
    opt.step()
    return mse.detach(), nmse.detach()


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
) -> Tuple[LDAMP, dict]:
    """Train one LDAMP at one SNR on `device` (None: the card); returns
    (model, logs). `_init` (a state dict), `_batches(step)` and
    `_directions(step)` replace the run's own draws (a test feeds the JAX
    package's through them)."""
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
    gen = torch.Generator(device=dev)

    loss_log, nmse_log = [], []
    t0 = time.time()
    step = 0
    with matmul_precision(config.training.matmul_precision):
        for epoch in range(n_epochs):
            losses = []
            for _ in range(steps_per_epoch):
                batch = (_batches(step) if _batches is not None
                         else ldamp_batch(ds, torch.Generator().manual_seed(
                             derive_seed(tc.seed, 1, step)), batch_size, dev))
                batch = {k: v.to(dev) for k, v in batch.items()}
                gen.manual_seed(derive_seed(tc.seed, 2, step))
                losses.append(torch.stack(ldamp_train_step(
                    model, opt, batch, gen,
                    _directions(step) if _directions is not None else None)))
                step += 1
            chunk = torch.stack(losses).cpu().numpy()  # one sync an epoch
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
