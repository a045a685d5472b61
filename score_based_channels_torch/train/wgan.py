"""WGAN (weight-clipping) trainer of the generative channel prior, the
counterpart of the JAX package's train/wgan.py (reference train_wgan.py):
critic clip +-0.01, Diters = 5 per generator step (100 for the first 25
and every 500th generator iteration, :134-137), RMSprop 5e-5 (optax's
rule: eps inside the root, nu from 0), batch 200, ENTRYWISE
normalisation, training on the non-Hermitian 'H' view.

Critic convention (:157-168): D minimises D(real) - D(fake); G minimises
D(fake). The D step clips the critic's parameters first and takes the
gradient at the clipped values; the critic sees the real batch, then the
fake one, each in train mode, so its batch statistics update in that
order; the generator makes the fake batch in train mode (its statistics
update too). The G step runs the critic in eval mode, on its running
statistics. Every layer is a library layer (models/dcgan.py).

Random streams: parameters drawn on the CPU from (seed, 0); each D step's
batch indices (without replacement) on the CPU from (seed, 1, d_step);
each z on the run's device from (seed, 2, d_step) and (seed, 3, g_step).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from .. import cplx
from .._device import resolve_device
from ..config import Config, OptimConfig
from ..data.dataset import ChannelDataset
from ..eval.estimate import derive_seed
from ..models.convert import module_to_jax_variables
from ..models.dcgan import DCGAN_D, DCGAN_G
from ..utils.checkpoint import save_checkpoint
from .score import Optimizer, matmul_precision


@dataclasses.dataclass(frozen=True)
class WGANTrainConfig:
    nz: int = 60
    ndf: int = 64
    ngf: int = 128
    n_extra_layers: int = 1  # spacing 0.5 => 1 (train_wgan.py:71-74)
    batch_size: int = 200
    n_epochs: int = 3000
    lr_d: float = 5e-5
    lr_g: float = 5e-5
    clamp: float = 0.01
    d_iters: int = 5
    d_iters_boost: int = 100
    boost_until: int = 25
    boost_every: int = 500
    seed: int = 2020


@dataclasses.dataclass
class WGANState:
    netG: DCGAN_G
    netD: DCGAN_D
    g_opt: Optimizer
    d_opt: Optimizer
    gen_iterations: int = 0


def make_wgan(config: Config, tc: WGANTrainConfig,
              device: Optional[Union[str, torch.device]] = None) -> WGANState:
    """Generator and critic of `tc` for the config's image size on
    `device` (None: the card), drawn from (tc.seed, 0), with fresh
    RMSprop."""
    dev = resolve_device(device)
    isize = (config.data.num_rx, config.data.num_tx)
    g = torch.Generator().manual_seed(derive_seed(tc.seed, 0))
    netG = DCGAN_G(isize=isize, nz=tc.nz, ngf=tc.ngf,
                   n_extra_layers=tc.n_extra_layers)
    netD = DCGAN_D(isize=isize, ndf=tc.ndf, n_extra_layers=tc.n_extra_layers)
    netG.init_parameters(g)
    netD.init_parameters(g)
    netG.to(dev)
    netD.to(dev)
    rms = lambda lr: OptimConfig(optimizer="RMSProp", lr=lr)
    return WGANState(netG, netD,
                     Optimizer(netG.named_parameters(), rms(tc.lr_g)),
                     Optimizer(netD.named_parameters(), rms(tc.lr_d)))


def wgan_d_step(state: WGANState, real: torch.Tensor, z: torch.Tensor,
                clamp: float) -> torch.Tensor:
    """One critic step; returns (loss, D(real), D(fake)) stacked, on the
    device (train_wgan.py:143-168)."""
    netG, netD = state.netG, state.netD
    with torch.no_grad():
        for p in netD.parameters():
            p.clamp_(-clamp, clamp)
        netG.train()
        fake = netG(z)
    netD.train()
    dr = netD(real)
    df = netD(fake)
    loss = dr - df
    state.d_opt.zero_grad()
    loss.backward()
    state.d_opt.step()
    return torch.stack([loss, dr, df]).detach()


def wgan_g_step(state: WGANState, z: torch.Tensor) -> torch.Tensor:
    """One generator step with the critic in eval mode; returns D(fake)."""
    netG, netD = state.netG, state.netD
    netG.train()
    netD.eval()
    loss = netD(netG(z))
    state.g_opt.zero_grad()
    loss.backward(inputs=state.g_opt.params)
    state.g_opt.step()
    netD.train()
    state.gen_iterations += 1
    return loss.detach()


def d_iters_for(tc: WGANTrainConfig, gen_iterations: int) -> int:
    """The critic steps before generator step `gen_iterations` (:134-137)."""
    return (tc.d_iters_boost if gen_iterations < tc.boost_until
            or gen_iterations % tc.boost_every == 0 else tc.d_iters)


def wgan_checkpoint_params(state: WGANState) -> dict:
    """The checkpoint's `params` tree: gen, disc, gen_stats, disc_stats."""
    g_params, g_stats = module_to_jax_variables(state.netG)
    d_params, d_stats = module_to_jax_variables(state.netD)
    return {"gen": g_params, "disc": d_params, "gen_stats": g_stats,
            "disc_stats": d_stats}


def train_wgan(
    config: Config,
    tc: WGANTrainConfig = WGANTrainConfig(),
    train_seed: int = 1234,
    checkpoint_path: Optional[str] = None,
    n_epochs: Optional[int] = None,
    log_fn: Callable[[str], None] = print,
    device: Optional[Union[str, torch.device]] = None,
    _init: Optional[Tuple[dict, dict]] = None,
    _draws: Optional[Callable[[str, int], torch.Tensor]] = None,
) -> Tuple[WGANState, dict]:
    """Train on `device` (None: the card); returns (state, logs).
    `_init` = (generator, critic) state dicts, and `_draws(kind, i)` for
    kind "real" (the batch of critic step i, c2 (B, Nr, Nt, 2)), "z"
    (critic step i) and "zg" (generator step i), replace the run's own
    draws and data (a test feeds the JAX package's)."""
    dev = resolve_device(device)
    n_epochs = n_epochs if n_epochs is not None else tc.n_epochs
    data_cfg = dataclasses.replace(config.data, noise_std=0.0)
    ds = ChannelDataset(train_seed, data_cfg, norm="entrywise")
    H = cplx.as_c2(torch.from_numpy(ds.normalized())).to(dev)  # (N, Nr, Nt, 2)

    state = make_wgan(config, tc, dev)
    if _init is not None:
        state.netG.load_state_dict(_init[0], strict=True)
        state.netD.load_state_dict(_init[1], strict=True)

    def draw(kind, i, shape):
        if _draws is not None:
            return _draws(kind, i).to(dev)
        if kind == "real":  # batch indices without replacement
            return H[torch.randperm(n, generator=torch.Generator().manual_seed(
                derive_seed(tc.seed, 1, i)))[:shape[0]].to(dev)]
        g = torch.Generator(device=dev).manual_seed(
            derive_seed(tc.seed, 2 if kind == "z" else 3, i))
        return torch.randn(shape, generator=g, device=dev)

    n = H.shape[0]
    bs = min(tc.batch_size, n)
    d_log, g_log = [], []
    d_steps = 0
    t0 = time.time()
    with matmul_precision(config.training.matmul_precision):
        for epoch in range(n_epochs):
            for _ in range(d_iters_for(tc, state.gen_iterations)):
                d_out = wgan_d_step(state, draw("real", d_steps, (bs,)),
                                    draw("z", d_steps, (bs, tc.nz)), tc.clamp)
                d_steps += 1
            gl = wgan_g_step(state, draw("zg", state.gen_iterations,
                                         (tc.batch_size, tc.nz)))
            d_log.append(d_out[0])
            g_log.append(gl)
            if (epoch + 1) % 100 == 0:
                log_fn(f"epoch {epoch + 1}/{n_epochs} "
                       f"D {float(d_log[-1]):.4f} G {float(g_log[-1]):.4f} "
                       f"({(epoch + 1) / (time.time() - t0):.2f} epochs/s)")

    logs = {"d_log": torch.stack(d_log).cpu().numpy().astype(np.float64),
            "g_log": torch.stack(g_log).cpu().numpy().astype(np.float64),
            "norm_mean_r": np.real(ds.mean), "norm_mean_i": np.imag(ds.mean),
            "norm_std": np.asarray(ds.std, np.float32)}
    if checkpoint_path:
        save_checkpoint(checkpoint_path, config,
                        params=wgan_checkpoint_params(state),
                        extra_arrays=logs,
                        metadata={"tc": dataclasses.asdict(tc)})
        log_fn(f"saved {checkpoint_path}")
    return state, logs


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Train the WGAN channel prior")
    p.add_argument("--train", type=str, default="CDL-C")
    p.add_argument("--spacing", type=float, default=0.5)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--train_size", type=int, default=None,
                   help="training realizations (the reference uses 200)")
    p.add_argument("--nz", type=int, default=60,
                   help="latent dimension (reference: 60, aux_gan.py:58)")
    p.add_argument("--output", type=str, default=None)
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
    data = dataclasses.replace(cfg.data, spacing_list=(args.spacing,))
    if args.train_size:
        data = dataclasses.replace(data, num_channels=args.train_size)
    cfg = cfg.replace(data=data)
    out = args.output or f"models/wgan/{args.train}_{args.spacing:.2f}.npz"
    train_wgan(cfg, tc=WGANTrainConfig(nz=args.nz), checkpoint_path=out,
               n_epochs=args.epochs, device=args.device)


if __name__ == "__main__":
    main()
