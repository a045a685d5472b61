"""WGAN latent-optimisation channel estimation, the counterpart of the JAX
package's eval/wgan.py (reference test_wgan.py).

Inversion (:139-176): Adam on z over ||G(z) P - Y||^2 + lambda ||z||^2,
with the oracle NMSE, the measurement and the regulariser logged at every
step. The (lambda x lr x pilot alpha x SNR x channel x restart) grid is
one batch with a per-sample Adam (per-sample learning rates), cut into
chunks; with R restarts the reported chain of each cell is the restart
with the lowest final objective (no oracle). On the card by default; the
generator is library layers (models/dcgan.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import cplx
from .._device import resolve_device
from ..config import Config
from ..data.dataset import ChannelDataset
from ..models.convert import jax_variables_to_state_dict
from ..models.dcgan import DCGAN_G
from ..train.score import matmul_precision
from ..train.wgan import WGANTrainConfig
from ..utils.checkpoint import load_checkpoint
from .estimate import derive_seed


def wgan_invert(
    generator_apply: Callable[[torch.Tensor], torch.Tensor],
    z0: torch.Tensor,
    P2: torch.Tensor,
    Y2: torch.Tensor,
    l2lam,
    lr,
    num_steps: int = 5000,
    oracle2: Optional[torch.Tensor] = None,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, ...]]]:
    """Per-sample-Adam latent optimisation (eval/wgan.py:30).

    generator_apply: z (B, nz) -> channels c2 (B, Nr, Nt, 2); P2 (B, Nt,
    Np, 2) pilots; Y2 (B, Nr, Np, 2) measurements; l2lam, lr scalar or
    (B,). Returns (final channels, traces): traces = (oracle NMSE,
    measurement loss, regulariser), each (num_steps, B) on the device,
    None without an oracle."""
    dev = z0.device
    B = z0.shape[0]
    lam = torch.as_tensor(l2lam, dtype=torch.float32,
                          device=dev).expand(B).contiguous()
    lr = torch.as_tensor(lr, dtype=torch.float32,
                         device=dev).expand(B)[:, None].contiguous()
    track = oracle2 is not None
    if track:
        oracle_energy = cplx.sum_abs2(oracle2, dim=(-1, -2))
        traces = torch.empty((3, num_steps, B), dtype=torch.float32,
                             device=dev)

    def sample_losses(z):
        gen = generator_apply(z)
        meas_loss = cplx.sum_abs2(cplx.matmul(gen, P2) - Y2, dim=(-1, -2))
        return meas_loss, (z * z).sum(dim=-1), gen

    z = z0.detach().clone()
    m, v = torch.zeros_like(z), torch.zeros_like(z)
    b1, b2 = np.float32(beta1), np.float32(beta2)
    for i in range(num_steps):
        zr = z.requires_grad_()
        with torch.enable_grad():
            meas_loss, reg_loss, gen = sample_losses(zr)
            g, = torch.autograd.grad((meas_loss + lam * reg_loss).mean(), zr)
        z = zr.detach()
        g = g * B  # the loss is a batch mean: back to per-sample scale
        m.mul_(beta1).add_(g, alpha=1 - beta1)
        v.mul_(beta2).add_(g * g, alpha=1 - beta2)
        t = np.float32(i + 1)
        mhat = m / float(1 - b1 ** t)
        vhat = v / float(1 - b2 ** t)
        z = z - lr * mhat / (torch.sqrt(vhat) + eps)
        if track:
            with torch.no_grad():
                traces[0, i] = (cplx.sum_abs2(gen - oracle2, dim=(-1, -2))
                                / oracle_energy)
                traces[1, i] = meas_loss
                traces[2, i] = reg_loss
    with torch.no_grad():
        _, _, gen_final = sample_losses(z)
    return gen_final, (tuple(traces) if track else None)


@dataclasses.dataclass
class WGANEvalResults:
    oracle_log: np.ndarray  # (nL, nR, nA, S, steps, C)
    meas_log: np.ndarray
    reg_log: np.ndarray
    snr_range: np.ndarray
    l2lam_range: np.ndarray
    lr_range: np.ndarray
    pilot_alpha_range: np.ndarray

    def best_nmse_db(self) -> np.ndarray:
        """min over steps of mean over channels, then min over (lambda, lr)."""
        avg = self.oracle_log.mean(-1).min(-1)  # (nL, nR, nA, S)
        return 10 * np.log10(avg.min(axis=(0, 1)))  # (nA, S)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **dataclasses.asdict(self))


def load_generator(checkpoint: str, config: Config, device) -> DCGAN_G:
    """The checkpoint's generator (either package's `train-wgan`) in eval
    mode, with its running statistics and no parameter gradients."""
    ck = load_checkpoint(checkpoint)
    meta_tc = ck["metadata"].get("tc", {})
    tc = WGANTrainConfig(**meta_tc) if meta_tc else WGANTrainConfig()
    netG = DCGAN_G(isize=(config.data.num_rx, config.data.num_tx), nz=tc.nz,
                   ngf=tc.ngf, n_extra_layers=tc.n_extra_layers)
    netG.load_state_dict(jax_variables_to_state_dict(
        ck["params"]["gen"], ck["params"].get("gen_stats")), strict=True)
    return netG.to(device).eval().requires_grad_(False)


def run_wgan_eval(
    config: Config,
    checkpoint: str,
    channel: str = "CDL-C",
    snr_range: Optional[np.ndarray] = None,
    l2lam_range: Sequence[float] = (0.1, 0.3, 1.0, 3.0),
    lr_range: Sequence[float] = (0.03, 0.01, 0.003, 0.001),
    pilot_alpha_range: Sequence[float] = (0.6,),
    num_steps: int = 5000,
    num_channels: int = 100,
    train_seed: int = 1234,
    val_seed: int = 4321,
    seed: int = 2021,
    chunk_size: Optional[int] = None,
    noise_convention: str = "reference",
    restarts: int = 1,
    device: Optional[Union[str, torch.device]] = None,
    _draws: Optional[tuple] = None,
) -> WGANEvalResults:
    """The JAX package's run_wgan_eval:116 on `device` (None: the card).
    Reference grids: lambda in {.1,.3,1,3}, lr in {.03,.01,.003,.001}, SNR
    -10..15 step 2.5; noise_convention "reference" is test_wgan.py:75's
    10^(-SNR/10) (no Nt factor), "aligned" 10^(-SNR/10) Nt. restarts: R
    z inits per cell, the restart with the lowest final objective
    (measurement + lambda reg) reported.

    `_draws` = (z_init (R, C, nz), [(X2 (C, Nr, Nt, 2) normalised
    channels, P2 (C, Nt, Np, 2), w (S*C, Nr, Np, 2) unit noise) for each
    pilot alpha]) replaces the run's own draws and channels."""
    dev = resolve_device(device)
    snr_range = np.asarray(np.arange(-10, 17.5, 2.5) if snr_range is None
                           else snr_range, np.float64)
    netG = load_generator(checkpoint, config, dev)
    nz = netG.dense_input.in_features

    nL, nR = len(l2lam_range), len(lr_range)
    nA, S, C = len(pilot_alpha_range), len(snr_range), num_channels
    R, G = int(restarts), nL * nR
    oracle_log = np.zeros((nL, nR, nA, S, num_steps, C), np.float32)
    meas_log = np.zeros_like(oracle_log)
    reg_log = np.zeros_like(oracle_log)

    if _draws is not None:
        z_init = _draws[0]
    else:
        # entrywise normalisation with TRAIN stats (test_wgan.py:52,116)
        train_ds = ChannelDataset(train_seed, dataclasses.replace(
            config.data, channel=channel), norm="entrywise")
        z_init = torch.randn((R, C, nz), generator=torch.Generator()
                             .manual_seed(derive_seed(seed, 0)))
    with matmul_precision(config.training.matmul_precision):
        for i_al, pilot_alpha in enumerate(pilot_alpha_range):
            num_pilots = int(np.floor(config.data.num_tx * pilot_alpha))
            if _draws is not None:
                X2, P2, w = _draws[1][i_al]
            else:
                val_ds = ChannelDataset(val_seed, dataclasses.replace(
                    config.data, channel=channel,
                    num_channels=max(C, config.data.num_channels)),
                    norm=list(train_ds.norm_stats), num_pilots=num_pilots)
                X2 = cplx.as_c2(torch.from_numpy(val_ds.normalized()[:C]))
                g = torch.Generator().manual_seed(derive_seed(seed, 1, i_al))
                P2 = cplx.qpsk_pilots(g, C, config.data.num_tx, num_pilots)
                w = cplx.randn(g, (S * C, config.data.num_rx, num_pilots))
            nt_fac = (config.data.num_tx if noise_convention == "aligned"
                      else 1.0)
            npow = np.repeat(10.0 ** (-snr_range / 10.0) * nt_fac,
                             C).astype(np.float32)
            P_sc, X_sc = P2.repeat(S, 1, 1, 1), X2.repeat(S, 1, 1, 1)
            Y_sc = cplx.matmul(X_sc, P_sc) + w * torch.sqrt(
                torch.from_numpy(npow))[:, None, None, None]
            # batch order: (restart, lambda, lr, SNR, channel)
            P_b = P_sc.repeat(R * G, 1, 1, 1).to(dev)
            X_b = X_sc.repeat(R * G, 1, 1, 1).to(dev)
            Y_b = Y_sc.repeat(R * G, 1, 1, 1).to(dev)
            z_b = z_init[:, None].expand(R, G * S, C, nz).reshape(
                -1, nz).to(dev)
            lam_b = torch.from_numpy(np.tile(np.repeat(np.repeat(
                np.asarray(l2lam_range, np.float32), nR), S * C), R)).to(dev)
            lr_b = torch.from_numpy(np.tile(np.repeat(np.tile(
                np.asarray(lr_range, np.float32), nL), S * C), R)).to(dev)
            B = P_b.shape[0]
            chunk = chunk_size or B
            parts = []
            for start in range(0, B, chunk):
                sl = slice(start, start + chunk)
                _, tr = wgan_invert(netG, z_b[sl], P_b[sl], Y_b[sl],
                                    lam_b[sl], lr_b[sl], num_steps=num_steps,
                                    oracle2=X_b[sl])
                parts.append(torch.stack(tr).cpu().numpy())
            tr_o, tr_m, tr_r = np.concatenate(parts, axis=2).reshape(
                3, num_steps, R, nL, nR, S, C)
            lam_np = lam_b.cpu().numpy().reshape(R, nL, nR, S, C)
            # (nL, nR, S, C)
            pick = np.argmin(tr_m[-1] + lam_np * tr_r[-1], axis=0)
            for logs, t in ((oracle_log, tr_o), (meas_log, tr_m),
                            (reg_log, tr_r)):
                t = np.take_along_axis(t, np.broadcast_to(
                    pick[None, None], (num_steps, 1) + t.shape[2:]), axis=1)
                logs[:, :, i_al] = np.transpose(t[:, 0], (1, 2, 3, 0, 4))

    return WGANEvalResults(
        oracle_log=oracle_log, meas_log=meas_log, reg_log=reg_log,
        snr_range=snr_range, l2lam_range=np.asarray(l2lam_range),
        lr_range=np.asarray(lr_range),
        pilot_alpha_range=np.asarray(pilot_alpha_range))


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="WGAN latent-inversion estimation")
    p.add_argument("--model", type=str, default="CDL-C")
    p.add_argument("--channel", type=str, default="CDL-C")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--spacing", type=float, default=0.5)
    p.add_argument("--steps", type=int, default=5000)
    p.add_argument("--num_channels", type=int, default=100)
    p.add_argument("--l2lam_range", nargs="+", type=float,
                   default=[0.1, 0.3, 1.0, 3.0])
    p.add_argument("--lr_range", nargs="+", type=float,
                   default=[0.03, 0.01, 0.003, 0.001])
    p.add_argument("--alpha_range", nargs="+", type=float, default=[0.6])
    p.add_argument("--chunk", type=int, default=4096,
                   help="chains per inversion batch; the JAX package "
                        "flattens the whole grid (17,600 chains at the "
                        "defaults) into one, the port cuts it to bound "
                        "the card's memory (0: one batch)")
    p.add_argument("--snr", nargs="+", type=float, default=None)
    p.add_argument("--restarts", type=int, default=1,
                   help="independent z inits per cell; the reported chain "
                        "is the restart with the lowest final objective "
                        "(measurement + lambda*reg, no oracle)")
    p.add_argument("--noise_convention", type=str, default="reference",
                   choices=["reference", "aligned"],
                   help="reference = test_wgan.py:75 (no Nt factor); "
                        "aligned = the pipeline-wide 10^(-SNR/10)*Nt")
    p.add_argument("--ray_coupling", type=str, default=None,
                   choices=["random", "fixed"],
                   help="override the dataset ensemble (fixed = the "
                        "paper-matching per-drop coupling)")
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; --device cpu runs the "
                        "plain PyTorch path)")
    args = p.parse_args(argv)

    from ..config import default_score_config

    cfg = default_score_config(args.model, ray_coupling=args.ray_coupling)
    ckpt = args.checkpoint or f"models/wgan/{args.model}_{args.spacing:.2f}.npz"
    res = run_wgan_eval(
        cfg, ckpt, channel=args.channel,
        snr_range=np.asarray(args.snr) if args.snr else None,
        l2lam_range=tuple(args.l2lam_range), lr_range=tuple(args.lr_range),
        pilot_alpha_range=tuple(args.alpha_range), num_steps=args.steps,
        num_channels=args.num_channels, chunk_size=args.chunk,
        noise_convention=args.noise_convention, restarts=args.restarts,
        device=args.device)
    db = res.best_nmse_db()
    for i_al, al in enumerate(res.pilot_alpha_range):
        for s, snr in enumerate(res.snr_range):
            print(f"alpha {al} SNR {snr:6.1f} dB NMSE {db[i_al, s]:7.2f} dB")
    out = args.output or (f"results/wgan/model-{args.model}_"
                          f"channel-{args.channel}.npz")
    res.save(out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
