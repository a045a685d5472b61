"""Regularized least-squares ("ML") channel-estimation baseline, the
counterpart of the JAX package's baselines/ls.py (the `ls` command,
reference test_ml.py:124-146).

Per sample, the regularized normal equations (A^H A + noise I) h = A^H y
are lifted to the equivalent real block system

  [Re(G) -Im(G)] [Re(h)]   [Re(b)]
  [Im(G)  Re(G)] [Im(h)] = [Im(b)]

(G Hermitian PSD + noise I, so the block is symmetric positive definite)
and the whole {channels x SNR} batch is solved at once by a batched
Cholesky factorisation on the run's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .. import cplx, physics
from .._device import resolve_device
from ..config import Config
from ..data.dataset import ChannelDataset
from ..eval.estimate import _generator


def _real_block(G2: torch.Tensor) -> torch.Tensor:
    """c2 Hermitian matrix (..., N, N, 2) -> real block (..., 2N, 2N)."""
    Gr, Gi = G2[..., 0], G2[..., 1]
    top = torch.cat([Gr, -Gi], dim=-1)
    bot = torch.cat([Gi, Gr], dim=-1)
    return torch.cat([top, bot], dim=-2)


def ls_estimate(A2: torch.Tensor, Y2: torch.Tensor,
                noise_power) -> torch.Tensor:
    """Batched regularized LS: argmin ||A h - y||^2 + noise ||h||^2 in c2.

    A2: (B, Np, Nt, 2), Y2: (B, Np, Nr, 2), noise_power scalar or (B,).
    Returns (B, Nt, Nr, 2) on A2's device. A factorisation that fails
    (non-zero `info`) raises; nothing is retried.
    """
    Ah = cplx.conj_transpose(A2)
    G = cplx.matmul(Ah, A2)  # (B, Nt, Nt, 2) Hermitian
    b = cplx.matmul(Ah, Y2)  # (B, Nt, Nr, 2)
    nt = G.shape[-3]
    lam = torch.broadcast_to(torch.as_tensor(
        noise_power, dtype=torch.float32, device=G.device), G.shape[:-3])
    eye = torch.eye(nt, dtype=G.dtype, device=G.device)
    G = torch.stack([G[..., 0] + lam[..., None, None] * eye, G[..., 1]],
                    dim=-1)

    M = _real_block(G)  # (B, 2Nt, 2Nt) SPD
    rhs = torch.cat([b[..., 0], b[..., 1]], dim=-2)  # (B, 2Nt, Nr)
    L, info = torch.linalg.cholesky_ex(M)
    bad = torch.nonzero(info).flatten()
    if bad.numel():
        raise torch.linalg.LinAlgError(
            f"ls_estimate: the Cholesky factorisation failed for "
            f"{bad.numel()} of {info.numel()} systems (first: sample "
            f"{int(bad[0])}, info {int(info[bad[0]])})")
    sol = torch.cholesky_solve(rhs, L)
    hr, hi = torch.split(sol, nt, dim=-2)
    return torch.stack([hr, hi], dim=-1)


@dataclasses.dataclass
class LSResults:
    """The JAX package's LSResults; the saved .npz has its keys."""

    nmse: np.ndarray  # (n_spacing, n_alpha, n_snr, n_channels)
    snr_range: np.ndarray
    spacing_range: np.ndarray
    alpha_range: np.ndarray

    def avg_nmse_db(self) -> np.ndarray:
        return 10 * np.log10(self.nmse.mean(-1))

    def save(self, path: str) -> None:
        import os

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **dataclasses.asdict(self))


def run_ls_baseline(
    config: Config,
    channel: str = "CDL-C",
    model_channel: Optional[str] = None,
    snr_range: Optional[np.ndarray] = None,
    spacing_range: Sequence[float] = (0.5,),
    alpha_range: Sequence[float] = (0.6,),
    num_channels: int = 50,
    train_seed: int = 1234,
    val_seed: int = 4321,
    seed: int = 99,
    device=None,
) -> LSResults:
    """test_ml.py evaluation: SNR -30...15 step 2.5, 50 kept samples, noise
    power WITHOUT the Nt factor (test_ml.py:67, unlike the score path).

    Pilots and measurement noise of each (spacing, alpha) point come from a
    CPU generator seeded by (seed, point), so every device sees the same
    draws; the solves run on `device` (None: the card).
    """
    dev = resolve_device(device)
    if snr_range is None:
        snr_range = np.arange(-30, 17.5, 2.5)  # test_ml.py:64
    snr_range = np.asarray(snr_range, np.float64)
    model_channel = model_channel or channel

    train_cfg = dataclasses.replace(config.data, channel=model_channel)
    train_ds = ChannelDataset(train_seed, train_cfg, norm="global")

    S = len(snr_range)
    out = np.zeros((len(spacing_range), len(alpha_range), S, num_channels),
                   np.float32)
    for i_sp, spacing in enumerate(spacing_range):
        for i_al, alpha in enumerate(alpha_range):
            num_pilots = int(np.floor(config.data.num_tx * alpha))
            val_cfg = dataclasses.replace(
                config.data, channel=channel, spacing_list=(spacing,),
                num_channels=max(num_channels, config.data.num_channels))
            val_ds = ChannelDataset(val_seed, val_cfg,
                                    norm=list(train_ds.norm_stats),
                                    num_pilots=num_pilots)
            X2 = val_ds.hermitian_c2()[:num_channels]
            C = X2.shape[0]
            g = _generator(seed, i_sp * len(alpha_range) + i_al)
            P2 = cplx.qpsk_pilots(g, C, config.data.num_tx, num_pilots)
            A2 = cplx.conj_transpose(P2)

            # flatten SNR x channels; noise = 10^(-SNR/10) (test_ml.py:67)
            npow = torch.from_numpy(np.repeat(
                10.0 ** (-snr_range / 10.0), C).astype(np.float32))
            A_b = A2.repeat(S, 1, 1, 1)
            X_b = X2.repeat(S, 1, 1, 1)
            Y_b = physics.measure_c2(g, A_b, X_b, npow)
            est = ls_estimate(A_b.to(dev), Y_b.to(dev), npow.to(dev))
            nm = cplx.nmse(est, X_b.to(dev)).cpu().numpy().reshape(S, C)
            out[i_sp, i_al] = nm
    return LSResults(nmse=out, snr_range=snr_range,
                     spacing_range=np.asarray(spacing_range),
                     alpha_range=np.asarray(alpha_range))


def main(argv=None):
    """CLI: `ls` with the JAX package's flags plus --device."""
    import argparse

    p = argparse.ArgumentParser(description="Regularized-LS baseline")
    p.add_argument("--model", type=str, default="CDL-C")
    p.add_argument("--channel", type=str, default="CDL-C")
    p.add_argument("--spacing", nargs="+", type=float, default=[0.5])
    p.add_argument("--alpha", nargs="+", type=float, default=[0.6])
    p.add_argument("--snr", nargs="+", type=float, default=None)
    p.add_argument("--num_channels", type=int, default=50)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--ray_coupling", type=str, default=None,
                   choices=["random", "fixed"],
                   help="dataset ensemble override (fixed = the "
                        "paper-matching per-drop coupling)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; --device cpu runs on "
                        "the CPU)")
    args = p.parse_args(argv)

    from ..config import default_score_config

    cfg = default_score_config(args.model, ray_coupling=args.ray_coupling)
    res = run_ls_baseline(
        cfg, channel=args.channel, model_channel=args.model,
        snr_range=np.asarray(args.snr) if args.snr else None,
        spacing_range=tuple(args.spacing), alpha_range=tuple(args.alpha),
        num_channels=args.num_channels, device=args.device)
    db = res.avg_nmse_db()
    for s, snr in enumerate(res.snr_range):
        print(f"SNR {snr:6.1f} dB  NMSE {db[0, 0, s]:7.2f} dB")
    out = args.output or (f"results/ls/model_{args.model}_channel_"
                          f"{args.channel}.npz")
    res.save(out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
