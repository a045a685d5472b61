"""Hyper-parameter grid search, the counterpart of the JAX package's
eval/tune.py (the `tune` command, reference tune_hparams_score.py).

The (alpha_step x beta_noise) grid is more batch: each (alpha, beta, SNR,
channel) tuple is one row of a flattened batch with per-sample
hyper-parameters, run through `langevin_chunked` in chunks of one shape.
Per-SNR argmin selection reproduces tune_hparams_score.py:150-162; the
saved files have the JAX package's keys, so either package's `estimate
--hparams` reads the other's table.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import cplx, physics
from .._device import resolve_device
from ..config import Config
from ..data.dataset import ChannelDataset
from ..diffusion.sigmas import sigmas_from_config
from .estimate import _generator, derive_seed, langevin_chunked


@dataclasses.dataclass
class TuneResults:
    """Mirror of the reference `<ch>-hyperparameters.pt`
    (tune_hparams_score.py:180-189) and of the JAX package's TuneResults."""

    nmse_log: np.ndarray  # (n_alpha, n_beta, n_snr, n_steps, n_channels)
    avg_nmse: np.ndarray
    best_nmse: np.ndarray  # (n_alpha, n_beta, n_snr)
    best_alpha_snr: np.ndarray  # (n_snr,)
    best_beta_snr: np.ndarray  # (n_snr,)
    best_step_snr: np.ndarray  # (n_snr,) argmin step index of the best combo
    snr_range: np.ndarray
    alpha_step_range: np.ndarray
    beta_noise_range: np.ndarray

    def save(self, path: str) -> None:
        import os

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **dataclasses.asdict(self))

    @classmethod
    def load(cls, path: str) -> "TuneResults":
        with np.load(path) as f:
            return cls(**{k: f[k] for k in f.files})

    def blind_selection(self) -> tuple:
        """One (alpha, beta, stop step) for ALL SNRs, the blind-SNR protocol
        (plot_ood_results.py:12-14): the (combo, step) minimizing the mean
        over SNR points of dB-NMSE; diverged combos are NaN -> +inf
        guarded."""
        avg = np.where(np.isfinite(self.avg_nmse), self.avg_nmse, np.inf)
        with np.errstate(divide="ignore"):
            db = 10.0 * np.log10(avg)  # (nA, nB, S, steps)
        score = db.mean(axis=2)  # mean over SNR, in dB
        iA, iB, n = np.unravel_index(int(np.argmin(score)), score.shape)
        return (float(self.alpha_step_range[iA]),
                float(self.beta_noise_range[iB]), int(n))

    def save_slim(self, path: str) -> None:
        """Selection tables only (the full per-step log is ~350 MB)."""
        import os

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        b_alpha, b_beta, b_step = self.blind_selection()
        iA = int(np.argmin(np.abs(self.alpha_step_range - b_alpha)))
        iB = int(np.argmin(np.abs(self.beta_noise_range - b_beta)))
        np.savez(
            path,
            best_alpha_snr=self.best_alpha_snr,
            best_beta_snr=self.best_beta_snr,
            best_step_snr=self.best_step_snr,
            snr_range=self.snr_range,
            alpha_step_range=self.alpha_step_range,
            beta_noise_range=self.beta_noise_range,
            best_nmse=self.best_nmse,
            blind_alpha=b_alpha, blind_beta=b_beta, blind_step=b_step,
            blind_nmse=self.avg_nmse[iA, iB, :, b_step],
        )


def select(nmse_log: np.ndarray, snr_range, alphas, betas) -> TuneResults:
    """Per-SNR best (alpha, beta, step) of a (nA, nB, S, steps, C) log,
    NaN-safe: a diverged combo never wins the argmin."""
    nA, nB, S = nmse_log.shape[:3]
    avg = nmse_log.mean(axis=-1)
    avg_safe = np.where(np.isfinite(avg), avg, np.inf)
    best = avg_safe.min(axis=-1)  # (nA, nB, S)
    best_step = avg_safe.argmin(axis=-1)  # (nA, nB, S)

    # per-SNR best combo (tune_hparams_score.py:155-162)
    best_alpha_snr = np.zeros(S)
    best_beta_snr = np.zeros(S)
    best_step_snr = np.zeros(S, np.int64)
    for s in range(S):
        flat = best[..., s].ravel()
        iA, iB = np.unravel_index(int(np.argmin(flat)), (nA, nB))
        best_alpha_snr[s] = alphas[iA]
        best_beta_snr[s] = betas[iB]
        best_step_snr[s] = best_step[iA, iB, s]

    return TuneResults(
        nmse_log=nmse_log, avg_nmse=avg, best_nmse=best,
        best_alpha_snr=best_alpha_snr, best_beta_snr=best_beta_snr,
        best_step_snr=best_step_snr, snr_range=np.asarray(snr_range),
        alpha_step_range=np.asarray(alphas),
        beta_noise_range=np.asarray(betas))


def run_hparam_search(
    score_fn,
    config: Config,
    channel: str = "CDL-C",
    snr_range: Optional[np.ndarray] = None,
    alpha_step_range: Sequence[float] = (3e-11, 6e-11, 1e-10, 3e-10),
    beta_noise_range: Sequence[float] = (0.1, 0.01, 0.001),
    spacing: float = 0.5,
    pilot_alpha: float = 0.6,
    num_channels: int = 100,
    train_seed: int = 1234,
    val_seed: int = 4321,
    seed: int = 2023,
    chunk_size: Optional[int] = None,
    device=None,
    mesh=None,
    _draws: Optional[Tuple[torch.Tensor, ...]] = None,
) -> TuneResults:
    """Grid defaults follow tune_hparams_score.py:20-24. Runs on `device`
    (None: the card).

    One (SNR x channels) measurement set is shared across the whole
    (alpha, beta) grid (the JAX package's tune.py:143-160): the combo index
    is g = iA*nB + iB, the batch row g*(S*C) + s*C + c. Pilots, the
    Langevin init and the measurement noise come from a CPU generator
    seeded by (seed, 0), the Langevin noise from (seed, 1). mesh splits
    every chunk over the ranks (`langevin_chunked`).

    _draws: (A (C,Np,Nt,2), Y (S*C,Np,Nr,2), X (C,Nt,Nr,2), x_init
    (C,Nt,Nr,2)) given instead of drawn (the parity tests pass the JAX
    package's); then no data set is built.
    """
    dev = resolve_device(device)
    if snr_range is None:
        snr_range = np.arange(-10, 32.5, 2.5)
    snr_range = np.asarray(snr_range, np.float64)
    alphas = np.asarray(alpha_step_range, np.float64)
    betas = np.asarray(beta_noise_range, np.float64)
    nA, nB, S = len(alphas), len(betas), len(snr_range)
    noise_powers = np.asarray(
        physics.snr_to_noise_power(snr_range, config.data.num_tx), np.float32)

    if _draws is None:
        train_cfg = dataclasses.replace(config.data, channel=channel)
        train_ds = ChannelDataset(train_seed, train_cfg,
                                  norm=config.data.norm_channels)
        num_pilots = int(np.floor(config.data.num_tx * pilot_alpha))
        val_cfg = dataclasses.replace(
            config.data, channel=channel, spacing_list=(spacing,),
            num_channels=max(num_channels, config.data.num_channels))
        val_ds = ChannelDataset(val_seed, val_cfg,
                                norm=list(train_ds.norm_stats),
                                num_pilots=num_pilots)
        g = _generator(seed, 0)
        X = val_ds.hermitian_c2(normalized=True)[:num_channels]
        C = X.shape[0]
        A = cplx.conj_transpose(
            cplx.qpsk_pilots(g, C, config.data.num_tx, num_pilots))
        x_init = cplx.randn(g, X.shape[:-1])  # shared by all combos and SNRs
        Y_sc = physics.measure_c2(g, A.repeat(S, 1, 1, 1),
                                  X.repeat(S, 1, 1, 1),
                                  torch.from_numpy(np.repeat(noise_powers, C)))
    else:
        A, Y_sc, X, x_init = (torch.from_numpy(np.array(t, np.float32))
                              for t in _draws)
        C = X.shape[0]

    G = nA * nB  # grid combos
    reps = (G * S, 1, 1, 1)
    A_b, X_b, x0_b = (t.repeat(*reps) for t in (A, X, x_init))
    Y_b = Y_sc.repeat(G, 1, 1, 1)
    npow_b = torch.from_numpy(np.tile(np.repeat(noise_powers, C), G))
    al_b = torch.from_numpy(np.repeat(np.repeat(alphas, nB), S * C)
                            .astype(np.float32))
    be_b = torch.from_numpy(np.repeat(np.tile(betas, nA), S * C)
                            .astype(np.float32))

    _, trace = langevin_chunked(
        score_fn, A_b, Y_b, sigmas_from_config(config.model), npow_b, x0_b,
        derive_seed(seed, 1), al_b, be_b,
        steps_each=config.sampling.steps_each, oracle2=X_b,
        chunk_size=chunk_size, device=dev, mesh=mesh)
    n_steps = trace.shape[0]
    nmse_log = np.transpose(
        trace.reshape(n_steps, nA, nB, S, C), (1, 2, 3, 0, 4))
    return select(nmse_log, snr_range, alphas, betas)


def main(argv=None):
    """CLI: `tune` with the JAX package's flags (its compilation-cache flag
    has no counterpart) plus --device (reference `tune_hparams_score
    --channel --alpha_step_range --beta_noise_range --pilot_alpha`,
    tune_hparams_score.py:16-25). The network runs in f32, as the JAX
    package's tune does."""
    import argparse

    p = argparse.ArgumentParser(description="Langevin hparam grid search")
    p.add_argument("--channel", type=str, default="CDL-C")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--alpha_step_range", nargs="+", type=float,
                   default=[3e-11, 6e-11, 1e-10, 3e-10])
    p.add_argument("--beta_noise_range", nargs="+", type=float,
                   default=[0.1, 0.01, 0.001])
    p.add_argument("--pilot_alpha", type=float, default=0.6)
    p.add_argument("--spacing", type=float, default=0.5)
    p.add_argument("--snr", nargs="+", type=float, default=None)
    p.add_argument("--num_channels", type=int, default=50)
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--full_log", action="store_true",
                   help="save the full per-step nmse_log (~350 MB) instead "
                        "of the slim selection tables")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; --device cpu runs the "
                        "plain PyTorch path)")
    args = p.parse_args(argv)

    from .estimate import load_score_fn

    dev = resolve_device(args.device)
    ckpt = args.checkpoint or f"models/score/{args.channel}/final_model.npz"
    config, score_fn = load_score_fn(ckpt, dev)

    res = run_hparam_search(
        score_fn, config, channel=args.channel,
        snr_range=np.asarray(args.snr) if args.snr else None,
        alpha_step_range=tuple(args.alpha_step_range),
        beta_noise_range=tuple(args.beta_noise_range),
        spacing=args.spacing, pilot_alpha=args.pilot_alpha,
        num_channels=args.num_channels, chunk_size=args.chunk, device=dev)

    out = args.output or f"results/score/{args.channel}-hyperparameters.npz"
    if args.full_log:
        res.save(out)
    else:
        res.save_slim(out)
    for s, snr in enumerate(res.snr_range):
        db = 10 * np.log10(res.best_nmse[..., s].min())
        print(f"SNR {snr:6.1f} dB  best NMSE {db:7.2f} dB  "
              f"alpha {res.best_alpha_snr[s]:.1e}  "
              f"beta {res.best_beta_snr[s]:.0e}  "
              f"stop {int(res.best_step_snr[s])}")
    b_alpha, b_beta, b_step = res.blind_selection()
    print(f"blind-SNR selection: alpha {b_alpha:.1e}  beta {b_beta:.0e}  "
          f"stop {b_step}")
    print(f"saved {out}")


if __name__ == "__main__":
    main()
