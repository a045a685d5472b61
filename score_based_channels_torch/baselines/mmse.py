"""Approximate-MMSE estimation by posterior-sample averaging, the
counterpart of the JAX package's baselines/mmse.py (the `mmse` command,
reference test_mmse.py).

Each validation channel is tiled x`mmse_avg` posterior samples
(test_mmse.py:104,181-192), the annealed-Langevin sampler runs from a
chosen initialization (noise / adjoint / LS / LMMSE, test_mmse.py:195-202)
with per-SNR hyper-parameters and early stopping, and the posterior
samples are averaged into the MMSE estimate. The {samples x SNR x
channels} product is one flattened batch, row r*(S*C) + s*C + c.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import cplx, physics
from .._device import resolve_device
from ..config import Config
from ..data.dataset import ChannelDataset
from ..diffusion.sigmas import sigmas_from_config
from ..eval.estimate import _generator, derive_seed, langevin_chunked
from .ls import ls_estimate


@dataclasses.dataclass
class MMSEResults:
    nmse_mean_est: np.ndarray  # (n_snr, n_channels) NMSE of the posterior mean
    nmse_single: np.ndarray  # (n_snr, n_channels) NMSE of a single sample
    snr_range: np.ndarray
    mmse_avg: int

    def avg_db(self) -> np.ndarray:
        return 10 * np.log10(self.nmse_mean_est.mean(-1))

    def save(self, path: str) -> None:
        import os

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **dataclasses.asdict(self))


def auto_coef_cap(A2: torch.Tensor) -> np.ndarray:
    """0.5/lambda_max(A^H A) per channel, the beta = 1 stability cap of the
    data-consistency coefficient (the JAX package's mmse.py:159-170),
    from numpy's eigvalsh on the host: (C, Np, Nt, 2) -> (C,) float32."""
    A_np = A2.cpu().numpy()
    Ac = A_np[..., 0] + 1j * A_np[..., 1]
    lam = np.linalg.eigvalsh(np.einsum("cpi,cpj->cij", Ac.conj(), Ac))[:, -1]
    return (0.5 / lam).astype(np.float32)


def run_mmse_estimation(
    score_fn,
    config: Config,
    channel: str = "CDL-C",
    snr_range: Optional[np.ndarray] = None,
    pilot_alpha: float = 0.6,
    spacing: float = 0.5,
    num_channels: int = 20,
    mmse_avg: int = 50,
    init: str = "noise",  # {noise, adjoint, ls, lmmse} (test_mmse.py:195-202)
    alpha_step=None,
    beta_noise=None,
    stop_step: Optional[np.ndarray] = None,  # per-SNR early stop (int)
    train_seed: int = 1234,
    val_seed: int = 4321,
    seed: int = 31,
    chunk_size: Optional[int] = None,
    sigma_start: Optional[float] = None,
    coef_cap=None,
    device=None,
    _draws: Optional[Tuple[np.ndarray, ...]] = None,
) -> MMSEResults:
    """The JAX package's run_mmse_estimation on `device` (None: the card).

    init="lmmse" + sigma_start is the warm-start protocol: chains start at
    the exact LMMSE estimate (train-set empirical covariance) on the
    schedule truncated to sigma <= sigma_start. coef_cap: None (the
    reference rule), a number, or "auto" (auto_coef_cap). stop_step (per
    SNR, in trailing steps) becomes the capture level stop_step //
    steps_each. Pilots, measurement noise, the noise init and the warm
    inits' 0.01 randn perturbation come from a CPU generator seeded by
    (seed, 0); chunk k's Langevin noise from (derive_seed(seed, 1), first
    row of chunk k). The last chunk is padded to a whole chunk, by more
    rows than the batch holds where the chunk is larger.

    _draws: (A (C,Np,Nt,2), Y (S*C,Np,Nr,2), X (C,Nt,Nr,2), z
    (R*S*C,Nt,Nr,2)) given instead of drawn (the parity tests pass the JAX
    package's); z is the noise init, or the standard normal draw that
    0.01 scales for a warm init. Then no validation set is built.
    """
    dev = resolve_device(device)
    cfg = config
    if snr_range is None:
        snr_range = np.arange(-10, 32.5, 2.5)
    snr_range = np.asarray(snr_range, np.float64)
    sampling = cfg.sampling
    alpha_step = sampling.alpha_step if alpha_step is None else alpha_step
    beta_noise = sampling.beta_noise if beta_noise is None else beta_noise
    S = len(snr_range)
    R = mmse_avg

    def per_sample(hp):
        """scalar or per-SNR (S,) value -> (R*S*C,) per sample."""
        hp = np.asarray(hp, np.float32)
        if hp.ndim == 0:
            return hp
        if hp.shape != (S,):
            raise ValueError(f"a per-SNR hyper-parameter needs {S} values, "
                             f"got shape {hp.shape}")
        return np.tile(np.repeat(hp, C), R)

    train_cfg = dataclasses.replace(cfg.data, channel=channel)
    train_ds = ChannelDataset(train_seed, train_cfg, norm="global")

    sigmas = sigmas_from_config(cfg.model)
    if sigma_start is not None:
        k0 = int(np.searchsorted(-sigmas.numpy(), -float(sigma_start)))
        if k0 >= sigmas.shape[0]:
            raise ValueError(f"sigma_start={sigma_start} truncates the "
                             "whole schedule")
        sigmas = sigmas[k0:]

    noise_powers = np.asarray(
        physics.snr_to_noise_power(snr_range, cfg.data.num_tx), np.float32)
    if _draws is None:
        num_pilots = int(np.floor(cfg.data.num_tx * pilot_alpha))
        val_cfg = dataclasses.replace(
            cfg.data, channel=channel, spacing_list=(spacing,),
            num_channels=max(num_channels, cfg.data.num_channels))
        val_ds = ChannelDataset(val_seed, val_cfg,
                                norm=list(train_ds.norm_stats),
                                num_pilots=num_pilots)
        g = _generator(seed, 0)
        X2 = val_ds.hermitian_c2()[:num_channels]  # (C, Nt, Nr, 2)
        C = X2.shape[0]
        A2 = cplx.conj_transpose(
            cplx.qpsk_pilots(g, C, cfg.data.num_tx, num_pilots))
        Y_sc = physics.measure_c2(
            g, A2.repeat(S, 1, 1, 1), X2.repeat(S, 1, 1, 1),
            torch.from_numpy(np.repeat(noise_powers, C)))
        z = cplx.randn(g, (R * S * C,) + X2.shape[1:-1])
    else:
        A2, Y_sc, X2, z = (torch.from_numpy(np.array(t, np.float32))
                           for t in _draws)
        C = X2.shape[0]
    npow_sc = np.repeat(noise_powers, C)
    A_sc = A2.repeat(S, 1, 1, 1)

    # tile xR posterior samples: batch index = r*(S*C) + s*C + c
    A_b = A_sc.repeat(R, 1, 1, 1)
    Y_b = Y_sc.repeat(R, 1, 1, 1)
    npow_b = torch.from_numpy(np.tile(npow_sc, R))

    if init == "noise":
        x0_b = z
    elif init == "adjoint":
        x0_b = cplx.matmul(cplx.conj_transpose(A_b), Y_b)
    elif init == "ls":
        x0_b = ls_estimate(A_b.to(dev), Y_b.to(dev), npow_b.to(dev)).cpu()
    elif init == "lmmse":
        # solve only the S*C distinct systems, then tile across the replicas
        from .lmmse import empirical_covariance, lmmse_estimate_c2

        cov = empirical_covariance(train_ds)
        x0_sc, _ = lmmse_estimate_c2(A_sc, Y_sc, npow_sc, cov)
        x0_b = torch.from_numpy(x0_sc).repeat(R, 1, 1, 1)
    else:
        raise ValueError(init)
    if init != "noise":
        # posterior samples still need distinct starts: perturb the init
        x0_b = x0_b + cplx.scale(z, 0.01)

    cap_coef = None
    if coef_cap == "auto":
        cap_coef = np.tile(auto_coef_cap(A2), S * R)
    elif coef_cap is not None:
        cap_coef = float(coef_cap)
    cap_lvl = None
    if stop_step is not None:
        lvls = np.asarray(stop_step, np.int64) // sampling.steps_each
        cap_lvl = np.tile(np.repeat(np.broadcast_to(lvls, (S,)), C), R)

    xf, _ = langevin_chunked(
        score_fn, A_b, Y_b, sigmas, npow_b, x0_b, derive_seed(seed, 1),
        per_sample(alpha_step), per_sample(beta_noise),
        steps_each=sampling.steps_each, chunk_size=chunk_size,
        capture_level=cap_lvl, coef_cap=cap_coef, device=dev)
    xf = cplx.from_complex(xf).reshape(R, S, C, *X2.shape[1:])

    mean_est = xf.mean(dim=0)  # posterior mean (S, C, Nt, Nr, 2)
    nmse_mean = cplx.nmse(mean_est, X2.expand_as(mean_est)).numpy()
    nmse_single = cplx.nmse(xf[0], X2.expand_as(xf[0])).numpy()
    return MMSEResults(nmse_mean_est=nmse_mean, nmse_single=nmse_single,
                       snr_range=snr_range, mmse_avg=mmse_avg)


def main(argv=None):
    """CLI: `mmse` with the JAX package's flags (its compilation-cache flag
    has no counterpart) plus --device."""
    import argparse

    p = argparse.ArgumentParser(
        description="Approximate MMSE via posterior-sample averaging")
    p.add_argument("--train", type=str, default="CDL-C")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--snr", nargs="+", type=float, default=None)
    p.add_argument("--num_channels", type=int, default=20)
    p.add_argument("--mmse_avg", type=int, default=50)
    p.add_argument("--init", type=str, default="noise",
                   choices=["noise", "adjoint", "ls", "lmmse"])
    p.add_argument("--alpha_step", type=float, default=None)
    p.add_argument("--chat", type=float, default=None,
                   help="set alpha_step = chat*sigma_end^2, i.e. the "
                        "per-level step alpha_i = chat*sigma_i^2 (use with "
                        "--coef_cap auto)")
    p.add_argument("--beta_noise", type=float, default=None)
    p.add_argument("--sigma_start", type=float, default=None,
                   help="truncate the sigma schedule to sigma <= this "
                        "(warm-start protocol; use with --init lmmse)")
    p.add_argument("--coef_cap", type=str, default=None,
                   help="data-consistency coefficient cap: 'auto' = "
                        "0.5/lambda_max(A^H A) per channel (required for "
                        "beta=1 noise-init chains), or a float, or omit for "
                        "the reference rule")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="network compute dtype (the Langevin state stays f32)")
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; --device cpu runs the "
                        "plain PyTorch path)")
    args = p.parse_args(argv)

    from ..eval.estimate import load_score_fn

    dev = resolve_device(args.device)
    ckpt = args.checkpoint or f"models/score/{args.train}/final_model.npz"
    config, score_fn = load_score_fn(ckpt, dev,
                                     dtype=getattr(torch, args.dtype))

    alpha_step = args.alpha_step
    if args.chat is not None:
        if alpha_step is not None:
            p.error("--chat and --alpha_step are mutually exclusive")
        alpha_step = float(args.chat) * float(
            sigmas_from_config(config.model)[-1]) ** 2

    res = run_mmse_estimation(
        score_fn, config, channel=args.train,
        snr_range=np.asarray(args.snr) if args.snr else None,
        num_channels=args.num_channels, mmse_avg=args.mmse_avg,
        init=args.init, alpha_step=alpha_step,
        beta_noise=args.beta_noise, chunk_size=args.chunk,
        sigma_start=args.sigma_start,
        coef_cap=(args.coef_cap if args.coef_cap in (None, "auto")
                  else float(args.coef_cap)), device=dev)
    for s, snr in enumerate(res.snr_range):
        print(f"SNR {snr:6.1f} dB  MMSE-avg NMSE {res.avg_db()[s]:7.2f} dB  "
              f"(single sample "
              f"{10 * np.log10(res.nmse_single.mean(-1)[s]):7.2f} dB)")
    # the effective beta names the default file (an unset --beta_noise is
    # the config's)
    beta_eff = (args.beta_noise if args.beta_noise is not None
                else config.sampling.beta_noise)
    out = args.output or (f"results/mmse/{args.train}-{args.init}"
                          f"-beta{beta_eff}.npz")
    res.save(out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
