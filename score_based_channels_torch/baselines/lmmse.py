"""Linear-MMSE (Wiener) channel estimator, the counterpart of
the JAX package's baselines/lmmse.py (the `lmmse` command).

    x_hat = C M^H (M C M^H + sigma^2 I)^-1 y,   M = I_{Nr} (x) A,  A = conj(P)^T

Dense per-sample solves (complex128, Np*Nr = 608 rows at 38 pilots) are a
host LAPACK workload, as in the JAX package; they run in numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def empirical_covariance(train_ds) -> np.ndarray:
    """E[v v^H] of v = vec_F(normalised H^H) over the training set
    (column-major vec over (Nt, Nr)); complex128."""
    H = np.asarray(train_ds.hermitian(normalized=True))
    V = H.reshape(H.shape[0], -1, order="F")
    return (V.T @ V.conj()) / V.shape[0]


def analytic_covariance(profile: str, num_rx: int = 16, num_tx: int = 64,
                        spacing: float = 0.5) -> np.ndarray:
    """The analytic covariance in the data layout, "random" ray coupling
    (eval/chanstats.py::analytic_full_covariance)."""
    from ..eval.chanstats import analytic_full_covariance

    return analytic_full_covariance(profile, num_rx, num_tx, spacing,
                                    ray_coupling="random", data_layout=True)


def lmmse_estimate(A: np.ndarray, Y: np.ndarray, noise_power: np.ndarray,
                   Cov: np.ndarray, predict_mmse: bool = False
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Batched exact LMMSE. A (B, Np, Nt), Y (B, Np, Nr) complex,
    noise_power (B,), Cov (Nt*Nr, Nt*Nr) in vec_F layout. Returns
    (x_hat (B, Nt, Nr) complex64, predicted per-sample NMSE (B,) or None)."""
    B, Np_, Nt = A.shape
    Nr = Y.shape[2]
    n = Nt * Nr
    m = Np_ * Nr
    C4 = np.ascontiguousarray(Cov.reshape(Nt, Nr, Nt, Nr, order="F"))
    noise_power = np.broadcast_to(np.asarray(noise_power, np.float64), (B,))
    xhat = np.zeros((B, Nt, Nr), np.complex64)
    pred = np.zeros((B,), np.float64) if predict_mmse else None
    tr_C = np.trace(Cov).real
    eye = np.eye(m)
    for i in range(B):
        Ai = A[i]
        # C M^H [t,r | q,s] = sum_u C4[t,r,u,s] conj(A[q,u])
        CMh = np.einsum("trus,qu->trqs", C4, Ai.conj(), optimize=True)
        # G0 [p,r | q,s] = sum_t A[p,t] C M^H[t,r,q,s]
        G0 = np.einsum("pt,trqs->prqs", Ai, CMh, optimize=True)
        G = G0.reshape(m, m, order="F") + noise_power[i] * eye
        CMh = CMh.reshape(n, m, order="F")
        y = Y[i].reshape(-1, order="F")
        if predict_mmse:
            sol = np.linalg.solve(G, np.concatenate(
                [y[:, None], CMh.conj().T], axis=1))
            w, S = sol[:, 0], sol[:, 1:]
            pred[i] = (tr_C - np.sum(CMh.T * S).real) / tr_C
        else:
            w = np.linalg.solve(G, y)
        xhat[i] = (CMh @ w).reshape(Nt, Nr, order="F")
    return xhat, pred


def lmmse_estimate_c2(A2, Y2, noise_power, Cov, predict_mmse: bool = False):
    """c2 wrapper: c2 tensors or arrays in -> (x_hat c2 float32 ndarray,
    pred)."""
    def host(t):
        return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)

    A, Y = host(A2), host(Y2)
    xh, pred = lmmse_estimate(
        A[..., 0] + 1j * A[..., 1], Y[..., 0] + 1j * Y[..., 1],
        host(noise_power), Cov, predict_mmse=predict_mmse)
    return np.stack([xh.real, xh.imag], axis=-1).astype(np.float32), pred


def main(argv=None):
    """CLI: `lmmse` with the JAX package's flags plus --device: the
    measurements are made on the device (None: the card), the dense solves
    on the host. Pilots come from a CPU generator seeded by (seed, 0), the
    noise of SNR point s from (seed, 1, s)."""
    import argparse
    import os

    from .. import cplx, physics
    from .._device import resolve_device
    from ..config import Config
    from ..data.dataset import ChannelDataset
    from ..eval.estimate import _generator

    p = argparse.ArgumentParser(
        description="Exact LMMSE baseline (empirical or analytic covariance)")
    p.add_argument("--train", type=str, default="CDL-C",
                   help="profile fixing normalization + covariance")
    p.add_argument("--test", type=str, default=None,
                   help="evaluated profile (default = --train)")
    p.add_argument("--cov", type=str, default="empirical",
                   choices=["empirical", "analytic"])
    p.add_argument("--snr", nargs="+", type=float, default=None)
    p.add_argument("--num_channels", type=int, default=100)
    p.add_argument("--pilot_alpha", type=float, default=0.6)
    p.add_argument("--spacing", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=2023)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--ray_coupling", type=str, default=None,
                   choices=["random", "fixed"],
                   help="dataset ensemble override (fixed = the "
                        "paper-matching per-drop coupling)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the measurements (default: cuda; "
                        "--device cpu runs on the CPU)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    test = args.test or args.train
    snr_range = (np.asarray(args.snr, np.float64) if args.snr
                 else np.arange(-10, 32.5, 2.5))
    cfg = Config()
    if args.ray_coupling:
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, ray_coupling=args.ray_coupling))
    train_cfg = dataclasses.replace(cfg.data, channel=args.train)
    train_ds = ChannelDataset(1234, train_cfg, norm="global")
    num_pilots = int(np.floor(cfg.data.num_tx * args.pilot_alpha))
    val_cfg = dataclasses.replace(
        cfg.data, channel=test, spacing_list=(args.spacing,),
        num_channels=max(args.num_channels, cfg.data.num_channels))
    val_ds = ChannelDataset(4321, val_cfg, norm=list(train_ds.norm_stats),
                            num_pilots=num_pilots)

    Cov = (empirical_covariance(train_ds) if args.cov == "empirical"
           else analytic_covariance(args.train, spacing=args.spacing))

    X2 = val_ds.hermitian_c2(normalized=True)[:args.num_channels]
    C = X2.shape[0]
    A2 = cplx.conj_transpose(cplx.qpsk_pilots(
        _generator(args.seed, 0), C, cfg.data.num_tx, num_pilots)).to(dev)
    X2 = X2.to(dev)
    X_np = val_ds.hermitian(normalized=True)[:args.num_channels]
    den = (np.abs(X_np) ** 2).sum((-1, -2))

    S = len(snr_range)
    npow = np.asarray(physics.snr_to_noise_power(snr_range, cfg.data.num_tx))
    results = np.zeros((S, C))
    predicted = np.zeros((S,))
    for s in range(S):
        Y2 = physics.measure_c2(_generator(args.seed, 1, s), A2, X2,
                                torch.full((C,), float(npow[s])))
        xh2, pred = lmmse_estimate_c2(A2, Y2, np.full((C,), npow[s]), Cov,
                                      predict_mmse=True)
        xh = xh2[..., 0] + 1j * xh2[..., 1]
        results[s] = (np.abs(xh - X_np) ** 2).sum((-1, -2)) / den
        predicted[s] = pred.mean()
        print(f"SNR {snr_range[s]:6.1f} dB  LMMSE NMSE "
              f"{10 * np.log10(results[s].mean()):7.2f} dB  "
              f"(predicted {10 * np.log10(predicted[s]):7.2f} dB)",
              flush=True)
    out = args.output or f"results/lmmse/{args.train}-{test}-{args.cov}.npz"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez(out, nmse=results, predicted=predicted, snr_range=snr_range)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
