"""Generator statistics against the TR 38.901 tables, the counterpart of
the JAX package's eval/chanstats.py (the `chanstats` command), over the
port's own CDL generator (data/cdl.py).

1. Analytic spatial covariances. For the reference's array (a vertical
   ULA, one polarization, isotropic elements; genChannels.m:13-16) the
   TR 38.901 7.5 coefficient collapses to g = sqrt(P_c/M) exp(j Phi), and
   with i.i.d. uniform ray phases the expected Tx/Rx covariances are
   R = sum_c (P_c/M) sum_m a(theta_cm) a(theta_cm)^H (a LOS row adds one
   specular rank-1 term): table-determined, so any correct generator's
   empirical covariances converge to them.
2. Empirical statistics of generated batches: Tx/Rx eigenspectra,
   effective rank, RMS zenith spread and beamspace compressibility.
3. The relative Frobenius error between the two, and the exact
   Gaussian-prior LMMSE bound per SNR under the analytic covariance.

Everything here is numpy on the host, as in the JAX package.
CLI: `python -m score_based_channels_torch chanstats [--profiles ...]`
writes results/chanstats/summary.npz and prints a comparison table.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Tuple

import numpy as np

from ..data.cdl import CDL_PROFILES, RAY_OFFSETS_PM, generate_cdl_channels


# ---------------------------------------------------------------------------
# analytic TR 38.901 covariances (table-determined ground truth)
# ---------------------------------------------------------------------------

def _ula(theta_rad: np.ndarray, n: int, spacing: float) -> np.ndarray:
    """Vertical-ULA response, matching data/cdl.py:_vertical_ula_response."""
    k = np.arange(n)
    return np.exp(2j * np.pi * spacing * np.cos(theta_rad)[..., None] * k)


def analytic_covariances(
    profile: str, num_rx: int = 16, num_tx: int = 64, spacing: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact E[H H^H]-side covariances implied by the 38.901 CDL tables.

    Returns (R_tx (Nt,Nt), R_rx (Nr,Nr)), each normalized to unit trace.
    """
    prof = CDL_PROFILES[profile]
    rows = prof.rows
    powers = 10.0 ** (rows[:, 1] / 10.0)
    powers = powers / powers.sum()
    deg = np.pi / 180.0
    zod = rows[:, 4] * deg
    zoa = rows[:, 5] * deg
    offs = RAY_OFFSETS_PM  # (M,)
    M = offs.shape[0]

    R_tx = np.zeros((num_tx, num_tx), np.complex128)
    R_rx = np.zeros((num_rx, num_rx), np.complex128)
    for c in range(rows.shape[0]):
        if prof.los and c == 0:
            a_t = _ula(zod[c : c + 1], num_tx, spacing)[0]
            a_r = _ula(zoa[c : c + 1], num_rx, spacing)[0]
            R_tx += powers[c] * np.outer(a_t, a_t.conj())
            R_rx += powers[c] * np.outer(a_r, a_r.conj())
            continue
        th_t = zod[c] + prof.c_zsd * deg * offs
        th_r = zoa[c] + prof.c_zsa * deg * offs
        A_t = _ula(th_t, num_tx, spacing)  # (M, Nt)
        A_r = _ula(th_r, num_rx, spacing)  # (M, Nr)
        R_tx += (powers[c] / M) * (A_t.conj().T @ A_t).T
        R_rx += (powers[c] / M) * (A_r.conj().T @ A_r).T
    R_tx /= np.trace(R_tx).real
    R_rx /= np.trace(R_rx).real
    return R_tx, R_rx


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def eig_stats(R: np.ndarray) -> Dict[str, float]:
    """Eigenspectrum summaries of a (normalized) covariance."""
    lam = np.linalg.eigvalsh(R)[::-1].clip(min=0.0)
    lam = lam / lam.sum()
    pr = 1.0 / np.sum(lam**2)  # participation ratio
    ent = -np.sum(np.where(lam > 0, lam * np.log(lam + 1e-30), 0.0))
    erank = float(np.exp(ent))
    cum = np.cumsum(lam)
    k90 = int(np.searchsorted(cum, 0.90) + 1)
    k99 = int(np.searchsorted(cum, 0.99) + 1)
    return {
        "participation_ratio": float(pr),
        "erank": erank,
        "k90": k90,
        "k99": k99,
        "top1_frac": float(lam[0]),
    }


def rms_zenith_spread_deg(profile: str, side: str) -> float:
    """Power-weighted RMS spread of cos(θ) mapped back to degrees at 90°.

    The vertical ULA senses cos(θ); we report the RMS spread of the ray
    zenith angles themselves (power-weighted, degrees) — comparable to
    the c_ZSD/c_ZSA per-cluster constants plus the cluster geometry.
    """
    prof = CDL_PROFILES[profile]
    rows = prof.rows
    powers = 10.0 ** (rows[:, 1] / 10.0)
    powers = powers / powers.sum()
    col, c_s = (4, prof.c_zsd) if side == "tx" else (5, prof.c_zsa)
    ang, w = [], []
    for c in range(rows.shape[0]):
        if prof.los and c == 0:
            ang.append(np.array([rows[c, col]]))
            w.append(np.array([powers[c]]))
            continue
        ang.append(rows[c, col] + c_s * RAY_OFFSETS_PM)
        w.append(np.full(RAY_OFFSETS_PM.shape[0],
                         powers[c] / RAY_OFFSETS_PM.shape[0]))
    ang = np.concatenate(ang)
    w = np.concatenate(w)
    mu = np.sum(w * ang)
    return float(np.sqrt(np.sum(w * (ang - mu) ** 2)))


def empirical_stats(
    H: np.ndarray,
) -> Dict[str, object]:
    """Statistics of a generated batch H (N, Nr, Nt) complex.

    Returns tx/rx covariances (unit trace), eigen summaries, and
    beamspace compressibility (2-D DFT energy concentration).
    """
    N, Nr, Nt = H.shape
    # E[v v^H] convention (v = a row/column of H), matching
    # analytic_covariances' Σ p·a a^H: R[t,t'] = E[v[t]·v[t']^*]
    Hf = H.reshape(N * Nr, Nt)
    R_tx = (Hf.T @ Hf.conj()) / (N * Nr)
    R_tx /= np.trace(R_tx).real
    Hg = np.transpose(H, (0, 2, 1)).reshape(N * Nt, Nr)
    R_rx = (Hg.T @ Hg.conj()) / (N * Nt)
    R_rx /= np.trace(R_rx).real

    # beamspace: 2-D unitary DFT along both antenna axes, sorted energy
    B = np.fft.fft2(H, axes=(-2, -1), norm="ortho")
    e = np.abs(B) ** 2
    e = e.reshape(N, -1)
    e_sorted = np.sort(e, axis=1)[:, ::-1]
    frac = np.cumsum(e_sorted, axis=1) / e_sorted.sum(axis=1, keepdims=True)
    k90 = float(np.mean(np.argmax(frac >= 0.90, axis=1) + 1))
    k99 = float(np.mean(np.argmax(frac >= 0.99, axis=1) + 1))
    return {
        "R_tx": R_tx, "R_rx": R_rx,
        "tx": eig_stats(R_tx), "rx": eig_stats(R_rx),
        "beam_k90": k90, "beam_k99": k99,
        "beam_total": float(Nr * Nt),
    }


def cov_rel_error(R_emp: np.ndarray, R_ana: np.ndarray) -> float:
    return float(np.linalg.norm(R_emp - R_ana) / np.linalg.norm(R_ana))


# ---------------------------------------------------------------------------
# exact Gaussian-prior LMMSE bound on this distribution
# ---------------------------------------------------------------------------

def analytic_full_covariance(
    profile: str, num_rx: int = 16, num_tx: int = 64, spacing: float = 0.5,
    ray_coupling: str = "random", data_layout: bool = True,
) -> np.ndarray:
    """Exact E[vec(X) vec(X)^H] of X = H^H (Nt, Nr), column-major vec.

    H = sum_{c,m} g_cm a_rx(theta^ZoA_{c,pi_c(m)}) a_tx(theta^ZoD_{c,m})^T
    with i.i.d. uniform ray phases and a per-cluster coupling permutation
    pi_c (TR 38.901 7.5 step 8).

    ray_coupling:
      "random" (the generator's default ensemble, pi_c redrawn per
        realization): averaging over pi_c makes each cluster separable,
        C = sum_c P_c kron(Rbar_rx,c, Rbar_tx,c), Rbar = (1/M) sum_m a a^H.
      "fixed" (pi_c = id, the per-drop ensemble):
        C = sum_c (P_c/M) sum_m kron(a_rx a_rx^H, a_tx a_tx^H).

    data_layout=True conjugates C, the covariance of vec(H^H) as
    ChannelDataset.hermitian() makes it (the LMMSE bound is invariant to
    this; a use against data needs it). Normalized to unit per-entry
    variance (trace Nt*Nr), the loader's global normalization
    (loaders.py:47-49).
    """
    prof = CDL_PROFILES[profile]
    rows = prof.rows
    powers = 10.0 ** (rows[:, 1] / 10.0)
    powers = powers / powers.sum()
    deg = np.pi / 180.0
    zod = rows[:, 4] * deg
    zoa = rows[:, 5] * deg
    offs = RAY_OFFSETS_PM
    M = offs.shape[0]
    n = num_tx * num_rx
    C = np.zeros((n, n), np.complex128)
    for c in range(rows.shape[0]):
        if prof.los and c == 0:
            a_t = _ula(zod[c : c + 1], num_tx, spacing)[0]
            a_r = _ula(zoa[c : c + 1], num_rx, spacing)[0]
            v = np.kron(a_r, a_t)
            C += powers[c] * np.outer(v, v.conj())
            continue
        th_t = zod[c] + prof.c_zsd * deg * offs
        th_r = zoa[c] + prof.c_zsa * deg * offs
        A_t = _ula(th_t, num_tx, spacing)  # (M, Nt)
        A_r = _ula(th_r, num_rx, spacing)  # (M, Nr)
        if ray_coupling == "random":
            Bt = (A_t.T @ A_t.conj()) / M  # Σ_m a a^H / M (row-major a's)
            Br = (A_r.T @ A_r.conj()) / M
            C += powers[c] * np.kron(Br, Bt)
        elif ray_coupling == "fixed":
            V = np.einsum("mr,mt->mrt", A_r, A_t).reshape(M, n)  # kron rows
            C += (powers[c] / M) * (V.T @ V.conj())
        else:
            raise ValueError(ray_coupling)
    C *= n / np.trace(C).real
    return C.conj() if data_layout else C


def lmmse_bound_db(
    profile: str,
    snr_db: np.ndarray,
    num_pilots: int = 38,
    num_rx: int = 16,
    num_tx: int = 64,
    spacing: float = 0.5,
    num_pilot_draws: int = 4,
    seed: int = 0,
    ray_coupling: str = "random",
) -> np.ndarray:
    """Exact LMMSE NMSE [dB] per SNR under the analytic CDL covariance.

    The pipeline's measurement model (test_score.py:122-124): Y = A X + N,
    A = conj(P)^T (Np, Nt) QPSK pilots, noise power 10^(-SNR/10) Nt per
    complex entry, X at unit entry variance. Among priors with covariance
    C the Gaussian has the largest MMSE and the linear estimator attains
    it: this is the genie covariance-aware Gaussian estimator's NMSE on
    this distribution, averaged over `num_pilot_draws` pilot draws.
    ray_coupling selects the ensemble (see analytic_full_covariance).
    """
    C = analytic_full_covariance(profile, num_rx, num_tx, spacing,
                                 ray_coupling=ray_coupling)
    n = num_tx * num_rx
    rng = np.random.default_rng(seed)
    noise = 10.0 ** (-np.asarray(snr_db, np.float64) / 10.0) * num_tx
    tr_C = np.trace(C).real
    out = np.zeros((len(noise),))
    for _ in range(num_pilot_draws):
        P = (rng.choice([-1.0, 1.0], (num_tx, num_pilots))
             + 1j * rng.choice([-1.0, 1.0], (num_tx, num_pilots))) / np.sqrt(2)
        A = P.conj().T  # (Np, Nt)
        Mop = np.kron(np.eye(num_rx), A)  # (Np·Nr, n) column-major vec
        CM = C @ Mop.conj().T  # (n, m)
        G = Mop @ CM  # (m, m)
        for i, s2 in enumerate(noise):
            Gy = G + s2 * np.eye(G.shape[0])
            sol = np.linalg.solve(Gy, CM.conj().T)  # (m, n)
            mmse = tr_C - np.trace(CM @ sol).real
            out[i] += mmse / tr_C
    out /= num_pilot_draws
    return 10.0 * np.log10(out)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="CDL generator statistics vs TR 38.901 analytic tables")
    p.add_argument("--profiles", nargs="+",
                   default=["CDL-A", "CDL-B", "CDL-C", "CDL-D"])
    p.add_argument("--num_channels", type=int, default=2000)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--spacing", type=float, default=0.5)
    p.add_argument("--output", type=str, default="results/chanstats")
    p.add_argument("--lmmse", action="store_true",
                   help="also compute the exact Gaussian-prior LMMSE NMSE "
                        "bound per SNR (genie covariance estimator)")
    p.add_argument("--snr", type=float, nargs="+",
                   default=[-10, -5, 0, 5, 10, 15, 20, 25, 30])
    p.add_argument("--num_pilots", type=int, default=38)
    args = p.parse_args(argv)

    os.makedirs(args.output, exist_ok=True)
    rows = {}
    hdr = (f"{'profile':8s} {'side':3s} {'erank emp':>9s} {'erank ana':>9s} "
           f"{'k90 emp':>7s} {'k90 ana':>7s} {'top1 emp':>8s} {'top1 ana':>8s} "
           f"{'covErr':>7s} {'rmsZS°':>7s}")
    print(hdr)
    print("-" * len(hdr))
    for prof in args.profiles:
        H = generate_cdl_channels(
            args.seed, prof, num_channels=args.num_channels,
            spacing=args.spacing)[:, 0]  # subcarrier 0, like loaders.py:33
        emp = empirical_stats(H)
        R_tx_a, R_rx_a = analytic_covariances(prof, spacing=args.spacing)
        ana = {"tx": eig_stats(R_tx_a), "rx": eig_stats(R_rx_a)}
        err = {"tx": cov_rel_error(emp["R_tx"], R_tx_a),
               "rx": cov_rel_error(emp["R_rx"], R_rx_a)}
        for side, R_a in (("tx", R_tx_a), ("rx", R_rx_a)):
            e, a = emp[side], ana[side]
            print(f"{prof:8s} {side:3s} {e['erank']:9.2f} {a['erank']:9.2f} "
                  f"{e['k90']:7d} {a['k90']:7d} {e['top1_frac']:8.3f} "
                  f"{a['top1_frac']:8.3f} {err[side]:7.3f} "
                  f"{rms_zenith_spread_deg(prof, side):7.2f}")
        print(f"{prof:8s} beamspace: mean #beams for 90%/99% energy = "
              f"{emp['beam_k90']:.1f}/{emp['beam_k99']:.1f} of "
              f"{int(emp['beam_total'])}")
        rows[prof] = {
            "emp_tx": emp["tx"], "emp_rx": emp["rx"],
            "ana_tx": ana["tx"], "ana_rx": ana["rx"],
            "cov_err_tx": err["tx"], "cov_err_rx": err["rx"],
            "beam_k90": emp["beam_k90"], "beam_k99": emp["beam_k99"],
            "R_tx_emp": emp["R_tx"], "R_tx_ana": R_tx_a,
            "R_rx_emp": emp["R_rx"], "R_rx_ana": R_rx_a,
        }
        if args.lmmse:
            snr = np.asarray(args.snr, np.float64)
            bound = lmmse_bound_db(prof, snr, num_pilots=args.num_pilots,
                                   spacing=args.spacing)
            rows[prof]["lmmse_snr_db"] = snr
            rows[prof]["lmmse_nmse_db"] = bound
            line = "  ".join(f"{s:g}:{b:6.2f}" for s, b in zip(snr, bound))
            print(f"{prof:8s} LMMSE bound NMSE[dB] (genie Gaussian, "
                  f"{args.num_pilots} pilots): {line}")
    out = os.path.join(args.output, "summary.npz")
    np.savez(out, **{
        f"{prof}/{k}": v for prof, d in rows.items() for k, v in d.items()
        if isinstance(v, (int, float, np.ndarray))
    })
    print(f"saved {out}")


if __name__ == "__main__":
    main()
