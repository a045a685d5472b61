"""End-to-end coded link simulation (reference matlab/test_end_to_end.m +
testPackets.m), the counterpart of the JAX package's comms/link.py.

Per packet (testPackets.m): LDPC-encode 324 info bits -> 648 coded bits ->
interleave -> QPSK (324 symbols) -> Ns=4 spatial streams x 81 symbol slots
-> random Gaussian precoding V in C^{Nt x Ns} (testPackets.m:87-94) ->
channel H in C^{Nr x Nt} -> y = H V s + n. The receiver computes MIMO LLRs
(ComputeLLRMIMO 'ml' by default) with either the TRUE H or an ESTIMATED H
(test_end_to_end.m:13-26 loads saved estimates), de-interleaves, decodes
and logs BER / BLER for both CSI modes.

Bits, the encoder and the interleaver are numpy on the host, as in the JAX
package, so both packages send the same codewords. The precoder V and the
noise w are drawn on the device from a `torch.Generator`; `draws` injects
them instead (the parity tests pass the JAX package's draws). Detection
and decoding run on the device, the decoder through the CUDA kernel of
kernels/ldpc_minsum.py on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import cplx
from .._device import resolve_device
from .ldpc import LDPCCode, make_wifi_ldpc, minsum_decode
from .mimo import mimo_kbest_llr, mimo_ml_llr, mimo_zf_sic_llr
from .modulation import qpsk_modulate


@dataclasses.dataclass
class LinkResults:
    snr_range: np.ndarray
    ber_ideal: np.ndarray  # (n_snr,)
    ber_est: np.ndarray
    bler_ideal: np.ndarray
    bler_est: np.ndarray

    def save(self, path: str) -> None:
        import os

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **dataclasses.asdict(self))


def _interleaver(n: int, seed: int = 11) -> np.ndarray:
    """Fixed-seed random interleaver: the reference's `rng(inter_seed);
    P = randperm(N)` (testPackets.m:96-99) with numpy's generator, the
    same permutation as the JAX package's."""
    return np.random.default_rng(seed).permutation(n)


def simulate_packets(
    generator: Optional[torch.Generator],
    H_true2: torch.Tensor,  # (B, Nr, Nt, 2) true channels (one per packet)
    H_est2: torch.Tensor,  # (B, Nr, Nt, 2) estimated channels
    snr_db: float,
    code: LDPCCode,
    n_streams: int = 4,
    num_bp_iters: int = 25,
    max_log: bool = False,
    detector: str = "ml",  # ComputeLLRMIMO.m mode: ml | kbest | zf-sic
    seed: int = 5,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[dict, dict]:
    """One SNR point over a batch of packets -> (ideal-CSI, est-CSI) stats,
    on H_true2's device.

    generator: draws V (B, Nt, Ns, 2) and then w (B, L, Nr, 2), unit-power
    c2, on its device. draws: (V, w) given instead (then generator may be
    None); V is used as given, scaled by 1/sqrt(Nt) as a drawn one is.
    """
    B, Nr, Nt, _ = H_true2.shape
    dev = H_true2.device
    n, k = code.n, code.k
    n_sym = n // 2
    if n_sym % n_streams:
        raise ValueError(f"{n_sym} QPSK symbols do not fill {n_streams} "
                         "streams evenly")
    L = n_sym // n_streams  # symbol slots per packet

    bits_rng = np.random.default_rng(seed + int(snr_db * 10) % 97)
    bits = bits_rng.integers(0, 2, size=(B, k), dtype=np.uint8)
    cw = code.encode(bits)  # (B, n)
    perm = _interleaver(n)
    syms = qpsk_modulate(torch.from_numpy(cw[:, perm]).to(dev))
    s = syms.reshape(B, L, n_streams, 2)  # slot layout

    if draws is None:
        V = cplx.randn(generator, (B, Nt, n_streams))
        w = cplx.randn(generator, (B, L, Nr))
    else:
        V, w = (d.to(dev, torch.float32) for d in draws)
    # random Gaussian precoding, unit average column power
    V = V * np.float32(1.0 / np.sqrt(Nt))
    Heff_true = cplx.matmul(H_true2, V)  # (B, Nr, Ns, 2)
    Heff_est = cplx.matmul(H_est2, V)

    # transmit: y (B, L, Nr, 2) = s @ Heff^T + n
    y = cplx.matmul(s, cplx.transpose(Heff_true))
    # per-component noise from the SNR against unit-power symbols through
    # the normalised precoder: signal power per rx antenna ~ |Heff row|^2/Ns
    sig_pow = cplx.abs2(Heff_true).mean() * n_streams
    noise_pow = sig_pow * 10.0 ** (-snr_db / 10.0)
    y = y + w * torch.sqrt(noise_pow)

    perm_t = torch.from_numpy(perm).to(dev)
    out = {}
    for name, Heff in (("ideal", Heff_true), ("est", Heff_est)):
        if detector == "ml":
            llr = mimo_ml_llr(y, Heff, noise_pow / 2.0, n_streams=n_streams,
                              max_log=max_log)  # (B, L, 2Ns)
        elif detector == "kbest":
            llr = mimo_kbest_llr(y, Heff, noise_pow / 2.0,
                                 n_streams=n_streams)
        elif detector == "zf-sic":
            llr = mimo_zf_sic_llr(y, Heff, noise_pow / 2.0,
                                  n_streams=n_streams)
        else:
            raise ValueError(f"unknown detector {detector!r}")
        llr_flat = llr.reshape(B, n)
        llr_d = torch.empty_like(llr_flat)  # de-interleave
        llr_d[:, perm_t] = llr_flat
        bits_hat, _ = minsum_decode(llr_d, code.H, num_iters=num_bp_iters)
        # info bits live at code.perm[:k] positions of the codeword
        info_hat = bits_hat.cpu().numpy()[:, code.perm[:k]]
        bit_errs = (info_hat != bits).sum(-1)
        out[name] = {
            "ber": float(bit_errs.sum()) / (B * k),
            "bler": float((bit_errs > 0).mean()),
        }
    return out["ideal"], out["est"]


def _c2(H, device) -> torch.Tensor:
    """Complex (..., Nr, Nt) array (or any (B, Nr, Nt) one) or c2
    (..., Nr, Nt, 2) -> c2 float32 on `device`."""
    if torch.is_tensor(H):
        return H.to(device, torch.float32)
    H = np.asarray(H)
    t = (cplx.from_complex(H) if np.iscomplexobj(H) or H.ndim == 3
         else torch.from_numpy(H.astype(np.float32)))
    return t.to(device)


def run_link_simulation(
    H_true,  # (B, Nr, Nt) complex or (B, Nr, Nt, 2) c2
    H_est,  # the same, or (S, B, Nr, Nt[, 2]): one estimate per SNR
    snr_range=np.arange(-10, 12.5, 2.5),
    n_streams: int = 4,
    num_bp_iters: int = 25,
    detector: str = "ml",
    seed: int = 0,
    device=None,
) -> LinkResults:
    """BER/BLER sweep with ideal vs estimated CSI (test_end_to_end.m:38-60)
    on `device` (None: the card). SNR point i draws from a generator
    seeded by (seed, i)."""
    from ..eval.estimate import derive_seed

    dev = resolve_device(device)
    code = make_wifi_ldpc()
    H_true2 = _c2(H_true, dev)
    H_est2 = _c2(H_est, dev)
    per_snr_est = H_est2.dim() == 5  # (S, B, Nr, Nt, 2): SNR-matched
    bi, be, li, le = [], [], [], []
    for i, snr in enumerate(np.asarray(snr_range, np.float64)):
        gen = torch.Generator(device=dev).manual_seed(derive_seed(seed, i))
        ideal, est = simulate_packets(
            gen, H_true2, H_est2[i] if per_snr_est else H_est2, float(snr),
            code, n_streams=n_streams, num_bp_iters=num_bp_iters,
            detector=detector)
        bi.append(ideal["ber"])
        be.append(est["ber"])
        li.append(ideal["bler"])
        le.append(est["bler"])
    return LinkResults(
        snr_range=np.asarray(snr_range, np.float64),
        ber_ideal=np.asarray(bi), ber_est=np.asarray(be),
        bler_ideal=np.asarray(li), bler_est=np.asarray(le))


def main(argv=None):
    """CLI: coded BER/BLER with estimated vs ideal CSI
    (test_end_to_end.m:38-60: estimation and data SNRs are matched), on
    the card unless `--device cpu`."""
    import argparse

    p = argparse.ArgumentParser(description="End-to-end coded link sim")
    p.add_argument("--channels", type=str, required=True,
                   help="npz from `estimate --save_channels` (est_* and "
                        "oracle_* arrays)")
    p.add_argument("--spacing_idx", type=int, default=0)
    p.add_argument("--alpha_idx", type=int, default=0)
    p.add_argument("--snr", nargs="+", type=float, default=None,
                   help="subset of the estimation SNR grid to simulate")
    p.add_argument("--streams", type=int, default=4)
    p.add_argument("--bp_iters", type=int, default=25)
    p.add_argument("--detector", type=str, default="ml",
                   choices=["ml", "kbest", "zf-sic"],
                   help="soft demapper (ComputeLLRMIMO.m mode): exact-ML "
                        "enumeration, K-best tree search, or ZF-SIC")
    p.add_argument("--output", type=str, default=None,
                   help="default results/link/results.npz")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; --device cpu runs the "
                        "plain PyTorch path)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    with np.load(args.channels) as f:
        tag = f"sp{args.spacing_idx}_al{args.alpha_idx}"
        est = f[f"est_{tag}"]  # (S, C, Nt, Nr) complex, Hermitian view
        oracle = f[f"oracle_{tag}"]  # (C, Nt, Nr)
        snr_grid = f["snr_range"]

    # Hermitian -> physical H (C, Nr, Nt)
    H_true = np.conj(np.swapaxes(oracle, -1, -2))
    H_est = np.conj(np.swapaxes(est, -1, -2))  # (S, C, Nr, Nt)

    if args.snr is not None:
        sel = [int(np.argmin(np.abs(snr_grid - s))) for s in args.snr]
        snr_grid = snr_grid[sel]
        H_est = H_est[sel]

    res = run_link_simulation(
        H_true, cplx.from_complex(H_est), snr_range=snr_grid,
        n_streams=args.streams, num_bp_iters=args.bp_iters,
        detector=args.detector, device=dev)
    for i, snr in enumerate(res.snr_range):
        print(f"SNR {snr:6.1f} dB  BER ideal {res.ber_ideal[i]:.4f} "
              f"est {res.ber_est[i]:.4f}  BLER ideal {res.bler_ideal[i]:.3f} "
              f"est {res.bler_est[i]:.3f}")
    out = args.output or "results/link/results.npz"
    res.save(out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
