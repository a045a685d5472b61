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

The JAX package jits the detector and the decode with its scan
(comms/mimo.py:36, comms/ldpc.py:199, :252). Here `LinkReceiver` runs a
CSI mode's receiver (detector, de-interleave, decode) on static buffers:
on the card one CUDA graph, captured at its second call and replayed for
both CSI modes at every SNR point of a sweep.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _graph, cplx
from .._device import resolve_device
from .ldpc import LDPCCode, MinsumDecoder, make_wifi_ldpc
from .mimo import (
    detector_tables, mimo_kbest_llr, mimo_ml_llr, mimo_zf_sic_llr,
)
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


class LinkReceiver:
    """One CSI mode's receiver for `batch` packets on static buffers: y
    (B, L, Nr, 2), Heff (B, Nr, Ns, 2) and the 0-d noise variance in; the
    detector (with its `detector_tables`, built once), the de-interleave
    (a gather by the inverse permutation, made once on the device) and
    the decode (`MinsumDecoder.decode`) run as one step, `receive`, and
    the hard bits (B, n) come out in the decoder's `bits`.

    Each call copies its inputs in and runs `receive` through a
    `_graph.Replayer`: on the CPU directly; on the card the first call
    eagerly on a side stream, the second captured as one CUDA graph and
    replayed, every later call replayed (under `_graph.eager()` every
    call eagerly: the yardstick). A call returns the buffer `bits`, which the next
    call overwrites. The noise variance must lie on the device (a host
    value would be copied from pageable memory at each call).
    """

    def __init__(self, code: LDPCCode, batch: int, n_rx: int,
                 n_streams: int = 4, num_bp_iters: int = 25,
                 detector: str = "ml", max_log: bool = False, device=None):
        dev = resolve_device(device)
        n = code.n
        if (n // 2) % n_streams:
            raise ValueError(f"{n // 2} QPSK symbols do not fill "
                             f"{n_streams} streams evenly")
        if detector == "ml":
            tables = detector_tables(n_streams, dev)
            self.detect = lambda y, H, nv: mimo_ml_llr(
                y, H, nv, n_streams=n_streams, max_log=max_log,
                tables=tables)
        elif detector == "kbest":
            tables = detector_tables(n_streams, dev)
            self.detect = lambda y, H, nv: mimo_kbest_llr(
                y, H, nv, n_streams=n_streams, tables=tables)
        elif detector == "zf-sic":
            self.detect = lambda y, H, nv: mimo_zf_sic_llr(
                y, H, nv, n_streams=n_streams)
        else:
            raise ValueError(f"unknown detector {detector!r}")
        self.settings = (n_streams, num_bp_iters, detector, max_log)
        L = n // 2 // n_streams
        self.y = torch.empty(batch, L, n_rx, 2, device=dev)
        self.heff = torch.empty(batch, n_rx, n_streams, 2, device=dev)
        self.noise_var = torch.empty((), device=dev)
        # llr_d[:, perm[j]] = llr[:, j]  <=>  llr_d = llr[:, argsort(perm)]
        self.unperm = torch.from_numpy(np.argsort(_interleaver(n))).to(dev)
        self.decoder = MinsumDecoder(code.H, batch, num_iters=num_bp_iters,
                                     device=dev)
        self.replayer = _graph.Replayer(self.receive, dev)

    def __call__(self, y: torch.Tensor, heff: torch.Tensor,
                 noise_var: torch.Tensor) -> torch.Tensor:
        """Hard bits (B, n) uint8 of y through heff at this noise variance
        (per component)."""
        for buf, v in ((self.y, y), (self.heff, heff),
                       (self.noise_var, noise_var)):
            if v.shape != buf.shape:
                raise ValueError(f"LinkReceiver takes {tuple(buf.shape)}, "
                                 f"got {tuple(v.shape)}")
            buf.copy_(v)
        self.replayer()
        return self.decoder.bits

    def receive(self) -> None:
        """Detect, de-interleave and decode the buffers."""
        llr = self.detect(self.y, self.heff, self.noise_var)  # (B, L, 2Ns)
        torch.index_select(llr.reshape(self.decoder.llr.shape), 1,
                           self.unperm, out=self.decoder.llr)
        self.decoder.decode()


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
    receiver: Optional[LinkReceiver] = None,
) -> Tuple[dict, dict]:
    """One SNR point over a batch of packets -> (ideal-CSI, est-CSI) stats,
    on H_true2's device.

    generator: draws V (B, Nt, Ns, 2) and then w (B, L, Nr, 2), unit-power
    c2, on its device. draws: (V, w) given instead (then generator may be
    None); V is used as given, scaled by 1/sqrt(Nt) as a drawn one is.
    receiver: a `LinkReceiver` of these settings on this device, kept
    across points (by default one is built for the call).
    """
    B, Nr, Nt, _ = H_true2.shape
    dev = H_true2.device
    n, k = code.n, code.k
    if receiver is None:
        receiver = LinkReceiver(code, B, Nr, n_streams, num_bp_iters,
                                detector, max_log, dev)
    elif receiver.settings != (n_streams, num_bp_iters, detector, max_log):
        raise ValueError(f"the receiver was built for (streams, iterations,"
                         f" detector, max_log) {receiver.settings}")
    L = n // 2 // n_streams  # symbol slots per packet

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

    out = {}
    for name, Heff in (("ideal", Heff_true), ("est", Heff_est)):
        bits_hat = receiver(y, Heff, noise_pow / 2.0)
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
    seeded by (seed, i). One `LinkReceiver` serves every point: on the
    card one captured graph, replayed for both CSI modes at each point."""
    from ..eval.estimate import derive_seed

    dev = resolve_device(device)
    code = make_wifi_ldpc()
    H_true2 = _c2(H_true, dev)
    H_est2 = _c2(H_est, dev)
    per_snr_est = H_est2.dim() == 5  # (S, B, Nr, Nt, 2): SNR-matched
    receiver = LinkReceiver(code, H_true2.shape[0], H_true2.shape[1],
                            n_streams, num_bp_iters, detector, device=dev)
    bi, be, li, le = [], [], [], []
    for i, snr in enumerate(np.asarray(snr_range, np.float64)):
        gen = torch.Generator(device=dev).manual_seed(derive_seed(seed, i))
        ideal, est = simulate_packets(
            gen, H_true2, H_est2[i] if per_snr_est else H_est2, float(snr),
            code, n_streams=n_streams, num_bp_iters=num_bp_iters,
            detector=detector, receiver=receiver)
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
