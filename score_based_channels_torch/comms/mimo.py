"""MIMO soft demapping, the counterpart of the JAX package's comms/mimo.py.

Reference ComputeLLRMIMO.m: for y = H_eff*s + n with s in QPSK^Ns,
  - 'ml' (:116-248): enumerate all 4^Ns candidate vectors (a constant
    (256, Ns) table for Ns = 4); the distances of every candidate, symbol
    slot and packet are one broadcast reduction; exact LLRs by logsumexp
    over the bit-partitioned hypothesis sets, or max-log;
  - K-best breadth-first tree search (the sphere / m-algorithm family,
    :77-115) with a fixed beam (`torch.topk`);
  - ZF-SIC (:15-57).
All plain PyTorch on the tensors' device (the JAX package has no kernel
here). The JAX package jits each detector (comms/mimo.py:36, :116,
:190); here the ML and K-best detectors take their constant tables from
`detector_tables`, built once on the device, so that a caller can record
them in a CUDA graph (`comms.link.LinkReceiver`): given `tables`, given a
noise variance on the device, no detector makes a tensor from host data
or waits for the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import cplx
from .modulation import QPSK_BITS, QPSK_POINTS, qpsk_demap_llr

_NEG_INF = -1e30


def _candidate_table(n_streams: int) -> Tuple[np.ndarray, np.ndarray]:
    """All QPSK^Ns vectors -> (syms (M, Ns, 2) c2, bits (M, 2*Ns))."""
    M = 4**n_streams
    idx = np.stack(np.meshgrid(*([np.arange(4)] * n_streams),
                               indexing="ij"), -1).reshape(M, n_streams)
    syms = QPSK_POINTS[idx]  # (M, Ns, 2)
    bits = QPSK_BITS[idx].reshape(M, 2 * n_streams)
    return syms.astype(np.float32), bits


class DetectorTables(NamedTuple):
    """The detectors' constants on one device."""

    syms: torch.Tensor    # (4^Ns, Ns, 2) f32: every QPSK^Ns candidate
    m0: torch.Tensor      # (4^Ns, 2Ns) f32: 0 where the bit is 0, else -1e30
    m1: torch.Tensor      # (4^Ns, 2Ns) f32: 0 where the bit is 1, else -1e30
    points: torch.Tensor  # (4, 2) f32: QPSK_POINTS
    bits: torch.Tensor    # (4, 2) uint8: QPSK_BITS


def detector_tables(n_streams: int, device) -> DetectorTables:
    """The candidate table, its bit masks and the QPSK tables of
    `n_streams` streams, made on the host and copied to `device` once."""
    syms, bits = _candidate_table(n_streams)
    bit0 = torch.from_numpy(bits == 0).to(device)  # (M, 2Ns)
    return DetectorTables(
        syms=torch.from_numpy(syms).to(device),
        m0=torch.where(bit0, 0.0, _NEG_INF),
        m1=torch.where(bit0, _NEG_INF, 0.0),
        points=torch.from_numpy(QPSK_POINTS.astype(np.float32)).to(device),
        bits=torch.from_numpy(QPSK_BITS).to(device))


def _noise_var(noise_var, like: torch.Tensor) -> torch.Tensor:
    """Per-component variance as a tensor broadcastable to (B, L, M)."""
    nv = torch.as_tensor(noise_var, dtype=torch.float32, device=like.device)
    if nv.dim():  # (B,) -> (B, 1, 1)
        nv = nv.reshape(nv.shape + (1,) * (3 - nv.dim()))
    return nv


def mimo_ml_llr(Y: torch.Tensor, H_eff: torch.Tensor, noise_var,
                n_streams: int = 4, max_log: bool = False,
                clip: float = 6.0,
                tables: Optional[DetectorTables] = None) -> torch.Tensor:
    """Per-bit LLRs (B, L, 2*Ns), positive => bit 0 (testPackets LLR clip
    +-6).

    Y (B, L, Nr, 2) received symbols, H_eff (B, Nr, Ns, 2) the effective
    channel (may be an estimate), noise_var the per-component variance,
    scalar or (B,). tables: `detector_tables(n_streams, Y.device)`, when
    the caller already built them (by default built here).
    """
    t = tables if tables is not None else detector_tables(n_streams,
                                                           Y.device)
    # candidate received points: H_eff (B,Nr,Ns) @ syms^T (Ns,M) -> (B,Nr,M)
    cand = cplx.matmul(H_eff, cplx.transpose(t.syms))
    cand = cand.movedim(2, 1)  # (B, M, Nr, 2)
    diff = Y[:, :, None] - cand[:, None]  # (B, L, M, Nr, 2)
    d2 = cplx.abs2(diff).sum(dim=-1)  # (B, L, M)
    metric = -d2 / (2.0 * _noise_var(noise_var, Y))

    metric = metric[..., None]  # (B, L, M, 1) against (M, 2Ns)
    if max_log:
        l0 = (metric + t.m0).amax(dim=-2)
        l1 = (metric + t.m1).amax(dim=-2)
    else:
        l0 = torch.logsumexp(metric + t.m0, dim=-2)
        l1 = torch.logsumexp(metric + t.m1, dim=-2)
    return (l0 - l1).clamp(-clip, clip)  # (B, L, 2Ns)


def _c2_qr(H: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Thin complex QR of H (B, Nr, Ns, 2) by modified Gram-Schmidt in c2.

    Returns Q (B, Nr, Ns, 2) with orthonormal columns and upper-triangular
    R (B, Ns, Ns, 2) with a real-positive diagonal (imaginary part exactly
    zero by construction).
    """
    Ns = H.shape[-2]
    zero = H.new_zeros(H.shape[:-3] + (2,))  # (B, 2)
    q_cols = []
    R = [[zero] * Ns for _ in range(Ns)]
    for j in range(Ns):
        v = H[..., :, j, :]  # (B, Nr, 2)
        for i in range(j):
            # r_ij = q_i^H v  (inner product over Nr)
            r_ij = cplx.mul(cplx.conj(q_cols[i]), v).sum(dim=-2)
            R[i][j] = r_ij
            v = v - cplx.mul(r_ij[..., None, :], q_cols[i])
        r_jj = torch.sqrt(cplx.abs2(v).sum(dim=-1) + 1e-20)  # (B,)
        R[j][j] = torch.stack([r_jj, torch.zeros_like(r_jj)], -1)
        q_cols.append(v / r_jj[..., None, None])
    Q = torch.stack(q_cols, dim=-2)  # (B, Nr, Ns, 2)
    return Q, torch.stack([torch.stack(row, dim=-2) for row in R], dim=-3)


def mimo_kbest_llr(Y: torch.Tensor, H_eff: torch.Tensor, noise_var,
                   n_streams: int = 4, k_best: int = 16,
                   clip: float = 6.0,
                   tables: Optional[DetectorTables] = None) -> torch.Tensor:
    """K-best breadth-first tree detector, max-log LLRs (B, L, 2*Ns).

    QR-decompose H_eff, walk the stream tree from the last stream up
    keeping a fixed beam of `k_best` partial candidates per level, then
    max-log LLRs over the surviving list. With k_best >= 4^Ns the search
    is exhaustive and matches `mimo_ml_llr(max_log=True)`. tables: as in
    `mimo_ml_llr` (only the QPSK tables are read).
    """
    Ns = n_streams
    t = tables if tables is not None else detector_tables(Ns, Y.device)
    points = t.points
    Q, R = _c2_qr(H_eff)
    # z = Q^H y per slot: (B, Ns, Nr) @ (B, Nr, L) -> (B, L, Ns, 2)
    z = cplx.matmul(cplx.conj_transpose(Q), Y.transpose(1, 2)).transpose(1, 2)
    B, L = Y.shape[0], Y.shape[1]

    # beam: distances (B, L, Kc) and symbol indices (B, L, Kc, Ns)
    dist = Y.new_zeros(B, L, 1)
    sym_idx = torch.zeros(B, L, 1, Ns, dtype=torch.int64, device=Y.device)
    for j in range(Ns - 1, -1, -1):  # detect from the last stream up
        Kc = dist.shape[-1]
        # interference of the already-fixed streams i > j on row j of R
        contrib = Y.new_zeros(B, L, Kc, 2)
        for i in range(j + 1, Ns):
            s_i = points[sym_idx[..., i]]  # (B, L, Kc, 2)
            contrib = contrib + cplx.mul(R[:, j, i][:, None, None, :], s_i)
        resid = z[:, :, None, j, :] - contrib  # (B, L, Kc, 2)
        r_jj = R[:, j, j, 0][:, None, None, None]  # real diagonal
        # increments of the 4 symbol expansions: (B, L, Kc, 4)
        cand = resid[..., None, :] - r_jj[..., None] * points
        d_new = dist[..., None] + cand.square().sum(dim=-1)
        d_flat = d_new.reshape(B, L, Kc * 4)
        keep = min(k_best, Kc * 4)
        neg_d, keep_idx = torch.topk(-d_flat, keep, dim=-1)
        dist = -neg_d
        sym_idx = torch.gather(
            sym_idx, 2, (keep_idx // 4)[..., None].expand(-1, -1, -1, Ns))
        sym_idx[..., j] = keep_idx % 4

    metric = -dist / (2.0 * _noise_var(noise_var, Y))  # (B, L, K)
    bits = t.bits[sym_idx]  # (B, L, K, Ns, 2)
    bits = bits.reshape(bits.shape[:3] + (2 * Ns,))  # (B, L, K, 2Ns)
    metric = metric[..., None]
    l0 = torch.where(bits == 0, metric, _NEG_INF).amax(dim=2)
    l1 = torch.where(bits == 1, metric, _NEG_INF).amax(dim=2)
    return (l0 - l1).clamp(-clip, clip)  # (B, L, 2Ns)


def mimo_zf_sic_llr(Y: torch.Tensor, H_eff: torch.Tensor, noise_var,
                    n_streams: int = 4, clip: float = 6.0) -> torch.Tensor:
    """ZF + successive interference cancellation (ComputeLLRMIMO.m:15-57).

    Streams are detected in fixed order: ZF-equalise the remaining system
    (regularised normal equations in real block form), hard-slice the
    current stream, cancel, repeat. LLRs per stream come from the
    post-equalisation scalar channel. Returns (B, L, 2*Ns). It reads no
    constant table. The solve is `solve_ex` without its error check (the
    bits of `solve`: the system is regularised, never singular), since
    the check would wait for the host.
    """
    y = Y
    llrs = []
    H_cur = H_eff  # (B, Nr, Ns, 2)
    for _ in range(n_streams):
        Hh = cplx.conj_transpose(H_cur)  # (B, k, Nr, 2)
        G = cplx.matmul(Hh, H_cur)  # (B, k, k, 2)
        k = G.shape[-3]
        Gr = torch.cat([torch.cat([G[..., 0], -G[..., 1]], -1),
                        torch.cat([G[..., 1], G[..., 0]], -1)], -2)
        Gr = Gr + 1e-5 * torch.eye(2 * k, device=Y.device)
        rhs = cplx.matmul(Hh, y.transpose(1, 2))  # (B, k, L, 2)
        rhs_r = torch.cat([rhs[..., 0], rhs[..., 1]], -2)  # (B, 2k, L)
        sol, _ = torch.linalg.solve_ex(Gr, rhs_r, check_errors=False)
        x_eq = torch.stack([sol[:, :k], sol[:, k:]], -1)  # (B, k, L, 2)
        x0 = x_eq[:, 0]  # (B, L, 2)
        llrs.append(qpsk_demap_llr(x0[:, :, None, :], noise_var, clip=clip))
        # hard decision and cancellation
        hard = torch.sign(x0) * float(np.float32(np.sqrt(0.5)))
        contrib = cplx.mul(H_cur[:, None, :, 0, :], hard[:, :, None, :])
        y = y - contrib  # (B, L, Nr, 2)
        H_cur = H_cur[:, :, 1:, :]
    return torch.cat(llrs, dim=-1)  # (B, L, 2Ns)
