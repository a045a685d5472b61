"""QC-LDPC encode/decode for the end-to-end link simulation, the
counterpart of the JAX package's comms/ldpc.py.

The reference's link-level evaluation is MATLAB (testPackets.m:29-60):
IEEE 802.11n LDPC with codeword length 648, rate 1/2 (Z=27), BP decoding.

  - the code construction is numpy on the host, a copy of the JAX
    package's (the real 802.11n code `make_wifi_ldpc`, the legacy
    pseudo-random `make_wifi_like_ldpc`, the GF(2) systematiser), so both
    packages build the same H, generator and permutation bit for bit;
  - `minsum_decode` runs normalized min-sum BP as `num_iters` calls of
    `kernels.ldpc_minsum.bp_iteration` on dense masked (B, m, n) messages:
    the hand-written CUDA kernel on the card, its plain PyTorch version on
    the CPU;
  - `MinsumDecoder` runs the same decode on static buffers, the
    counterpart of the JAX package's jitted `minsum_decode` and its
    `lax.scan` (comms/ldpc.py:199, :252): on the card one CUDA graph of
    the whole decode, replayed a call.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import _graph
from .._device import resolve_device
from ..kernels.ldpc_minsum import bp_iteration, column_sums, edge_tables

# IEEE 802.11n (HT) rate-1/2, n=648, Z=27 prototype matrix: IEEE Std
# 802.11n Annex R Table R.1 (public standard constant; the reference link
# sim transcribes the same table at testPackets.m:29-41).
# -1 = all-zero 27x27 block; s >= 0 = identity right-cyclic-shifted by s.
_ = -1
WIFI_N648_R12_Z27 = np.array([
    [0,  _,  _,  _,  0,  0,  _,  _,  0,  _,  _,  0,  1, 0, _, _, _, _, _, _, _, _, _, _],
    [22, 0,  _,  _,  17, _,  0,  0,  12, _,  _,  _,  _, 0, 0, _, _, _, _, _, _, _, _, _],
    [6,  _,  0,  _,  10, _,  _,  _,  24, _,  0,  _,  _, _, 0, 0, _, _, _, _, _, _, _, _],
    [2,  _,  _,  0,  20, _,  _,  _,  25, 0,  _,  _,  _, _, _, 0, 0, _, _, _, _, _, _, _],
    [23, _,  _,  _,  3,  _,  _,  _,  0,  _,  9,  11, _, _, _, _, 0, 0, _, _, _, _, _, _],
    [24, _,  23, 1,  17, _,  3,  _,  10, _,  _,  _,  _, _, _, _, _, 0, 0, _, _, _, _, _],
    [25, _,  _,  _,  8,  _,  _,  _,  7,  18, _,  _,  0, _, _, _, _, _, 0, 0, _, _, _, _],
    [13, 24, _,  _,  0,  _,  8,  _,  6,  _,  _,  _,  _, _, _, _, _, _, _, 0, 0, _, _, _],
    [7,  20, _,  16, 22, 10, _,  _,  23, _,  _,  _,  _, _, _, _, _, _, _, _, 0, 0, _, _],
    [11, _,  _,  _,  19, _,  _,  _,  13, _,  3,  17, _, _, _, _, _, _, _, _, _, 0, 0, _],
    [25, _,  8,  _,  23, 18, _,  14, 9,  _,  _,  _,  _, _, _, _, _, _, _, _, _, _, 0, 0],
    [3,  _,  _,  _,  16, _,  _,  2,  25, 5,  _,  _,  1, _, _, _, _, _, _, _, _, _, _, 0],
], np.int64)
del _


def _expand_base(base: np.ndarray, z: int) -> np.ndarray:
    """Base matrix (-1 = zero block, s >= 0 = I right-cyclic-shifted by s,
    MATLAB `circshift(I, [0 s])` convention, testPackets.m:47-53) -> dense H.
    """
    mb, nb = base.shape
    H = np.zeros((mb * z, nb * z), np.uint8)
    I = np.eye(z, dtype=np.uint8)
    for i in range(mb):
        for j in range(nb):
            s = base[i, j]
            if s >= 0:
                H[i * z:(i + 1) * z, j * z:(j + 1) * z] = np.roll(
                    I, int(s) % z, axis=1)
    return H


def make_wifi_like_base(rate_num: int = 1, rate_den: int = 2, z: int = 27,
                        nb: int = 24, seed: int = 80211) -> np.ndarray:
    """802.11n-style base matrix: dual-diagonal parity part, pseudo-random
    information shifts with a standard-like degree profile."""
    assert rate_num * 2 == rate_den, "only rate 1/2 here"
    mb = nb // 2  # 12
    kb = nb - mb  # 12
    rng = np.random.default_rng(seed)
    base = -np.ones((mb, nb), np.int64)

    # information part: column degrees ~ [11, 4, 3, 3, ...] (WiFi-like)
    col_degrees = [11, 4, 4, 4, 3, 3, 3, 3, 3, 3, 3, 3][:kb]
    for j, deg in enumerate(col_degrees):
        rows = rng.choice(mb, size=deg, replace=False)
        for i in rows:
            base[i, j] = rng.integers(0, z)

    # parity part (columns kb..nb): 802.11n structure -
    # first parity column has weight 3 (rows 0, mid, last; one shift 1),
    # the rest is a shift-0 dual diagonal
    p0 = kb
    base[0, p0] = 1
    base[mb // 2, p0] = 0
    base[mb - 1, p0] = 1
    for t in range(1, mb):
        base[t - 1, p0 + t] = 0
        base[t, p0 + t] = 0
    # guarantee every row has an info-part entry (full BP connectivity)
    for i in range(mb):
        if np.all(base[i, :kb] < 0):
            base[i, rng.integers(0, kb)] = rng.integers(0, z)
    return base


@dataclasses.dataclass
class LDPCCode:
    """A binary LDPC code with dense H and a systematic encoder."""

    H: np.ndarray  # (m, n) uint8
    G_info_to_parity: np.ndarray  # (k, m) uint8: parity = u @ P mod 2
    perm: np.ndarray  # column permutation applied to H for systematic form
    n: int
    k: int

    @property
    def m(self) -> int:
        return self.n - self.k

    def encode(self, bits: np.ndarray) -> np.ndarray:
        """bits (..., k) uint8 -> codewords (..., n), systematic in the
        (permuted) first k positions, de-permuted back to H's columns."""
        u = np.asarray(bits, np.uint8)
        parity = (u @ self.G_info_to_parity) % 2
        cw_perm = np.concatenate([u, parity], axis=-1)
        out = np.empty_like(cw_perm)
        out[..., self.perm] = cw_perm
        return out

    def check(self, cw: np.ndarray) -> np.ndarray:
        """Syndrome == 0 per codeword (..., n) -> bool (...)."""
        return ((np.asarray(cw, np.uint8) @ self.H.T) % 2 == 0).all(-1)


def _systematize(H: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """GF(2) Gaussian elimination: H * Pi^T = [A | I_m] (column permutation
    Pi).

    Returns (P, perm) with parity = u @ P for the permuted layout
    [info(k) | parity(m)].
    """
    H = H.copy() % 2
    m, n = H.shape
    perm = np.arange(n)
    # reduce the LAST m columns to identity (pivot from the right)
    row = 0
    for col in range(n - m, n):
        # find pivot at/below `row` in column `col` (after permutation)
        pivots = np.nonzero(H[row:, perm[col]])[0]
        if len(pivots) == 0:
            # swap in a column from the info part that has a pivot
            for j in range(n - m):
                if H[row:, perm[j]].any():
                    perm[[col, j]] = perm[[j, col]]
                    pivots = np.nonzero(H[row:, perm[col]])[0]
                    break
            else:
                raise ValueError("H is rank deficient")
        r = row + pivots[0]
        H[[row, r]] = H[[r, row]]
        # eliminate
        mask = H[:, perm[col]].copy()
        mask[row] = 0
        H[mask == 1] ^= H[row]
        row += 1
    A = H[:, perm[: n - m]]  # (m, k): parity = A @ u
    return (A.T % 2).astype(np.uint8), perm


def _code_from_h(H: np.ndarray) -> LDPCCode:
    P, perm = _systematize(H)
    n = H.shape[1]
    return LDPCCode(H=H, G_info_to_parity=P, perm=perm, n=n,
                    k=n - H.shape[0])


def make_wifi_like_ldpc(z: int = 27, nb: int = 24, seed: int = 80211
                        ) -> LDPCCode:
    """(648, 324) rate-1/2 QC-LDPC with pseudo-random info shifts (legacy
    stand-in; prefer `make_wifi_ldpc` for reference parity)."""
    return _code_from_h(_expand_base(make_wifi_like_base(z=z, nb=nb,
                                                         seed=seed), z))


def make_wifi_ldpc() -> LDPCCode:
    """The REAL IEEE 802.11n (648, 324) Z=27 rate-1/2 code: H expanded
    from the published Annex R prototype exactly as the reference does
    (testPackets.m:43-60), so syndromes/codewords are directly comparable.
    """
    return _code_from_h(_expand_base(WIFI_N648_R12_Z27, 27))


# -----------------------------------------------------------------------------
# batched min-sum BP decoding (dense masked messages)
# -----------------------------------------------------------------------------


def minsum_decode(llr: torch.Tensor, H, num_iters: int = 25,
                  normalize: float = 0.75
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized min-sum BP on llr's device. Returns (hard bits (B, n)
    uint8, final LLRs (B, n) float32); positive LLR => bit 0.

    llr: (B, n) channel LLRs; H: (m, n) 0/1 parity-check mask (array or
    tensor). Each iteration is one `bp_iteration`: the CUDA kernel for a
    CUDA llr, the plain PyTorch version for a CPU one. The edge tables
    are built once per call from H's contents. The final column sums
    take the kernel's order (ascending rows), so the card and the CPU give
    the same bits.
    """
    llr = llr.float().contiguous()
    tables = edge_tables(H, device=llr.device)
    c2v = torch.zeros(llr.shape[0], tables.m, tables.n, device=llr.device)
    for _ in range(num_iters):
        c2v = bp_iteration(c2v, llr, H, normalize, tables=tables)
    post = llr + column_sums(c2v, tables)
    bits = (post < 0).to(torch.uint8)  # positive LLR => bit 0
    return bits, post


class MinsumDecoder:
    """`minsum_decode` of `batch` packets on static buffers, with the same
    bits: the edge tables built once, an `llr` input buffer, two message
    buffers that take turns (each iteration reads one and the kernel
    writes the other), and the `post` and `bits` outputs.

    A call copies its LLRs into `llr` and runs the whole decode (`decode`:
    `num_iters` iterations, the column sums, the hard decision) through a
    `_graph.Replayer`: on the CPU the plain loop; on the card the first
    call eagerly on a side stream, the second captured as one CUDA graph
    and replayed, every later call replayed (under `_graph.eager()` each
    call runs eagerly: the yardstick). `decode` reads no host value,
    so a caller may also record it inside a graph of its own
    (`comms.link.LinkReceiver` does). A call returns the decoder's own
    `bits` and `post`, which the next call overwrites.
    """

    def __init__(self, H, batch: int, num_iters: int = 25,
                 normalize: float = 0.75, device=None):
        dev = resolve_device(device)
        self.H = H
        self.num_iters = num_iters
        self.normalize = normalize
        self.tables = edge_tables(H, device=dev)
        m, n = self.tables.m, self.tables.n
        self.llr = torch.empty(batch, n, device=dev)
        self.c2v = (torch.empty(batch, m, n, device=dev),
                    torch.empty(batch, m, n, device=dev))
        self.post = torch.empty(batch, n, device=dev)
        self.bits = torch.empty(batch, n, dtype=torch.uint8, device=dev)
        self.replayer = _graph.Replayer(self.decode, dev)

    def __call__(self, llr: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Decode llr (batch, n) -> (hard bits uint8, final LLRs)."""
        if llr.shape != self.llr.shape:
            raise ValueError(f"MinsumDecoder takes llr {tuple(self.llr.shape)}"
                             f", got {tuple(llr.shape)}")
        self.llr.copy_(llr)
        self.replayer()
        return self.bits, self.post

    def decode(self) -> None:
        """The decode of `llr` into `post` and `bits`."""
        c2v, other = self.c2v
        c2v.zero_()
        for _ in range(self.num_iters):
            bp_iteration(c2v, self.llr, self.H, self.normalize,
                         tables=self.tables, out=other)
            c2v, other = other, c2v
        torch.add(self.llr, column_sums(c2v, self.tables), out=self.post)
        torch.lt(self.post, 0, out=self.bits)  # positive LLR => bit 0
