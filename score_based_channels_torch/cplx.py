"""Real-pair complex algebra ("c2"), the counterpart of
the JAX package's cplx.py.

A c2 tensor is float32 of shape (..., 2) holding (Re, Im); matrices are
(..., M, N, 2). The Langevin state in this layout is the score network's
(B, Nt, Nr, 2) input, so the sampler feeds the network without conversion.
Random draws take an explicit `torch.Generator`; the draws are made on the
generator's device.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

_SQRT_HALF = math.sqrt(0.5)


def from_complex(x) -> torch.Tensor:
    """complex numpy array -> c2 float32 tensor on the CPU."""
    x = np.asarray(x)
    return torch.from_numpy(
        np.stack([x.real, x.imag], axis=-1).astype(np.float32))


def to_complex(x: torch.Tensor) -> np.ndarray:
    """c2 tensor on any device -> host complex64 ndarray."""
    x = x.detach().float().cpu().numpy()
    return (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)


def as_complex(x: torch.Tensor) -> torch.Tensor:
    """c2 float32 (..., 2) -> complex64 (...), a view where x is contiguous
    (a copy otherwise)."""
    return torch.view_as_complex(x.contiguous())


def as_c2(z: torch.Tensor) -> torch.Tensor:
    """complex64 (...) -> c2 float32 (..., 2), a view where z is
    contiguous."""
    return torch.view_as_real(z.contiguous())


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, K, 2) @ (..., K, N, 2) -> (..., M, N, 2), four real matmuls."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar @ br - ai @ bi, ar @ bi + ai @ br], dim=-1)


def conj(a: torch.Tensor) -> torch.Tensor:
    """The imaginary part negated, in a's layout. No tensor is made from
    host data, so on the card it needs no copy from the host (which would
    wait for the stream)."""
    out = a.clone()
    out[..., 1].neg_()
    return out


def conj_transpose(a: torch.Tensor) -> torch.Tensor:
    """Hermitian transpose of (..., M, N, 2) -> (..., N, M, 2)."""
    return conj(a.transpose(-2, -3))


def transpose(a: torch.Tensor) -> torch.Tensor:
    """Plain (non-conjugate) transpose of (..., M, N, 2) -> (..., N, M, 2)."""
    return a.transpose(-2, -3)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise complex multiply of c2 tensors (broadcasting)."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br - ai * bi, ar * bi + ai * br], dim=-1)


def abs2(a: torch.Tensor) -> torch.Tensor:
    """|z|^2 elementwise: (..., 2) -> (...)."""
    return a[..., 0] ** 2 + a[..., 1] ** 2


def sum_abs2(a: torch.Tensor, dim) -> torch.Tensor:
    return abs2(a).sum(dim=dim)


def scale(a: torch.Tensor, s) -> torch.Tensor:
    """Multiply by a REAL scalar or array broadcast over the complex axis."""
    s = torch.as_tensor(s, dtype=a.dtype, device=a.device)
    return a * s[..., None]


def randn(generator: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """Unit-power circular complex Gaussian in c2 (E|z|^2 = 1): each
    component has variance 1/2. Drawn on the generator's device."""
    return torch.randn(tuple(shape) + (2,), generator=generator,
                       device=generator.device) * _SQRT_HALF


def qpsk_bits(generator: torch.Generator, batch: int, num_tx: int,
              num_pilots: int, dtype: torch.dtype = torch.int64
              ) -> torch.Tensor:
    """The 0/1 draws of `qpsk_pilots`: (batch, num_tx, num_pilots, 2) of
    `dtype` on the generator's device. A CPU generator draws the same bits
    whatever the integer dtype, and leaves the same state after."""
    return torch.randint(0, 2, (batch, num_tx, num_pilots, 2),
                         generator=generator, device=generator.device,
                         dtype=dtype)


def qpsk_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """QPSK entries (+-1 +-j)/sqrt(2) in c2 float32 from 0/1 bits (..., 2),
    on the bits' device."""
    return (2.0 * bits.float() - 1.0) * _SQRT_HALF


def qpsk_pilots(generator: torch.Generator, batch: int, num_tx: int,
                num_pilots: int) -> torch.Tensor:
    """Per-sample QPSK pilots in c2, entries (+-1 +-j)/sqrt(2):
    (batch, num_tx, num_pilots, 2) float32 on the generator's device."""
    return qpsk_from_bits(qpsk_bits(generator, batch, num_tx, num_pilots))


def nmse(estimate: torch.Tensor, oracle: torch.Tensor) -> torch.Tensor:
    """Per-sample NMSE over the trailing (matrix, complex) dims."""
    err = sum_abs2(estimate - oracle, dim=(-1, -2))
    ref = sum_abs2(oracle, dim=(-1, -2))
    return err / ref
