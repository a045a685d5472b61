"""QPSK modulation and soft demapping (reference testPackets.m QPSK path),
the counterpart of the JAX package's comms/modulation.py.

Gray-mapped QPSK: bits (b0, b1) -> ((1 - 2*b0) + j(1 - 2*b1))/sqrt(2), in c2.
"""

from __future__ import annotations

import numpy as np
import torch

# constellation table in c2, indexed by (b0, b1) as s = 2*b0 + b1
QPSK_POINTS = np.asarray(
    [[+1, +1], [+1, -1], [-1, +1], [-1, -1]], np.float32) / np.sqrt(2.0)
QPSK_BITS = np.asarray([[0, 0], [0, 1], [1, 0], [1, 1]], np.uint8)

_SQRT_HALF = float(np.float32(np.sqrt(0.5)))


def qpsk_modulate(bits: torch.Tensor) -> torch.Tensor:
    """bits (..., 2*L) -> symbols (..., L, 2) c2 float32."""
    b = bits.reshape(bits.shape[:-1] + (-1, 2)).float()
    re = (1.0 - 2.0 * b[..., 0]) * _SQRT_HALF
    im = (1.0 - 2.0 * b[..., 1]) * _SQRT_HALF
    return torch.stack([re, im], dim=-1)


def qpsk_demap_llr(y: torch.Tensor, noise_var, clip: float = 6.0
                   ) -> torch.Tensor:
    """AWGN per-symbol LLRs for Gray QPSK (positive => bit 0).

    y (..., L, 2) c2, noise_var the per-component variance (scalar or
    broadcastable). LLR_b0 = 2*sqrt(2)*Re(y)/var, LLR_b1 = 2*sqrt(2)*Im(y)/var,
    clipped to +-clip (testPackets.m:174-177 clips to +-6).
    """
    nv = torch.as_tensor(noise_var, dtype=torch.float32, device=y.device)
    # a true f32 division (a Python scalar over a tensor would round twice)
    scale = torch.full_like(nv, 2.0 * np.sqrt(2.0)) / nv
    llr = torch.stack([y[..., 0] * scale, y[..., 1] * scale], dim=-1)
    llr = llr.reshape(llr.shape[:-2] + (-1,))
    return llr.clamp(-clip, clip)
