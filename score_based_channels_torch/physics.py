"""Pilot measurement physics in c2, the counterpart of
the JAX package's physics.py (snr_to_noise_power:104,
measure_c2:136, nmse:150).

  channel      H in C^{Nr x Nt};  the network sees X = H^H in C^{Nt x Nr}
  operator     A = conj(P)^T in C^{Np x Nt}, QPSK pilots P in C^{Nt x Np}
  measurement  Y = A X + sqrt(noise) W,  W unit-power complex Gaussian
  SNR model    noise = 10^(-SNR/10) * Nt
"""

from __future__ import annotations

import numpy as np
import torch

from . import cplx


def snr_to_noise_power(snr_db, num_tx: int):
    """noise = 10^(-SNR/10) * Nt (reference test_score.py:75); numpy in,
    numpy (or float) out."""
    return 10.0 ** (-np.asarray(snr_db) / 10.0) * num_tx


def measure_c2(generator: torch.Generator, A2: torch.Tensor, X2: torch.Tensor,
               noise_power) -> torch.Tensor:
    """Y = A X + sqrt(noise) W in c2. A2 (B,Np,Nt,2), X2 (B,Nt,Nr,2),
    noise_power scalar or (B,). W is drawn from `generator`, on its device,
    and moved to Y's device."""
    Y = cplx.matmul(A2, X2)
    w = cplx.randn(generator, Y.shape[:-1]).to(Y.device)
    np_ = torch.as_tensor(noise_power, dtype=torch.float32, device=Y.device)
    amp = torch.sqrt(np_).reshape(np_.shape + (1,) * (Y.dim() - np_.dim()))
    return Y + w * amp


def nmse(estimate: torch.Tensor, oracle: torch.Tensor) -> torch.Tensor:
    """Per-sample ||H_hat - H||_F^2 / ||H||_F^2 over the trailing 2 dims of
    complex tensors (reference test_score.py:168-171), float32."""
    err = (estimate - oracle).abs().pow(2).sum(dim=(-1, -2))
    ref = oracle.abs().pow(2).sum(dim=(-1, -2))
    return (err / ref).float()
