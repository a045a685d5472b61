"""What the references share: seeds, complex algebra on real pairs, the
noise schedule, the precision switches of the comparison and its control.

A c2 tensor is float32 of shape (..., 2) holding (Re, Im), the layout of
the channel matrices, states and measurements in every cell.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import numpy as np
import torch

SQRT_HALF = math.sqrt(0.5)


def derive_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for the stream named by (seed, *path): numpy's
    SeedSequence, the rule by which the port names its random streams."""
    return int(np.random.SeedSequence([seed, *path]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, *path: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive_seed(seed, *path))


def c2_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., M, K, 2) @ (..., K, N, 2) -> (..., M, N, 2)."""
    ar, ai, br, bi = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    return torch.stack([ar @ br - ai @ bi, ar @ bi + ai @ br], dim=-1)


def c2_conj_t(a: torch.Tensor) -> torch.Tensor:
    """Hermitian transpose of (..., M, N, 2)."""
    t = a.transpose(-2, -3)
    return torch.stack([t[..., 0], -t[..., 1]], dim=-1)


def c2_abs2_sum(a: torch.Tensor, dim) -> torch.Tensor:
    return (a[..., 0] ** 2 + a[..., 1] ** 2).sum(dim=dim)


def c2_randn(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """Unit-power circular complex Gaussian in c2, drawn on gen's device."""
    return torch.randn(tuple(shape) + (2,), generator=gen,
                       device=gen.device) * SQRT_HALF


def qpsk(gen: torch.Generator, batch: int, num_tx: int,
         num_pilots: int) -> torch.Tensor:
    """QPSK pilots (batch, num_tx, num_pilots, 2), entries (+-1 +-j)/sqrt 2."""
    bits = torch.randint(0, 2, (batch, num_tx, num_pilots, 2), generator=gen,
                         device=gen.device)
    return (2.0 * bits.float() - 1.0) * SQRT_HALF


def to_c2(z: np.ndarray) -> torch.Tensor:
    z = np.asarray(z)
    return torch.from_numpy(np.stack([z.real, z.imag], -1).astype(np.float32))


def geometric_sigmas(begin: float, rate: float, num: int) -> torch.Tensor:
    """The paper's noise levels: begin * rate^k, k < num, as geometric
    interpolation in float64 rounded once to float32."""
    end = begin * rate ** (num - 1)
    s = np.exp(np.linspace(np.log(begin), np.log(end), num))
    return torch.from_numpy(s.astype(np.float32))


@contextlib.contextmanager
def precision(tf32: bool):
    """cuDNN and matmul in IEEE float32 (tf32 False, the reference) or in
    TF32 (True, the control of a float32 cell) while the block runs."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude mapped to 448, the format's largest), back in t's dtype: the
    storage of the control of a bfloat16 cell."""
    amax = t.detach().abs().amax().clamp_min(1e-30)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


def bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16, back in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


class Adam:
    """optax.adam over a dict of leaves: mu, nu from zero, bias corrections
    1 - b^t in float32, eps outside the square root; `lr(t)` the rate of
    the update of 0-based index t."""

    def __init__(self, params: dict, lr, beta1: float, beta2: float,
                 eps: float):
        self.lr = lr if callable(lr) else (lambda t: lr)
        self.b1, self.b2, self.eps = beta1, beta2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        t = self.t
        bc1 = float(1 - np.float32(self.b1) ** np.float32(t + 1))
        bc2 = float(1 - np.float32(self.b2) ** np.float32(t + 1))
        lr = self.lr(t)
        for k, p in params.items():
            g = grads[k]
            self.mu[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.nu[k].mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            upd = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2)
                                        + self.eps)
            p.sub_(lr * upd)
        self.t += 1
