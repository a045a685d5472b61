"""Linear-MMSE (Wiener) channel estimator, the counterpart of
the JAX package's baselines/lmmse.py:39-113.

    x_hat = C M^H (M C M^H + sigma^2 I)^-1 y,   M = I_{Nr} (x) A,  A = conj(P)^T

Dense per-sample solves (complex128, Np*Nr = 608 rows at 38 pilots) are a
host LAPACK workload, as in the JAX package; they run in numpy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def empirical_covariance(train_ds) -> np.ndarray:
    """E[v v^H] of v = vec_F(normalised H^H) over the training set
    (column-major vec over (Nt, Nr)); complex128."""
    H = np.asarray(train_ds.hermitian(normalized=True))
    V = H.reshape(H.shape[0], -1, order="F")
    return (V.T @ V.conj()) / V.shape[0]


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
