"""The paper's estimation protocol: annealed Langevin posterior sampling of
a channel from pilot measurements, in plain float32 PyTorch.

Source: utcsilab/score-based-channels test_score.py:107-171 (Algorithm 1
of the paper): for each noise level sigma_i and each of its inner steps,

  alpha_i = alpha * (sigma_i / sigma_L)^2
  x <- x + alpha_i s(x, sigma_i) - alpha_i / (noise/2 + sigma_i^2) A^H (A x - y)
         + sqrt(2 alpha_i beta) z,

with A = P^H the conjugated pilots, y = A h + sqrt(noise) w, the NMSE
||x - h||^2 / ||h||^2 recorded after every step.

The sweep's draws are the port's, made again from the sweep's seed
(`sweep_inputs`): the pilots, the initial state and the measurement
noise from one CPU generator in that order, the Langevin noise from one
generator on the run's device, one (chunk, Nt, Nr) draw a step, of which
each row keeps its own. Departures from the published protocol, both
options of the port's `estimate` command: every `stride`-th level is
kept (with the last) and alpha is scaled by the stride; a chunk's rows
draw their Langevin noise together.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from .common import (
    c2_abs2_sum, c2_conj_t, c2_matmul, c2_randn, derive_seed, generator,
    geometric_sigmas, qpsk,
)


def strided_sigmas(begin: float, rate: float, num: int, stride: int):
    """(sigmas, alpha scale): every stride-th level, the last one kept."""
    s = geometric_sigmas(begin, rate, num)
    if stride <= 1:
        return s, 1.0
    sub = s[::stride]
    if float(sub[-1]) != float(s[-1]):
        sub = torch.cat([sub, s[-1:]])
    return sub, float(stride)


def sweep_inputs(oracle: torch.Tensor, snr_db: Sequence[float], seed: int,
                 num_pilots: int) -> Dict[str, torch.Tensor]:
    """The rows of one sweep, SNR-major (row s * C + c), on the CPU:
    A (R, Np, Nt, 2), Y (R, Np, Nr, 2), x0, oracle (R, Nt, Nr, 2),
    noise_power (R,). oracle: the C normalised channels H^H (C, Nt, Nr, 2)."""
    g = generator(seed, 0)
    C, num_tx = oracle.shape[0], oracle.shape[1]
    A = c2_conj_t(qpsk(g, C, num_tx, num_pilots))
    x0 = c2_randn(g, oracle.shape[:-1])
    S = len(snr_db)
    npow = (10.0 ** (-np.asarray(snr_db, np.float64) / 10.0) * num_tx)
    npow = torch.from_numpy(np.repeat(npow.astype(np.float32), C))
    A, X, x0 = (t.repeat(S, 1, 1, 1) for t in (A, oracle, x0))
    Y = c2_matmul(A, X)
    w = c2_randn(g, Y.shape[:-1])
    Y = Y + w * torch.sqrt(npow).view(-1, 1, 1, 1)
    return dict(A=A, Y=Y, x0=x0, oracle=X, noise_power=npow)


@torch.no_grad()
def posterior_sweeps(score: Callable,
                     groups: Sequence[Tuple[dict, Sequence[int], int]],
                     sigmas: torch.Tensor, alpha: float, beta: float,
                     steps_each: int, chunk: int, device
                     ) -> Dict[str, torch.Tensor]:
    """Chosen rows of one-chunk sweeps (R <= chunk rows each), run
    together -> final states (n, Nt, Nr, 2) and NMSE traces
    (L * steps_each, n) on `device`, rows in the order of `groups`: each
    group is (the sweep's `sweep_inputs`, its rows, its seed), and draws
    its Langevin noise from its own generator. score(x, sigma) is the
    network's output divided by sigma."""
    dev = torch.device(device)
    parts = {k: [] for k in ("A", "Y", "x0", "oracle", "noise_power")}
    gens, keeps = [], []
    for inputs, rows, seed in groups:
        idx = torch.as_tensor(list(rows), dtype=torch.int64)
        for k in parts:
            parts[k].append(inputs[k][idx])
        gens.append(torch.Generator(device=dev).manual_seed(
            derive_seed(derive_seed(seed, 1), 0)))
        keeps.append(idx.to(dev))
    A, Y, x, X, npow = (torch.cat(parts[k]).to(dev) for k in
                        ("A", "Y", "x0", "oracle", "noise_power"))
    npow = npow.view(-1, 1, 1, 1)
    Ah = c2_conj_t(A)
    energy = c2_abs2_sum(X, dim=(-1, -2))
    sig = sigmas.to(dev)
    s_end = sig[-1]
    shape = (chunk,) + tuple(x.shape[1:-1])
    trace = []
    for lvl in range(sig.shape[0]):
        s = sig[lvl]
        a = alpha * (s / s_end) ** 2
        coef = a / (npow / 2.0 + s ** 2)
        amp = torch.sqrt(2.0 * a * beta)
        for _ in range(steps_each):
            sc = score(x, s)
            grad = c2_matmul(Ah, c2_matmul(A, x) - Y)
            z = torch.cat([c2_randn(g, shape)[k] for g, k in zip(gens, keeps)])
            x = x + a * sc - coef * grad + amp * z
            trace.append(c2_abs2_sum(x - X, dim=(-1, -2)) / energy)
    return dict(x=x, trace=torch.stack(trace))
