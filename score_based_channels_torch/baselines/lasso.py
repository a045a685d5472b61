"""Lasso / fsAD compressed-sensing baseline with a lifted Fourier
dictionary, the counterpart of the JAX package's baselines/lasso.py (the
`lasso` command, reference test_l1Fourier_lifted.py).

The dictionary synthesis H = L Z R is two small matmuls with host-built
constants; the whole {(lambda, lr) grid x SNR x samples} batch runs FISTA
(SigPy GradientMethod with the L1 prox, accelerate=True;
test_l1Fourier_lifted.py:133,159-162) on the run's device, with
per-sample lambda and lr and an optional per-iteration NMSE trace kept on
the device; on the card an iteration is a CUDA graph, replayed for every
iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _graph, cplx, physics
from .._device import resolve_device
from ..config import Config
from ..data.dataset import ChannelDataset
from ..eval.estimate import _generator


def lifted_fourier_dicts(nr_rows: int, nr_cols: int, lifting: int = 4
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(L, R): H (rows x cols) = L Z R with Z (rows*lift x cols*lift).

    test_l1Fourier_lifted.py:125-128: L = conj(ifft(I_rows, n=rows*lift,
    'ortho')) (rows x rows*lift), R = ifft(I_cols, n=cols*lift,
    'ortho').T (cols*lift x cols). Host complex64 constants.
    """
    from scipy.fft import ifft

    L = np.conj(ifft(np.eye(nr_rows), n=nr_rows * lifting, norm="ortho"))
    R = ifft(np.eye(nr_cols), n=nr_cols * lifting, norm="ortho").T
    return L.astype(np.complex64), R.astype(np.complex64)


def _soft_threshold_c2(z: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    """Complex soft-thresholding of a c2 tensor, in place:
    z max(1 - t/|z|, 0) (the L1 prox), in the JAX package's arithmetic."""
    mag = (z * z).sum(-1).add_(1e-30).sqrt_()
    scale = torch.div(thresh, mag, out=mag).neg_().add_(1.0).clamp_(min=0.0)
    return z.mul_(scale[..., None])


def fista_momentum(num_iters: int) -> np.ndarray:
    """(num_iters,) float32: FISTA's extrapolation factor (t - 1) / t_new
    of each iteration, t_new = (1 + sqrt(1 + 4 t^2)) / 2 from t = 1, in
    float32 as the JAX package's scan carries t."""
    out = np.empty(num_iters, np.float32)
    t = np.float32(1.0)
    for it in range(num_iters):
        tnew = (np.float32(1.0) + np.sqrt(np.float32(1.0)
                                          + np.float32(4.0) * t * t)
                ) / np.float32(2.0)
        out[it] = (t - np.float32(1.0)) / tnew
        t = tnew
    return out


def _fista_problem(A2, Y2, L2, R2, lmbda, lr):
    """(prox_grad, synth, Z shape) of the lifted Lasso on A2's device:
    prox_grad(W2, out=None) the L1 prox of W - lr grad(W) (a new tensor,
    or written into `out`), synth(Z2) = L Z R. The products run as complex64 matmuls on complex
    views of the c2 tensors (one complex GEMM where c2 takes four real
    ones and two adds), in the JAX package's order (A L Z) R; the
    elementwise steps run on c2, in place where a tensor is not read
    again (the same arithmetic, fewer large allocations)."""
    dev = A2.device
    B = A2.shape[0]
    lmbda = torch.broadcast_to(
        torch.as_tensor(lmbda, dtype=torch.float32, device=dev), (B,))
    lr = torch.broadcast_to(
        torch.as_tensor(lr, dtype=torch.float32, device=dev), (B,))
    step = lr[:, None, None, None]
    thresh = (lmbda * lr)[:, None, None]

    L, R, Y = (cplx.as_complex(t) for t in (L2, R2, Y2))
    AL = cplx.as_complex(A2) @ L  # the dictionaries broadcast over the batch
    ALh, Rh = AL.mH, R.mH

    def synth(Z2):
        return cplx.as_c2((L @ torch.view_as_complex(Z2)) @ R)

    def prox_grad(W2, out=None):
        W = torch.view_as_complex(W2)
        g = cplx.as_c2(torch.matmul(
            ALh @ ((AL @ W) @ R - Y), Rh,
            out=None if out is None else torch.view_as_complex(out)))
        # W - lr grad(W), then the prox; in place on the fresh gradient
        return _soft_threshold_c2(g.mul_(step).neg_().add_(W2), thresh)

    return prox_grad, synth, (B, L2.shape[-2], R2.shape[-3], 2)


def _nmse_rows(num_iters, oracle2):
    """(trace (num_iters, B), oracle energy (B,)), or (None, None)."""
    if oracle2 is None:
        return None, None
    return (torch.empty((num_iters, oracle2.shape[0]), dtype=torch.float32,
                        device=oracle2.device),
            cplx.sum_abs2(oracle2, dim=(-1, -2)))


def fista_l1_lifted(
    A2: torch.Tensor,
    Y2: torch.Tensor,
    L2: torch.Tensor,
    R2: torch.Tensor,
    lmbda,
    lr,
    num_iters: int = 1000,
    oracle2: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Batched FISTA for min_Z 1/2 ||A L Z R - Y||^2 + lambda ||Z||_1.

    A2 (B,Np,Nt,2), Y2 (B,Np,Nr,2), L2 (Nt,Zr,2), R2 (Zc,Nr,2), c2 on one
    device; lambda, lr scalar or (B,). Returns (H_hat (B,Nt,Nr,2),
    nmse_trace (num_iters, B) or None), on that device.

    The JAX package's scan (lasso.py:110) as iterations on static
    buffers (two for Z, which take turns as the last and the new iterate,
    so no iteration copies one into the other; the extrapolated W; the
    trace; an iteration counter, at which the momentum factor is read
    from the `fista_momentum` table), run by `_graph.run_steps`: on the
    card iterations 0 and 1 run eagerly, each buffer order is captured
    once in a CUDA graph, and the two graphs are replayed in turn for
    the other iterations. Bit for bit `fista_l1_lifted_plain`, the Python
    loop it replaces.
    """
    prox_grad, synth, shape = _fista_problem(A2, Y2, L2, R2, lmbda, lr)
    dev = A2.device
    coef = torch.from_numpy(fista_momentum(num_iters)).to(dev)
    Zs = [torch.zeros(shape, dtype=torch.float32, device=dev)
          for _ in range(2)]
    W = torch.zeros_like(Zs[0])  # the extrapolated point
    it = torch.zeros((), dtype=torch.int64, device=dev)
    trace, energy = _nmse_rows(num_iters, oracle2)
    row = it.view(1)

    def iteration(Z, Znew):
        prox_grad(W, out=Znew)
        # Znew + (t - 1)/tnew (Znew - Z); the factor, a device value,
        # multiplies as the loop's host float does (a vectorised pass)
        torch.sub(Znew, Z, out=W)
        torch._foreach_mul_([W], coef.index_select(0, row).view(()))
        W.add_(Znew)
        if trace is not None:
            err = cplx.sum_abs2(synth(Znew) - oracle2, dim=(-1, -2))
            trace.index_copy_(0, row, (err / energy).unsqueeze(0))
        it.add_(1)

    _graph.run_steps([lambda: iteration(*Zs), lambda: iteration(*Zs[::-1])],
                     num_iters, dev)
    return synth(Zs[num_iters % 2]), trace


def fista_l1_lifted_plain(
    A2: torch.Tensor,
    Y2: torch.Tensor,
    L2: torch.Tensor,
    R2: torch.Tensor,
    lmbda,
    lr,
    num_iters: int = 1000,
    oracle2: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`fista_l1_lifted` as a Python loop of eager iterations, the momentum
    factor a host float: the yardstick its graph is held against."""
    prox_grad, synth, shape = _fista_problem(A2, Y2, L2, R2, lmbda, lr)
    coef = fista_momentum(num_iters)
    trace, energy = _nmse_rows(num_iters, oracle2)
    Z = torch.zeros(shape, dtype=torch.float32, device=A2.device)
    W = Z  # the extrapolated point
    for it in range(num_iters):
        Znew = prox_grad(W)
        W = torch.sub(Znew, Z).mul_(float(coef[it])).add_(Znew)
        Z = Znew
        if trace is not None:
            trace[it] = cplx.sum_abs2(synth(Z) - oracle2,
                                      dim=(-1, -2)) / energy
    return synth(Z), trace


@dataclasses.dataclass
class LassoResults:
    """Mirror of the reference results.pt (test_l1Fourier_lifted.py:228-239)
    and of the JAX package's LassoResults."""

    nmse_log: np.ndarray  # (n_alpha, n_lmbda, n_lr, n_snr, n_channels)
    complete_log: np.ndarray  # (..., n_iters, n_channels) per-iter NMSE
    best_nmse: np.ndarray  # (n_alpha, n_snr)
    best_lmbda: np.ndarray
    best_lr: np.ndarray
    snr_range: np.ndarray
    alpha_range: np.ndarray
    lmbda_range: np.ndarray
    lr_range: np.ndarray

    def save(self, path: str) -> None:
        import os

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **dataclasses.asdict(self))


def run_lasso_baseline(
    config: Config,
    channel: str = "CDL-C",
    train_profile: Optional[str] = None,
    snr_range: Optional[np.ndarray] = None,
    alpha_range: Sequence[float] = (0.6,),
    lmbda_range: Sequence[float] = (0.3,),
    lr_range: Sequence[float] = (3e-3,),
    lifting: int = 4,
    num_iters: int = 1000,
    num_channels: int = 50,
    spacing: float = 0.5,
    train_seed: int = 1234,
    val_seed: int = 4321,
    seed: int = 7,
    chunk_size: Optional[int] = None,
    device=None,
    _channels: Optional[Sequence[int]] = None,
) -> LassoResults:
    """Reference defaults: SNR -10...30 step 5, lambda 0.3, lr 3e-3,
    lifting 4, 1000 iterations, 50 samples (test_l1Fourier_lifted.py:38-73).
    Pilots and measurement noise of pilot density i come from a CPU
    generator seeded by (seed, i); FISTA runs on `device` (None: the card).

    _channels: indices into the num_channels drawn; only these channels'
    rows are solved and reported (each row is solved on its own, so they
    match the same channels of a whole run).
    """
    dev = resolve_device(device)
    if snr_range is None:
        snr_range = np.arange(-10, 35, 5)  # test_l1Fourier_lifted.py:61
    snr_range = np.asarray(snr_range, np.float64)
    train_profile = train_profile or channel

    train_cfg = dataclasses.replace(config.data, channel=train_profile)
    train_ds = ChannelDataset(train_seed, train_cfg, norm="global")

    Ld, Rd = lifted_fourier_dicts(config.data.num_tx, config.data.num_rx,
                                  lifting)
    L2, R2 = cplx.from_complex(Ld).to(dev), cplx.from_complex(Rd).to(dev)

    nA = len(alpha_range)
    nL, nR, S = len(lmbda_range), len(lr_range), len(snr_range)
    n_out = num_channels if _channels is None else len(_channels)
    nmse_log = np.zeros((nA, nL, nR, S, n_out), np.float32)
    complete = np.zeros((nA, nL, nR, S, num_iters, n_out), np.float32)

    for i_al, alpha in enumerate(alpha_range):
        num_pilots = int(np.floor(config.data.num_tx * alpha))
        val_cfg = dataclasses.replace(
            config.data, channel=channel, spacing_list=(spacing,),
            num_channels=max(num_channels, config.data.num_channels))
        val_ds = ChannelDataset(val_seed, val_cfg,
                                norm=list(train_ds.norm_stats),
                                num_pilots=num_pilots)
        X2 = val_ds.hermitian_c2()[:num_channels]
        C = X2.shape[0]
        g = _generator(seed, i_al)
        A2 = cplx.conj_transpose(
            cplx.qpsk_pilots(g, C, config.data.num_tx, num_pilots))

        # flatten (lambda, lr, SNR, channel) into one batch
        npow = np.repeat(
            10.0 ** (-snr_range / 10.0) * config.data.num_tx, C
        ).astype(np.float32)  # noise*Nt (test_l1Fourier_lifted.py:69)
        A_sc = A2.repeat(S, 1, 1, 1)
        X_sc = X2.repeat(S, 1, 1, 1)
        Y_sc = physics.measure_c2(g, A_sc, X_sc, torch.from_numpy(npow))
        if _channels is not None:
            keep = (np.arange(S)[:, None] * C + np.asarray(_channels)).ravel()
            A_sc, X_sc, Y_sc = A_sc[keep], X_sc[keep], Y_sc[keep]
            C = len(_channels)
        G = nL * nR
        A_b, X_b, Y_b = (t.repeat(G, 1, 1, 1) for t in (A_sc, X_sc, Y_sc))
        lm_b = torch.from_numpy(np.repeat(np.repeat(lmbda_range, nR),
                                          S * C).astype(np.float32))
        lr_b = torch.from_numpy(np.repeat(np.tile(lr_range, nL),
                                          S * C).astype(np.float32))

        B = A_b.shape[0]
        chunk = chunk_size or B
        traces = []
        for start in range(0, B, chunk):
            sl = slice(start, start + chunk)
            _, tr = fista_l1_lifted(
                A_b[sl].to(dev), Y_b[sl].to(dev), L2, R2, lm_b[sl].to(dev),
                lr_b[sl].to(dev), num_iters=num_iters,
                oracle2=X_b[sl].to(dev))
            traces.append(tr.cpu().numpy())
        trace = np.concatenate(traces, axis=1)  # (iters, G*S*C)
        trace = trace.reshape(num_iters, nL, nR, S, C)
        complete[i_al] = np.transpose(trace, (1, 2, 3, 0, 4))
        nmse_log[i_al] = complete[i_al, ..., -1, :]

    # per-(alpha, SNR) best over the (lambda, lr) grid
    # (test_l1Fourier_lifted.py:191-211); a diverged combo never wins
    avg = nmse_log.mean(-1)  # (nA, nL, nR, S)
    avg = np.where(np.isfinite(avg), avg, np.inf)
    best_nmse = np.zeros((nA, S))
    best_lmbda = np.zeros((nA, S))
    best_lr = np.zeros((nA, S))
    for a in range(nA):
        for s in range(S):
            flat = avg[a, ..., s].ravel()
            i = int(np.argmin(flat))
            iL, iR = np.unravel_index(i, (nL, nR))
            best_nmse[a, s] = flat[i]
            best_lmbda[a, s] = lmbda_range[iL]
            best_lr[a, s] = lr_range[iR]

    return LassoResults(
        nmse_log=nmse_log, complete_log=complete, best_nmse=best_nmse,
        best_lmbda=best_lmbda, best_lr=best_lr, snr_range=snr_range,
        alpha_range=np.asarray(alpha_range),
        lmbda_range=np.asarray(lmbda_range), lr_range=np.asarray(lr_range))


def main(argv=None):
    """CLI: `lasso` with the JAX package's flags plus --device."""
    import argparse

    p = argparse.ArgumentParser(description="Lasso/fsAD lifted-Fourier CS")
    p.add_argument("--train", type=str, default="CDL-C")
    p.add_argument("--test", type=str, default="CDL-C")
    p.add_argument("--alpha", nargs="+", type=float, default=[0.6])
    p.add_argument("--lmbda", nargs="+", type=float, default=[0.3])
    p.add_argument("--lr", nargs="+", type=float, default=[3e-3])
    p.add_argument("--lifting", type=int, default=4)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--snr", nargs="+", type=float, default=None)
    p.add_argument("--num_channels", type=int, default=50)
    p.add_argument("--chunk", type=int, default=None)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--ray_coupling", type=str, default=None,
                   choices=["random", "fixed"],
                   help="dataset ensemble override (fixed = the "
                        "paper-matching per-drop coupling)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; --device cpu runs on "
                        "the CPU)")
    args = p.parse_args(argv)

    from ..config import default_score_config

    cfg = default_score_config(args.train, ray_coupling=args.ray_coupling)
    res = run_lasso_baseline(
        cfg, channel=args.test, train_profile=args.train,
        snr_range=np.asarray(args.snr) if args.snr else None,
        alpha_range=tuple(args.alpha), lmbda_range=tuple(args.lmbda),
        lr_range=tuple(args.lr), lifting=args.lifting, num_iters=args.steps,
        num_channels=args.num_channels, chunk_size=args.chunk,
        device=args.device)
    for a, al in enumerate(res.alpha_range):
        for s, snr in enumerate(res.snr_range):
            print(f"alpha {al} SNR {snr:6.1f} dB  NMSE "
                  f"{10 * np.log10(res.best_nmse[a, s]):7.2f} dB  "
                  f"(lambda {res.best_lmbda[a, s]:.1e}, lr "
                  f"{res.best_lr[a, s]:.1e})")
    out = args.output or (f"results/l1CS_lifted{args.lifting}/"
                          f"train-{args.train}_test-{args.test}.npz")
    res.save(out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
