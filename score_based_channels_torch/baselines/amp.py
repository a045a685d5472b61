"""EM-GM-AMP compressed-sensing baseline, the counterpart of the JAX
package's baselines/amp.py (the `amp` command, reference
matlab/test_em_gm_amp.m).

GAMP with a K-component Bernoulli-Gaussian-mixture prior whose parameters
(sparsity lambda, mixture weights omega_k, component variances phi_k,
noise variance psi) are learned online by EM: Vila & Schniter's
EM-GM-AMP in the heavy-tailed, zero-mean mode the reference configures
(`optEM.heavy_tailed = true`, test_em_gm_amp.m:55). `em_bg_amp` is the
K = 1 case. The recursion uses the uniform-variance simplification, so the
lifted operator F(Z) = A L Z R stays two small matmuls (the dictionary of
baselines/lasso.py), and the robust-GAMP step control of
test_em_gm_amp.m:57: a candidate step that raises the measurement residual
is rejected per sample and the damping halved.

Everything is batched over samples, on the run's device; on the card one
iteration is a CUDA graph, replayed for every iteration. The products run as complex64 matmuls on complex views
of the c2 tensors, the rest in c2 in the JAX package's order of operations: the accept/reject
decision compares two f32 sums, and a different rounding can flip it.
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
from .lasso import _nmse_rows, lifted_fourier_dicts

DAMP_MIN, DAMP_MAX, ACCEPT_TOL = 0.02, 0.95, 1.02


def _amp_problem(A2, Y2, L2, R2, num_components, init_sparsity,
                 init_var_spread):
    """(gamp_step, initial state, y_energy, synth) of EM-GM-AMP on A2's
    device: gamp_step(state, damp_t) -> (candidate state, residual), the
    state (Z, tau_x, s, lambda, omega, phi, psi) as new tensors."""
    dev = A2.device
    B, Np_, Nr = Y2.shape[0], Y2.shape[1], Y2.shape[2]
    Zr, Zc = L2.shape[-2], R2.shape[-3]
    N = Zr * Zc
    M = Np_ * Nr

    L, R = cplx.as_complex(L2), cplx.as_complex(R2)
    AL = cplx.as_complex(A2) @ L  # the dictionaries broadcast over the batch
    ALh, Rh = AL.mH, R.mH

    def fwd(Z2):
        return cplx.as_c2((AL @ torch.view_as_complex(Z2)) @ R)

    def adj(V2):
        return cplx.as_c2((ALh @ torch.view_as_complex(V2)) @ Rh)

    def synth(Z2):
        return cplx.as_c2((L @ torch.view_as_complex(Z2)) @ R)

    # per-coefficient operator energy (uniform-variance approximation)
    gA_s = (cplx.sum_abs2(cplx.as_c2(AL), dim=(-1, -2))
            * cplx.sum_abs2(R2, dim=(-1, -2))) / (M * N)  # (B,)
    y_energy = cplx.sum_abs2(Y2, dim=(-1, -2)) / M  # (B,)

    # EM init: noise from an SNR0 = 20 dB guess, signal variance from the
    # measurement energy, component variances spread around it
    K = int(num_components)
    psi = y_energy / 101.0
    lam = torch.full((B,), init_sparsity, dtype=torch.float32, device=dev)
    phi_bg = torch.clamp((y_energy - psi) / (gA_s * N * lam), min=1e-12)
    spread = torch.tensor(
        [init_var_spread ** (k - (K - 1) / 2.0) for k in range(K)],
        dtype=torch.float32, device=dev)
    phi = phi_bg[:, None] * spread[None, :]  # (B, K)
    omega = torch.full((B, K), 1.0 / K, dtype=torch.float32, device=dev)
    Z = torch.zeros((B, Zr, Zc, 2), dtype=torch.float32, device=dev)
    tau_x = (phi * omega).sum(-1) * lam  # per-coefficient prior variance
    s = torch.zeros((B, Np_, Nr, 2), dtype=torch.float32, device=dev)
    state = (Z, tau_x, s, lam, omega, phi, psi)

    def gamp_step(state, damp_t):
        Z, tau_x, s, lam, omega, phi, psi = state
        d3 = damp_t[:, None, None]         # (B,1,1)
        lamb = lam[:, None, None]
        phib = phi[:, None, None, :]       # (B,1,1,K)
        omegab = omega[:, None, None, :]   # (B,1,1,K)

        # output linear step: scalar variance per sample
        tau_p = torch.clamp(gA_s * N * tau_x, min=1e-12)  # (B,)
        p = fwd(Z) - cplx.scale(s, tau_p[:, None, None])
        # output nonlinear step (AWGN likelihood)
        denom = (tau_p + psi)[:, None, None]
        s_new = cplx.scale(Y2 - p, 1.0 / denom)
        s = cplx.scale(s, 1.0 - d3) + cplx.scale(s_new, d3)

        # input linear step: tau_r = (sum |A|^2 / denom)^-1 per coefficient
        tr2 = ((tau_p + psi) / (gA_s * M))[:, None, None]  # (B,1,1)
        r = Z + cplx.scale(adj(s), tr2)

        # Bernoulli-Gaussian-mixture denoiser (complex, zero means):
        # posterior over {null, comp 1..K} from log-domain responsibilities
        abs_r2 = cplx.abs2(r)              # (B, Zr, Zc)
        var1 = phib + tr2[..., None]       # (B,1,1,K)
        # ((log lam + log omega) - log var1) - |r|^2/var1: the first three
        # terms on (B,1,1,K), the last in place on the large quotient
        head = (torch.log(torch.clamp(lamb, min=1e-12))[..., None]
                + torch.log(torch.clamp(omegab, min=1e-12))
                - torch.log(var1))
        log_bk = (abs_r2[..., None] / var1).neg_().add_(head)  # (B,Zr,Zc,K)
        log_b0 = (torch.log(torch.clamp(1 - lamb, min=1e-12))
                  - torch.log(tr2) - abs_r2 / tr2)     # (B,Zr,Zc)
        log_all = torch.cat([log_b0[..., None], log_bk], dim=-1)
        # softmax as the JAX package computes it, exp(x - max) / sum, in
        # place (torch.softmax over a last axis of 1+K entries is slower on
        # the CPU)
        e = log_all.sub_(log_all.amax(dim=-1, keepdim=True)).exp_()
        post = e.div_(e.sum(dim=-1, keepdim=True))     # (B,Zr,Zc,1+K)
        pi_k = post[..., 1:]

        gain_k = phib / var1                           # (B,1,1,K)
        nu_k = gain_k * tr2[..., None]                 # posterior var per comp
        mean_gain = (pi_k * gain_k).sum(-1)            # (B,Zr,Zc)
        x_mmse = cplx.scale(r, mean_gain)
        second_k = (gain_k ** 2 * abs_r2[..., None]).add_(nu_k).mul_(pi_k)
        second = second_k.sum(-1)
        var_x = second - cplx.abs2(x_mmse)
        Z = cplx.scale(Z, 1.0 - d3) + cplx.scale(x_mmse, d3)
        tau_x_new = var_x.mean(dim=(-1, -2))
        tau_x = (1.0 - damp_t) * tau_x + damp_t * tau_x_new

        # EM parameter updates (Vila & Schniter, zero-mean components)
        sum_pik = pi_k.sum(dim=(1, 2))                 # (B,K)
        sum_pi = torch.clamp(sum_pik.sum(-1), min=1e-6)
        lam = torch.clamp(sum_pi / (Zr * Zc), 1e-5, 1.0 - 1e-5)
        omega = sum_pik / sum_pi[:, None]
        phi = second_k.sum(dim=(1, 2)) / torch.clamp(sum_pik, min=1e-6)
        resid = cplx.sum_abs2(Y2 - fwd(Z), dim=(-1, -2)) / M
        psi = torch.clamp(resid, min=1e-12)
        return (Z, tau_x, s, lam, omega, phi, psi), resid

    return gamp_step, state, y_energy, synth


def _accept(state, cand, resid_cand, resid_prev, damp_t):
    """The robust-GAMP step control (test_em_gm_amp.m:57) per sample:
    accept an improving step, or any step once the damping has bottomed
    out (else an identical candidate is rejected forever); raise the
    damping factor after an accepted step, halve it after a rejected one.
    -> (state, resid_prev, damp_t) of the next iteration."""
    B = damp_t.shape[0]
    accept = ((resid_cand <= resid_prev * ACCEPT_TOL)
              | (damp_t <= DAMP_MIN))  # (B,)
    state = tuple(
        torch.where(accept.reshape((B,) + (1,) * (new.dim() - 1)), new, old)
        for new, old in zip(cand, state))
    return (state, torch.where(accept, resid_cand, resid_prev),
            torch.where(accept, torch.clamp(damp_t * 1.1, max=DAMP_MAX),
                        torch.clamp(damp_t * 0.5, min=DAMP_MIN)))


def em_gm_amp(
    A2: torch.Tensor,  # (B, Np, Nt, 2) measurement operator (pilots)
    Y2: torch.Tensor,  # (B, Np, Nr, 2)
    L2: torch.Tensor,  # (Nt, Zr, 2) left dictionary
    R2: torch.Tensor,  # (Zc, Nr, 2) right dictionary
    num_iters: int = 50,
    num_components: int = 3,
    damp: float = 0.7,
    oracle2: Optional[torch.Tensor] = None,
    init_sparsity: float = 0.05,
    init_var_spread: float = 10.0,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Batched EM-GM-AMP on A2's device. Returns (H_hat (B,Nt,Nr,2),
    nmse_trace (num_iters, B) or None).

    Prior per coefficient: p(z) = (1-lambda) delta(z) + lambda sum_k
    omega_k CN(z; 0, phi_k); lambda, omega, phi and psi are re-estimated by
    EM each iteration. Component variances start geometrically spread
    (factor init_var_spread) around the moment-matched BG estimate. The
    operator's squared gain per coefficient is approximated by
    ||A L||_F^2 ||R||_F^2 / (M N) (exact for row-orthogonal dictionaries).

    The JAX package's scan (amp.py:213) as one iteration on static
    buffers (the state, the damping, the last residual, the trace, an
    iteration counter), run by `_graph.run_steps`: on the card iteration
    0 runs eagerly, one iteration is captured in a CUDA graph and
    replayed for the others. Bit for bit `em_gm_amp_plain`, the Python
    loop it replaces.
    """
    gamp_step, state, y_energy, synth = _amp_problem(
        A2, Y2, L2, R2, num_components, init_sparsity, init_var_spread)
    dev = A2.device
    damp_t = torch.full((A2.shape[0],), damp, dtype=torch.float32, device=dev)
    resid_prev = y_energy.clone()
    bufs = (*state, resid_prev, damp_t)
    it = torch.zeros((), dtype=torch.int64, device=dev)
    trace, energy = _nmse_rows(num_iters, oracle2)

    def iteration():
        new, resid, damp_new = _accept(state, *gamp_step(state, damp_t),
                                       resid_prev, damp_t)
        for buf, v in zip(bufs, (*new, resid, damp_new)):
            buf.copy_(v)
        if trace is not None:
            err = cplx.sum_abs2(synth(state[0]) - oracle2, dim=(-1, -2))
            trace.index_copy_(0, it.view(1), (err / energy).unsqueeze(0))
        it.add_(1)

    _graph.run_steps([iteration], num_iters, dev)
    return synth(state[0]), trace


def em_gm_amp_plain(
    A2: torch.Tensor,
    Y2: torch.Tensor,
    L2: torch.Tensor,
    R2: torch.Tensor,
    num_iters: int = 50,
    num_components: int = 3,
    damp: float = 0.7,
    oracle2: Optional[torch.Tensor] = None,
    init_sparsity: float = 0.05,
    init_var_spread: float = 10.0,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`em_gm_amp` as a Python loop of eager iterations: the yardstick its
    graph is held against."""
    gamp_step, state, resid_prev, synth = _amp_problem(
        A2, Y2, L2, R2, num_components, init_sparsity, init_var_spread)
    damp_t = torch.full((A2.shape[0],), damp, dtype=torch.float32,
                        device=A2.device)
    trace, energy = _nmse_rows(num_iters, oracle2)
    for it in range(num_iters):
        state, resid_prev, damp_t = _accept(
            state, *gamp_step(state, damp_t), resid_prev, damp_t)
        if trace is not None:
            trace[it] = cplx.sum_abs2(synth(state[0]) - oracle2,
                                      dim=(-1, -2)) / energy
    return synth(state[0]), trace


def em_bg_amp(A2: torch.Tensor, Y2: torch.Tensor, L2: torch.Tensor,
              R2: torch.Tensor, **kwargs
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """EM-BG-AMP: the K = 1 (Bernoulli-Gaussian) case of EM-GM-AMP."""
    return em_gm_amp(A2, Y2, L2, R2, num_components=1, **kwargs)


@dataclasses.dataclass
class AMPResults:
    nmse_trace: np.ndarray  # (n_snr, n_iters, n_channels)
    snr_range: np.ndarray

    def best_db(self) -> np.ndarray:
        avg = self.nmse_trace.mean(-1)
        avg = np.where(np.isfinite(avg), avg, np.inf)
        return 10 * np.log10(avg.min(-1))

    def save(self, path: str) -> None:
        import os

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **dataclasses.asdict(self))


def run_amp_baseline(
    config: Config,
    channel: str = "CDL-C",
    snr_range: Optional[np.ndarray] = None,
    pilot_alpha: float = 0.6,
    lifting: int = 4,
    num_iters: int = 50,
    num_components: int = 3,
    num_channels: int = 50,
    spacing: float = 0.5,
    train_seed: int = 1234,
    val_seed: int = 4321,
    seed: int = 13,
    device=None,
    _channels: Optional[Sequence[int]] = None,
) -> AMPResults:
    """EM-GM-AMP over the SNR grid (test_em_gm_amp.m: NMSE per EM
    iteration, lifted Fourier dictionary, noise = 10^(-SNR/10) Nt). Pilots
    and measurement noise come from a CPU generator seeded by (seed, 0);
    the iterations run on `device` (None: the card).

    _channels: indices into the num_channels drawn; only these channels'
    rows are run and reported (the recursion and its EM updates are per
    row, so they match the same channels of a whole run)."""
    dev = resolve_device(device)
    if snr_range is None:
        snr_range = np.arange(-10, 35, 5)
    snr_range = np.asarray(snr_range, np.float64)

    train_cfg = dataclasses.replace(config.data, channel=channel)
    train_ds = ChannelDataset(train_seed, train_cfg, norm="global")
    num_pilots = int(np.floor(config.data.num_tx * pilot_alpha))
    val_cfg = dataclasses.replace(
        config.data, channel=channel, spacing_list=(spacing,),
        num_channels=max(num_channels, config.data.num_channels))
    val_ds = ChannelDataset(val_seed, val_cfg, norm=list(train_ds.norm_stats),
                            num_pilots=num_pilots)

    Ld, Rd = lifted_fourier_dicts(config.data.num_tx, config.data.num_rx,
                                  lifting)
    L2, R2 = cplx.from_complex(Ld).to(dev), cplx.from_complex(Rd).to(dev)

    X2 = val_ds.hermitian_c2()[:num_channels]
    C = X2.shape[0]
    g = _generator(seed, 0)
    A2 = cplx.conj_transpose(
        cplx.qpsk_pilots(g, C, config.data.num_tx, num_pilots))

    S = len(snr_range)
    npow = np.repeat(10.0 ** (-snr_range / 10.0) * config.data.num_tx,
                     C).astype(np.float32)
    A_b = A2.repeat(S, 1, 1, 1)
    X_b = X2.repeat(S, 1, 1, 1)
    Y_b = physics.measure_c2(g, A_b, X_b, torch.from_numpy(npow))
    if _channels is not None:
        keep = (np.arange(S)[:, None] * C + np.asarray(_channels)).ravel()
        A_b, X_b, Y_b = A_b[keep], X_b[keep], Y_b[keep]
        C = len(_channels)

    _, trace = em_gm_amp(A_b.to(dev), Y_b.to(dev), L2, R2,
                         num_iters=num_iters, num_components=num_components,
                         oracle2=X_b.to(dev))
    trace = trace.cpu().numpy().reshape(num_iters, S, C)
    return AMPResults(nmse_trace=np.transpose(trace, (1, 0, 2)),
                      snr_range=snr_range)


def main(argv=None):
    """CLI: `amp` with the JAX package's flags plus --device."""
    import argparse

    p = argparse.ArgumentParser(description="EM-GM-AMP baseline")
    p.add_argument("--train", type=str, default="CDL-C")
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--components", type=int, default=3,
                   help="GM components K (K=1 = EM-BG-AMP)")
    p.add_argument("--num_channels", type=int, default=50)
    p.add_argument("--snr", nargs="+", type=float, default=None)
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
    res = run_amp_baseline(
        cfg, channel=args.train, num_iters=args.iters,
        num_components=args.components,
        snr_range=np.asarray(args.snr) if args.snr else None,
        num_channels=args.num_channels, device=args.device)
    for s, snr in enumerate(res.snr_range):
        print(f"SNR {snr:6.1f} dB  NMSE {res.best_db()[s]:7.2f} dB")
    out = args.output or f"results/amp/{args.train}.npz"
    res.save(out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
