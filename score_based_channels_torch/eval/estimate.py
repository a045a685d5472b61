"""SNR-sweep channel estimation harness, the counterpart of
the JAX package's eval/estimate.py:34-628 (the `estimate` command).

{SNR points x channels} are flattened into one batch with per-sample noise
powers and hyper-parameters, run through the c2 posterior sampler in
chunks of one shape, and the per-step NMSE trace comes back in the
reference's (spacing, pilot_alpha, snr, step, channel) layout.

Random draws: the JAX package splits a key; here every draw comes from a
`torch.Generator` seeded from (seed, purpose) with numpy's SeedSequence.
Pilots, inits and measurement noise are drawn on the CPU, so they are the
same on every device; the Langevin noise is drawn on the run's device.
"""

from __future__ import annotations

import copy
import dataclasses
import sys
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import cplx, physics
from .._device import resolve_device
from ..config import Config
from ..data.dataset import ChannelDataset
from ..diffusion.sampling import PosteriorRunner
from ..diffusion.sigmas import sigmas_from_config, subsample_schedule
from ..parallel.mesh import pad_to_multiple
from ..utils.spans import span


def derive_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for the stream named by (seed, *path)."""
    return int(np.random.SeedSequence([seed, *path]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def _generator(seed: int, *path: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive_seed(seed, *path))


def score_fn_from_params(model: torch.nn.Module,
                         dtype: Optional[torch.dtype] = None
                         ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Bind a loaded model -> score_fn(x_nhwc_c2, sigma) for the sampler.

    dtype: optional network compute dtype (e.g. torch.bfloat16). The
    parameters are cast ONCE, into a copy of the model, and the input is
    cast at the boundary; the model returns f32, so the Langevin state
    stays f32.
    """
    if dtype is not None and dtype != torch.float32:
        model = copy.deepcopy(model).to(dtype)
    net_dtype = dtype or torch.float32
    model.eval()

    @torch.no_grad()
    def score_fn(x, sigma):
        return model(x.to(net_dtype), sigma)

    return score_fn


def load_score_fn(path: str, device, dtype: Optional[torch.dtype] = None):
    """A checkpoint of either package -> (config, score_fn) on `device`,
    with the EMA parameters where the checkpoint has them."""
    from ..models import jax_params_to_state_dict, make_score_model
    from ..utils.checkpoint import load_checkpoint

    ck = load_checkpoint(path)
    config = ck["config"]
    model = make_score_model(config.model, config.data.channels,
                             device=device)
    params = ck["ema"] if ck["ema"] is not None else ck["params"]
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return config, score_fn_from_params(model, dtype=dtype)


def langevin_chunked(
    score_fn,
    A2: torch.Tensor,
    Y2: torch.Tensor,
    sigmas: torch.Tensor,
    noise_power,
    x2_init: torch.Tensor,
    seed: int,
    alpha_step,
    beta_noise,
    steps_each: int = 3,
    oracle2: Optional[torch.Tensor] = None,
    chunk_size: Optional[int] = None,
    capture_level=None,
    start_level=None,
    coef_cap=None,
    device=None,
    mesh=None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Run the c2 posterior sampler over a large batch in chunks of one
    shape (the ragged tail is padded) on `device` (None: the card).

    Returns host arrays (x_final complex64 (B,Nt,Nr), nmse_log (L*S, B) or
    None); with capture_level (B,) the estimates are the per-sample
    early-stopped iterates; coef_cap (scalar or (B,)) caps the
    data-consistency coefficient as the sampler's does. Chunk k draws its
    Langevin noise from a generator seeded by (seed, first row of the
    chunk).

    mesh (parallel.mesh.Mesh): each rank runs its rows of every chunk
    (the chunk padded to a multiple of the ranks) and the traces and
    estimates are all-gathered back into row order, on every rank. Each
    rank draws the whole chunk's Langevin noise and keeps its rows, so at
    a given chunk_size a row's trace does not depend on the world size.

    One `PosteriorRunner` serves every chunk of the call, as one compiled
    executable serves every chunk in the JAX package: on the card its
    level is captured once, at the first chunk, and replayed for every
    level of every chunk. Before each chunk the chunk's inputs are copied
    into its buffers and its one generator is re-seeded, so each chunk
    draws what a generator of its own would. A later call captures anew
    (after training has changed the network, say).
    """
    dev = resolve_device(device)
    B = x2_init.shape[0]
    chunk = chunk_size or B

    def per(v, dtype=torch.float32):
        return torch.broadcast_to(torch.as_tensor(v, dtype=dtype), (B,))

    noise_power = per(noise_power)
    alpha_step, beta_noise = per(alpha_step), per(beta_noise)
    capture_level = (per(capture_level, torch.int64)
                     if capture_level is not None else None)
    start_level = (per(start_level, torch.int64)
                   if start_level is not None else None)
    coef_cap = per(coef_cap) if coef_cap is not None else None

    noise_rows = None
    if mesh is not None:  # this rank's rows of each chunk
        world = mesh.world_size
        rows = mesh.rows(-(-chunk // world) * world)
        noise_rows = (chunk, torch.arange(rows.start, rows.stop,
                                          device=dev).clamp_max(chunk - 1))
    runner = PosteriorRunner(score_fn, sigmas, torch.Generator(device=dev),
                             steps_each=steps_each, noise_rows=noise_rows)

    t0 = time.perf_counter()
    finals, traces = [], []
    for start in range(0, B, chunk):
        if start:
            rate = start / (time.perf_counter() - t0)
            print(f"# langevin {start}/{B} ({rate:.1f} est/s)",
                  file=sys.stderr, flush=True)
        sl = slice(start, min(start + chunk, B))
        n_valid = sl.stop - sl.start
        with span("sweep.pad"):
            parts = [A2[sl], Y2[sl], noise_power[sl], x2_init[sl],
                     alpha_step[sl], beta_noise[sl],
                     oracle2[sl] if oracle2 is not None else None,
                     capture_level[sl] if capture_level is not None else None,
                     start_level[sl] if start_level is not None else None,
                     coef_cap[sl] if coef_cap is not None else None]
            parts = [None if p is None else pad_to_multiple(p, chunk)[0]
                     for p in parts]
            if mesh is not None:
                parts = [None if p is None else
                         pad_to_multiple(p, world)[0][rows] for p in parts]
            a, y, npow, x0, al, be, orc, cap, slv, ccap = (
                None if p is None else p.to(dev) for p in parts)
        runner.generator.manual_seed(derive_seed(seed, start))
        xf2, trace = runner.run(
            a, y, npow, x0, al, be, oracle=orc, capture_level=cap,
            start_level=slv, coef_cap=ccap)
        if mesh is not None:
            xf2 = mesh.gather(xf2)
            trace = None if trace is None else mesh.gather(trace, dim=1)
        with span("sweep.readback"):
            finals.append(cplx.to_complex(xf2)[:n_valid])
            if trace is not None:
                # a copy: on the CPU .cpu() is the runner's buffer itself
                traces.append(trace.cpu().numpy()[:, :n_valid].copy())
    x_final = np.concatenate(finals, axis=0)
    nmse_log = np.concatenate(traces, axis=1) if traces else None
    return x_final, nmse_log


@dataclasses.dataclass
class EstimationResults:
    """Mirror of the reference results.pt dict (test_score.py:192-200);
    the saved .npz is the JAX package's format."""

    nmse_log: np.ndarray  # (n_spacing, n_alpha, n_snr, n_steps, n_channels)
    avg_nmse: np.ndarray  # mean over channels
    best_nmse: np.ndarray  # min over steps (n_spacing, n_alpha, n_snr)
    snr_range: np.ndarray
    spacing_range: np.ndarray
    pilot_alpha_range: np.ndarray

    def best_nmse_db(self) -> np.ndarray:
        return 10.0 * np.log10(self.best_nmse)

    def save(self, path: str) -> None:
        import os

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **dataclasses.asdict(self))

    @classmethod
    def load(cls, path: str) -> "EstimationResults":
        with np.load(path) as f:
            return cls(**{k: f[k] for k in f.files})


def run_snr_sweep(
    score_fn,
    config: Config,
    val_dataset: ChannelDataset,
    snr_range: np.ndarray,
    seed: int,
    num_channels: int = 100,
    alpha_step=None,
    beta_noise=None,
    chunk_size: Optional[int] = None,
    stop_steps=None,
    return_estimates: bool = False,
    level_stride: int = 1,
    init: str = "noise",
    sigma_start: Optional[float] = None,
    init_cov: Optional[np.ndarray] = None,
    auto_threshold: float = 1.15,
    auto_calib: Optional[np.ndarray] = None,
    device=None,
    mesh=None,
):
    """One (spacing, pilot_alpha) sweep -> nmse (n_snr, n_steps, n_channels).

    Semantics of the JAX run_snr_sweep (test_score.py:107-171): channels
    and the Langevin init fixed across SNR, fresh measurement noise per
    SNR, per-step NMSE trace. init in {"noise", "ls", "lmmse", "auto"}; see
    the JAX docstring for the warm-start and residual-gated auto protocols.
    mesh: split each chunk's rows over the ranks (`langevin_chunked`).
    """
    dev = resolve_device(device)
    cfg = config
    sampling = cfg.sampling
    sigmas = sigmas_from_config(cfg.model)
    alpha_step = sampling.alpha_step if alpha_step is None else alpha_step
    beta_noise = sampling.beta_noise if beta_noise is None else beta_noise
    alpha_scale = 1.0
    if level_stride > 1:  # shortcut inference (speed/quality knob)
        sigmas, alpha_scale = subsample_schedule(sigmas, level_stride)
        alpha_step = np.asarray(alpha_step) * alpha_scale
        if stop_steps is not None:
            stop_steps = np.asarray(stop_steps) // level_stride
    sig_np = sigmas.numpy()
    if sigma_start is not None and init != "auto":
        k0 = int(np.searchsorted(-sig_np, -float(sigma_start)))
        if k0 >= sig_np.shape[0]:
            raise ValueError(
                f"sigma_start={sigma_start} truncates the whole schedule "
                f"(sigma_end={float(sig_np[-1]):.2e})")
        sigmas, sig_np = sigmas[k0:], sig_np[k0:]
        if stop_steps is not None:
            stop_steps = np.maximum(
                np.asarray(stop_steps) - k0 * sampling.steps_each, 0)

    with span("sweep.draws"):
        g = _generator(seed, 0)  # pilots, init, measurement noise: CPU draws
        X2 = val_dataset.hermitian_c2(normalized=True)[:num_channels]
        C = X2.shape[0]
        P2 = cplx.qpsk_pilots(g, C, cfg.data.num_tx, val_dataset.num_pilots)
        A2 = cplx.conj_transpose(P2)
        x2_init = cplx.randn(g, X2.shape[:-1])  # same init for every SNR

        S = len(snr_range)
        noise_powers = np.asarray(
            physics.snr_to_noise_power(np.asarray(snr_range), cfg.data.num_tx))
        A_b = A2.repeat(S, 1, 1, 1)
        X_b = X2.repeat(S, 1, 1, 1)
        x0_b = x2_init.repeat(S, 1, 1, 1)
        npow_b = torch.from_numpy(
            np.repeat(noise_powers.astype(np.float32), C))
        al_b = torch.from_numpy(np.broadcast_to(
            np.asarray(alpha_step, np.float32), (S,)).repeat(C))
        be_b = torch.from_numpy(np.broadcast_to(
            np.asarray(beta_noise, np.float32), (S,)).repeat(C))
        Y_b = physics.measure_c2(g, A_b, X_b, npow_b)

        start_b = None
        matched = None
        if init == "ls":
            from ..baselines.ls import ls_estimate

            x0_b = ls_estimate(A_b.to(dev), Y_b.to(dev), npow_b.to(dev)).cpu()
        elif init == "lmmse":
            from ..baselines.lmmse import lmmse_estimate_c2

            if init_cov is None:
                raise ValueError("init='lmmse' requires init_cov")
            x0_b = torch.from_numpy(
                lmmse_estimate_c2(A_b, Y_b, npow_b, init_cov)[0])
        elif init == "auto":
            # residual-gated choice per sample between the LMMSE warm start
            # and the full noise anneal (estimate.py:274-338 of the JAX
            # package)
            from ..baselines.lmmse import lmmse_estimate_c2

            if init_cov is None:
                raise ValueError("init='auto' requires init_cov")
            ss = 0.05 if sigma_start is None else float(sigma_start)
            k0 = int(np.searchsorted(-sig_np, -ss))
            x0_lm = torch.from_numpy(
                lmmse_estimate_c2(A_b, Y_b, npow_b, init_cov)[0])
            resid = cplx.sum_abs2(cplx.matmul(A_b, x0_lm) - Y_b,
                                  dim=(-1, -2)).numpy()
            Np_, Nr_ = A_b.shape[1], Y_b.shape[2]
            r_norm = resid / (npow_b.numpy() * Np_ * Nr_)
            if auto_calib is not None:
                gc = _generator(seed, 777)
                Cc = auto_calib.shape[0]
                Pc = cplx.qpsk_pilots(gc, Cc, A_b.shape[2],
                                      val_dataset.num_pilots)
                Ac = cplx.conj_transpose(Pc).repeat(S, 1, 1, 1)
                Xc = torch.as_tensor(np.asarray(auto_calib)).repeat(S, 1, 1, 1)
                npc = np.repeat(noise_powers.astype(np.float32), Cc)
                Yc = physics.measure_c2(gc, Ac, Xc, torch.from_numpy(npc))
                xc = torch.from_numpy(
                    lmmse_estimate_c2(Ac, Yc, npc, init_cov)[0])
                rc = cplx.sum_abs2(cplx.matmul(Ac, xc) - Yc,
                                   dim=(-1, -2)).numpy()
                pred = (rc / (npc * Np_ * Nr_)).reshape(S, Cc).mean(-1)
                ratio = r_norm / np.repeat(pred, C)
                matched = (ratio < auto_threshold) & (r_norm < 2.0)
            else:  # uncalibrated: absolute threshold
                matched = r_norm < max(auto_threshold, 1.2)
            m_t = torch.from_numpy(matched)
            x0_b = torch.where(m_t[:, None, None, None], x0_lm, x0_b)
            start_b = torch.where(m_t, k0, 0)
            al_b = torch.where(m_t, torch.tensor(
                sampling.alpha_step * alpha_scale, dtype=torch.float32), al_b)
            be_b = torch.where(m_t, torch.tensor(sampling.beta_noise,
                                                 dtype=torch.float32), be_b)
            print(f"# auto protocol: {int(matched.sum())}/{matched.size} "
                  f"samples warm-started (residual median "
                  f"{float(np.median(r_norm)):.2f}, threshold "
                  f"{auto_threshold})", file=sys.stderr, flush=True)
        elif init != "noise":
            raise ValueError(init)

        cap_b = None
        if stop_steps is not None:  # per-SNR early stop, trailing-step units
            levels = np.asarray(stop_steps, np.int64) // sampling.steps_each
            cap_b = torch.from_numpy(np.repeat(levels, C))
            if matched is not None:  # warm chains run to the final level
                cap_b = torch.where(torch.from_numpy(matched),
                                    len(sig_np) - 1, cap_b)

    x_hat, trace = langevin_chunked(
        score_fn, A_b, Y_b, sigmas, npow_b, x0_b, derive_seed(seed, 1),
        al_b, be_b, steps_each=sampling.steps_each, oracle2=X_b,
        chunk_size=chunk_size, capture_level=cap_b, start_level=start_b,
        device=dev, mesh=mesh)
    n_steps = trace.shape[0]  # (L*steps, S*C) -> (S, steps, C)
    nmse = np.transpose(trace.reshape(n_steps, S, C), (1, 0, 2))
    if return_estimates:
        return nmse, x_hat.reshape(S, C, *x_hat.shape[1:])
    return nmse


def run_estimation(
    score_fn,
    config: Config,
    train_profile: str = "CDL-C",
    test_profile: str = "CDL-C",
    snr_range: Optional[np.ndarray] = None,
    spacing_range: Sequence[float] = (0.5,),
    pilot_alpha_range: Sequence[float] = (0.6,),
    num_channels: int = 100,
    train_seed: int = 1234,
    val_seed: int = 4321,
    seed: int = 2023,
    alpha_step=None,
    beta_noise=None,
    chunk_size: Optional[int] = None,
    stop_steps=None,
    save_channels_to: Optional[str] = None,
    level_stride: int = 1,
    init: str = "noise",
    sigma_start: Optional[float] = None,
    auto_threshold: float = 1.15,
    device=None,
    mesh=None,
) -> EstimationResults:
    """test_score.py's protocol, including cross-distribution (OOD) eval:
    train_profile fixes the normalisation stats and the LMMSE covariance,
    test_profile selects the evaluated channels. Runs on `device` (None:
    the card); mesh splits every chunk over the ranks (`langevin_chunked`)."""
    dev = resolve_device(device)
    if snr_range is None:
        snr_range = np.arange(-10, 32.5, 2.5)  # test_score.py:72
    snr_range = np.asarray(snr_range, np.float64)

    train_cfg = dataclasses.replace(config.data, channel=train_profile)
    train_ds = ChannelDataset(train_seed, train_cfg,
                              norm=config.data.norm_channels)
    init_cov = auto_calib = None
    if init in ("lmmse", "auto"):
        from ..baselines.lmmse import empirical_covariance

        init_cov = empirical_covariance(train_ds)
        if init == "auto":  # train-set channels for the residual calibration
            auto_calib = train_ds.hermitian_c2(normalized=True)[:64].numpy()

    n_sp, n_al, S = len(spacing_range), len(pilot_alpha_range), len(snr_range)
    sig_full = sigmas_from_config(config.model)
    if level_stride > 1:
        sig_full = subsample_schedule(sig_full, level_stride)[0]
    sig_full = sig_full.numpy()
    if sigma_start is not None and init != "auto":
        sig_full = sig_full[int(np.searchsorted(-sig_full,
                                                -float(sigma_start))):]
    n_steps = sig_full.shape[0] * config.sampling.steps_each
    nmse_log = np.zeros((n_sp, n_al, S, n_steps, num_channels), np.float32)

    saved_est, saved_oracle = {}, {}
    for i_sp, spacing in enumerate(spacing_range):
        for i_al, pilot_alpha in enumerate(pilot_alpha_range):
            num_pilots = int(np.floor(config.data.num_tx * pilot_alpha))
            val_cfg = dataclasses.replace(
                config.data, channel=test_profile, spacing_list=(spacing,),
                num_channels=max(num_channels, config.data.num_channels))
            val_ds = ChannelDataset(val_seed, val_cfg,
                                    norm=list(train_ds.norm_stats),
                                    num_pilots=num_pilots)
            out = run_snr_sweep(
                score_fn, config, val_ds, snr_range,
                derive_seed(seed, i_sp * n_al + i_al),
                num_channels=num_channels, alpha_step=alpha_step,
                beta_noise=beta_noise, chunk_size=chunk_size,
                stop_steps=stop_steps, level_stride=level_stride,
                init=init, sigma_start=sigma_start, init_cov=init_cov,
                auto_threshold=auto_threshold, auto_calib=auto_calib,
                return_estimates=save_channels_to is not None, device=dev,
                mesh=mesh)
            if save_channels_to is not None:
                nmse_log[i_sp, i_al], est = out
                tag = f"sp{i_sp}_al{i_al}"
                saved_est[f"est_{tag}"] = est
                saved_oracle[f"oracle_{tag}"] = val_ds.hermitian(
                    normalized=True)[:num_channels]
            else:
                nmse_log[i_sp, i_al] = out
    if save_channels_to is not None:
        import os

        os.makedirs(os.path.dirname(save_channels_to) or ".", exist_ok=True)
        np.savez(save_channels_to, snr_range=snr_range,
                 spacing_range=np.asarray(spacing_range),
                 pilot_alpha_range=np.asarray(pilot_alpha_range),
                 **saved_est, **saved_oracle)

    avg = nmse_log.mean(axis=-1)  # test_score.py:174
    best = avg.min(axis=-1)  # test_score.py:175
    return EstimationResults(
        nmse_log=nmse_log, avg_nmse=avg, best_nmse=best,
        snr_range=snr_range, spacing_range=np.asarray(spacing_range),
        pilot_alpha_range=np.asarray(pilot_alpha_range))


def main(argv=None):
    """CLI: `estimate` with the JAX package's flags plus --device
    (reference `test_score --train --test --spacing --pilot_alpha`)."""
    import argparse

    p = argparse.ArgumentParser(description="Score-based channel estimation")
    p.add_argument("--train", type=str, default="CDL-C")
    p.add_argument("--test", type=str, default="CDL-C")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="default models/score/<train>/final_model.npz")
    p.add_argument("--spacing", nargs="+", type=float, default=[0.5])
    p.add_argument("--pilot_alpha", nargs="+", type=float, default=[0.6])
    p.add_argument("--snr", nargs="+", type=float, default=None)
    p.add_argument("--num_channels", type=int, default=100)
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--hparams", type=str, default=None,
                   help="tuner output npz: use per-SNR best (alpha, beta) "
                        "and report known-SNR stopping-step NMSE")
    p.add_argument("--blind", action="store_true",
                   help="with --hparams, use the tuner's single blind "
                        "(alpha, beta) for every SNR point and report the "
                        "NMSE at the one blind stopping step")
    p.add_argument("--stride", type=int, default=1,
                   help="shortcut inference: keep every k-th sigma level "
                        "(alpha scaled by k)")
    p.add_argument("--init", type=str, default=None,
                   choices=["noise", "ls", "lmmse", "auto"],
                   help="chain initialization; default 'auto' ('noise' "
                        "under --blind)")
    p.add_argument("--auto_threshold", type=float, default=1.15,
                   help="residual-ratio threshold of --init auto")
    p.add_argument("--sigma_start", type=float, default=None,
                   help="truncate the sigma schedule at this level (default "
                        "0.05 when --init != noise)")
    p.add_argument("--save_channels", type=str, default=None,
                   help="save estimated + oracle channels to this npz")
    p.add_argument("--output", type=str, default=None,
                   help="default results/score/train-<tr>_test-<te>/results.npz")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="score-network compute dtype (the Langevin state "
                        "stays f32)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; --device cpu runs the "
                        "plain PyTorch path)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    ckpt_path = args.checkpoint or f"models/score/{args.train}/final_model.npz"
    config, score_fn = load_score_fn(ckpt_path, dev,
                                     dtype=getattr(torch, args.dtype))

    if args.init is None:
        args.init = "noise" if args.blind else "auto"
    elif args.blind and args.init == "auto":
        p.error("--blind is incompatible with --init auto (blind stop "
                "steps apply to the homogeneous noise-anneal protocol); "
                "use --init noise")

    alpha_step = beta_noise = stop_steps = blind_step = None
    snr_range = np.asarray(args.snr) if args.snr else None
    if args.blind and not args.hparams:
        p.error("--blind requires --hparams (the tuner's blind selection)")
    if args.hparams:
        with np.load(args.hparams) as h:
            if args.blind:
                alpha_step = float(h["blind_alpha"])
                beta_noise = float(h["blind_beta"])
                blind_step = int(h["blind_step"])
            else:
                alpha_step = h["best_alpha_snr"]
                beta_noise = h["best_beta_snr"]
                stop_steps = h["best_step_snr"]
            if snr_range is None:
                snr_range = h["snr_range"]

    sigma_start = args.sigma_start
    if sigma_start is None and args.init != "noise":
        sigma_start = 0.05
    res = run_estimation(
        score_fn, config, train_profile=args.train, test_profile=args.test,
        snr_range=snr_range, spacing_range=tuple(args.spacing),
        pilot_alpha_range=tuple(args.pilot_alpha),
        num_channels=args.num_channels,
        chunk_size=args.chunk, alpha_step=alpha_step, beta_noise=beta_noise,
        stop_steps=stop_steps, save_channels_to=args.save_channels,
        level_stride=args.stride, init=args.init, sigma_start=sigma_start,
        auto_threshold=args.auto_threshold, device=dev)

    out = args.output or (f"results/score/train-{args.train}_test-{args.test}"
                          "/results.npz")
    res.save(out)
    # the tuner's stop steps index the full schedule's trace; map them onto
    # this run's strided and truncated trace as run_snr_sweep maps them
    sig = sigmas_from_config(config.model)
    if args.stride > 1:
        sig = subsample_schedule(sig, args.stride)[0]
    cut = sig.shape[0] * config.sampling.steps_each - res.avg_nmse.shape[-1]

    def trace_step(n):
        return max(int(n) // args.stride - cut, 0)

    db = res.best_nmse_db()
    for i_al, al in enumerate(res.pilot_alpha_range):
        print(f"# pilot_alpha={al}")
        for s, snr in enumerate(res.snr_range):
            line = (f"SNR {snr:6.1f} dB   NMSE {db[0, i_al, s]:7.2f} dB   "
                    f"best step {res.avg_nmse[0, i_al, s].argmin()}")
            if stop_steps is not None:
                known = res.avg_nmse[0, i_al, s, trace_step(stop_steps[s])]
                line += f"   known-SNR stop {10 * np.log10(known):7.2f} dB"
            if blind_step is not None:
                blind = res.avg_nmse[0, i_al, s, trace_step(blind_step)]
                line += (f"   blind stop N={blind_step} "
                         f"{10 * np.log10(blind):7.2f} dB")
            print(line)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
