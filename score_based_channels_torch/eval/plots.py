"""Result plotting (reference test_score.py:177-189, plot_ood_results.py),
the counterpart of the JAX package's eval/plots.py and its `plots` command.

Produces:
  - NMSE-vs-SNR curves per pilot_alpha (the Fig. 5c style plot saved as
    results.png by test_score.py:177-189),
  - cross-distribution (OOD) comparison plots in the style of the paper's
    Fig. 7 (plot_ood_results.py:86-141): blind-SNR (one fixed stopping
    step, plot_ood_results.py:12-14) vs known-SNR (per-SNR stopping steps,
    plot_ood_results.py:76-82) curves for multiple test profiles.

Host code only (numpy and matplotlib on saved results files); no device
is used. matplotlib is imported when a figure is drawn, on the Agg
backend, so importing this module needs none.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from .estimate import EstimationResults


def _ensure_dir(path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)


def _pyplot():
    """matplotlib.pyplot on the Agg backend (no display needed)."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    return plt


def plot_nmse_curves(results: EstimationResults, path: str,
                     title: str = "Score-based channel estimation") -> None:
    """Per-alpha NMSE-vs-SNR curves (test_score.py:177-189)."""
    plt = _pyplot()

    plt.rcParams["font.size"] = 14
    plt.figure(figsize=(10, 10))
    for i_al, alpha in enumerate(results.pilot_alpha_range):
        plt.plot(results.snr_range,
                 10 * np.log10(results.best_nmse[0, i_al]),
                 linewidth=4, label=f"Alpha={float(alpha):.2f}")
    plt.grid()
    plt.legend()
    plt.title(title)
    plt.xlabel("SNR [dB]")
    plt.ylabel("NMSE [dB]")
    plt.tight_layout()
    _ensure_dir(path)
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close()


def nmse_at_step(results: EstimationResults, step: int,
                 spacing_idx: int = 0, alpha_idx: int = 0) -> np.ndarray:
    """Blind-SNR selection: NMSE at one fixed stopping step for all SNRs
    (plot_ood_results.py:12-15 semantics). Returns (n_snr,)."""
    return results.avg_nmse[spacing_idx, alpha_idx, :, step]


def nmse_at_per_snr_steps(results: EstimationResults, steps: Sequence[int],
                          spacing_idx: int = 0, alpha_idx: int = 0
                          ) -> np.ndarray:
    """Known-SNR selection: per-SNR stopping steps
    (plot_ood_results.py:76-82, diagonal selection :99-104)."""
    avg = results.avg_nmse[spacing_idx, alpha_idx]
    return np.asarray([avg[s, int(step)] for s, step in enumerate(steps)])


def plot_ood_comparison(
    results_by_profile: Dict[str, EstimationResults],
    path: str,
    blind_step: Optional[int] = None,
    per_snr_steps: Optional[Dict[str, Sequence[int]]] = None,
    alpha_idx: int = 0,
    title: str = "Cross-distribution (OOD) robustness",
) -> None:
    """Overlay NMSE curves of one trained model tested on several profiles.

    results_by_profile: test-profile name → EstimationResults (all from the
    same trained model). If blind_step / per_snr_steps given, plot those
    selections; otherwise the oracle best-step curve.
    """
    plt = _pyplot()

    plt.rcParams["font.size"] = 14
    plt.figure(figsize=(10, 10))
    for name, res in results_by_profile.items():
        if per_snr_steps is not None and name in per_snr_steps:
            curve = nmse_at_per_snr_steps(res, per_snr_steps[name],
                                          alpha_idx=alpha_idx)
            label = f"{name} (known SNR)"
        elif blind_step is not None:
            curve = nmse_at_step(res, blind_step, alpha_idx=alpha_idx)
            label = f"{name} (blind, N={blind_step})"
        else:
            curve = res.best_nmse[0, alpha_idx]
            label = f"{name} (oracle stop)"
        plt.plot(res.snr_range, 10 * np.log10(curve), linewidth=4,
                 label=label)
    plt.grid()
    plt.legend()
    plt.title(title)
    plt.xlabel("SNR [dB]")
    plt.ylabel("NMSE [dB]")
    plt.tight_layout()
    _ensure_dir(path)
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close()


_FLAGSHIP_SOURCES = (
    # label, path, loader(npz) -> (snr (S,), nmse_db (S,))
    ("Score (warm start)", "results/score/fixedcoupling/results_warm.npz",
     lambda d: (d["snr_range"], 10 * np.log10(d["best_nmse"][0, 0]))),
    ("Score (reference protocol)",
     "results/score/fixedcoupling/results.npz",
     lambda d: (d["snr_range"], 10 * np.log10(d["best_nmse"][0, 0]))),
    ("Approx. MMSE (×50, β=1 warm)",
     "results/mmse/CDL-C-fixed-lmmse-beta1.npz",
     lambda d: (d["snr_range"],
                10 * np.log10(d["nmse_mean_est"].mean(-1)))),
    ("LMMSE (empirical cov)", "results/baselines/lmmse_fixed.npz",
     lambda d: (d["snr_range"], 10 * np.log10(d["nmse"].mean(-1)))),
    ("L-DAMP", "results/baselines/ldamp_fixed.npz",
     lambda d: (d["snr_range"], 10 * np.log10(d["nmse"].mean(-1)))),
    ("Lasso (fsAD)", "results/baselines/lasso_fixed.npz",
     lambda d: (d["snr_range"], 10 * np.log10(d["best_nmse"][0]))),
    ("EM-GM-AMP", "results/baselines/amp_fixed.npz",
     lambda d: (d["snr_range"], 10 * np.log10(np.where(
         np.isfinite(d["nmse_trace"].mean(-1)),
         d["nmse_trace"].mean(-1), np.inf).min(-1)))),
    ("WGAN (aligned noise)", "results/baselines/wgan_fixed_aligned.npz",
     lambda d: (d["snr_range"],
                10 * np.log10(d["oracle_log"].mean(-1).min(-1)
                              .min(axis=(0, 1))[0]))),
    ("Regularized LS", "results/baselines/ls_fixed.npz",
     lambda d: (d["snr_range"], 10 * np.log10(d["nmse"][0, 0].mean(-1)))),
)


def plot_flagship(output: str, bound_coupling: str = "fixed",
                  bound_profile: str = "CDL-C"):
    """The paper's actual deliverable (VERDICT r3 item 3): every method on
    ONE dataset/ensemble in one Fig. 5c-style figure + a markdown table
    (reference figures/fig5c_legend.png, README.md:81-85)."""
    plt = _pyplot()

    plt.rcParams["font.size"] = 13
    plt.figure(figsize=(10, 8))
    rows, missing = [], []
    for label, path, load in _FLAGSHIP_SOURCES:
        if not os.path.exists(path):
            missing.append((label, path))
            continue
        with np.load(path) as d:
            snr, db = load(dict(d.items()))
        style = dict(linewidth=3) if label.startswith("Score") else \
            dict(linewidth=1.8, alpha=0.9)
        plt.plot(snr, db, marker="o", markersize=3, label=label, **style)
        rows.append((label, np.asarray(snr, float), np.asarray(db, float)))
    from .chanstats import lmmse_bound_db

    snr_b = np.arange(-10, 32.5, 2.5)
    b = lmmse_bound_db(bound_profile, snr_b, num_pilot_draws=2,
                       ray_coupling=bound_coupling)
    plt.plot(snr_b, b, "k--", linewidth=2,
             label=f"genie bound ({bound_coupling} coupling)")
    rows.append((f"genie bound ({bound_coupling})", snr_b, b))
    plt.grid()
    plt.legend(fontsize=11)
    plt.xlabel("SNR [dB]")
    plt.ylabel("NMSE [dB]")
    plt.title(f"All methods, one ensemble ({bound_coupling} ray coupling)")
    plt.tight_layout()
    _ensure_dir(output)
    plt.savefig(output, dpi=300, bbox_inches="tight")
    plt.close()

    anchors = np.array([-10.0, 0.0, 10.0, 20.0, 30.0])
    print("| method | " + " | ".join(f"{a:+.0f} dB" for a in anchors) + " |")
    print("|---|" + "---|" * len(anchors))
    for label, snr, db in rows:
        cells = []
        for a in anchors:
            i = np.where(np.isclose(snr, a))[0]
            cells.append(f"{db[i[0]]:.2f}" if i.size else "—")
        print(f"| {label} | " + " | ".join(cells) + " |")
    for label, path in missing:
        print(f"# missing: {label} ({path})")
    print(f"saved {output}")


_PILOT_ALPHAS = (1.0, 0.8, 0.6)


def plot_pilot_axis(
    output: str,
    hparams_fmt: str = "results/score/CDL-C-fixed-hyperparameters-a{a}.npz",
    blind_fmt: str = "results/score/fixedcoupling/results_blind_a{a}.npz",
    known_fmt: str = "results/score/fixedcoupling/results_known_a{a}.npz",
    lasso_path: str = "results/baselines/lasso_fixed_allalpha.npz",
    bound_coupling: str = "fixed",
) -> None:
    """The reference's per-pilot-density deliverable (plot_ood_results.py):
    blind-SNR (left: ONE stopping step per α for the whole sweep,
    :12-14) vs known-SNR (right: per-SNR stop tables, :76-82) score
    curves for α ∈ {1.0, 0.8, 0.6}, with the per-α Lasso rows dotted and
    the per-α genie bounds — on one ensemble.

    Blind stop selection: mean-over-SNR dB-NMSE argmin on the TUNE set
    (TuneResults.blind_selection, 50 channels, seed 4321 tune batch);
    the plotted curves are the separate 100-channel estimate runs read
    at that pre-selected step — mirroring the reference's hard-coded
    'Best N' applied to saved runs. Lasso blind iteration chosen by the
    same mean-dB rule from its own per-iteration trace.
    """
    plt = _pyplot()

    plt.rcParams["font.size"] = 13
    fig, axes = plt.subplots(1, 2, figsize=(18, 7.5))
    colors = {1.0: "tab:red", 0.8: "tab:green", 0.6: "tab:blue"}
    markers = {1.0: "*", 0.8: "o", 0.6: "s"}

    lasso = None
    if os.path.exists(lasso_path):
        with np.load(lasso_path) as d:
            lasso = {k: d[k] for k in d.files}

    table_rows = []
    for a in _PILOT_ALPHAS:
        hp_f, bl_f, kn_f = (f.format(a=a) for f in
                            (hparams_fmt, blind_fmt, known_fmt))
        if not all(os.path.exists(f) for f in (hp_f, bl_f, kn_f)):
            print(f"# pilot_axis: missing files for alpha={a}, skipping")
            continue
        with np.load(hp_f) as h:
            blind_step = int(h["blind_step"])
            blind_alpha = float(h["blind_alpha"])
            blind_beta = float(h["blind_beta"])
            known_steps = h["best_step_snr"].astype(int)
        blind = EstimationResults.load(bl_f)
        known = EstimationResults.load(kn_f)
        c, m = colors[a], markers[a]
        snr = blind.snr_range
        blind_db = 10 * np.log10(blind.avg_nmse[0, 0, :, blind_step])
        axes[0].plot(snr, blind_db, color=c, marker=m, linewidth=3,
                     markersize=9, label=rf"Score, $\alpha$={a:.1f}")
        known_db = 10 * np.log10(nmse_at_per_snr_steps(known, known_steps))
        axes[1].plot(known.snr_range, known_db, color=c, marker=m,
                     linewidth=3, markersize=9,
                     label=rf"Score, $\alpha$={a:.1f}")
        table_rows.append((a, blind_step, blind_alpha, blind_beta,
                           snr, blind_db, known_steps, known_db))

        if lasso is not None:
            ia = np.where(np.isclose(lasso["alpha_range"], a))[0]
            if ia.size:
                # complete_log (nA, nL, nR, S, steps, C): best (λ, lr)
                # per α by final-min mean; blind iter by mean-dB rule
                log = lasso["complete_log"][ia[0]]  # (nL, nR, S, steps, C)
                avg = log.mean(-1)  # (nL, nR, S, steps)
                with np.errstate(divide="ignore"):
                    db = 10 * np.log10(
                        np.where(np.isfinite(avg), avg, np.inf))
                sc = db.mean(axis=2)  # (nL, nR, steps)
                iL, iR, it = np.unravel_index(np.argmin(sc), sc.shape)
                axes[0].plot(lasso["snr_range"], db[iL, iR, :, it],
                             color=c, marker=m, markersize=7,
                             linestyle="dotted", linewidth=2,
                             label=rf"Lasso, $\alpha$={a:.1f}")
                known_l = db.min(axis=-1).min(axis=(0, 1))  # (S,)
                axes[1].plot(lasso["snr_range"], known_l, color=c,
                             marker=m, markersize=7, linestyle="dotted",
                             linewidth=2, label=rf"Lasso, $\alpha$={a:.1f}")

        from .chanstats import lmmse_bound_db

        np_pilots = int(np.floor(64 * a))
        snr_b = np.asarray(snr, float)
        b = lmmse_bound_db("CDL-C", snr_b, num_pilots=np_pilots,
                           num_pilot_draws=2, ray_coupling=bound_coupling)
        for ax in axes:
            ax.plot(snr_b, b, color=c, linestyle="dashed", linewidth=1.2,
                    alpha=0.55,
                    label=rf"genie bound, $\alpha$={a:.1f}")

    for ax, title in zip(axes, ("Blind (Unknown SNR)", "Known SNR")):
        ax.grid()
        ax.set_xlabel("SNR [dB]")
        ax.set_ylabel("NMSE [dB]")
        ax.set_title(title)
        ax.legend(fontsize=10)
    fig.tight_layout()
    _ensure_dir(output)
    fig.savefig(output, dpi=300, bbox_inches="tight")
    plt.close(fig)

    # markdown: per-α stop tables + anchor NMSE (the reference's
    # plot_ood_results.py:12-15,76-82 tables, regenerated not hard-coded)
    anchors = np.array([-10.0, 0.0, 10.0, 20.0, 30.0])
    print("| α | blind N | blind (α_step, β) | " +
          " | ".join(f"blind {a:+.0f} dB" for a in anchors) + " |")
    print("|---|---|---|" + "---|" * len(anchors))
    for (a, bs, ba, bb, snr, bdb, ks, kdb) in table_rows:
        cells = [f"{bdb[np.isclose(snr, x)][0]:.2f}" if
                 np.isclose(snr, x).any() else "—" for x in anchors]
        print(f"| {a:.1f} | {bs} | ({ba:.0e}, {bb:.0e}) | " +
              " | ".join(cells) + " |")
    print()
    print("| α | known-SNR stop table (per SNR) | " +
          " | ".join(f"known {a:+.0f} dB" for a in anchors) + " |")
    print("|---|---|" + "---|" * len(anchors))
    for (a, bs, ba, bb, snr, bdb, ks, kdb) in table_rows:
        cells = [f"{kdb[np.isclose(snr, x)][0]:.2f}" if
                 np.isclose(snr, x).any() else "—" for x in anchors]
        print(f"| {a:.1f} | {' '.join(str(int(s)) for s in ks)} | " +
              " | ".join(cells) + " |")
    print(f"saved {output}")


def main(argv=None):
    """CLI: regenerate the committed figures from saved results npz files.

    `plots --compare results/score/train-CDL-C_test-CDL-C/results.npz \
           results_warm.npz --labels reference warm --bound` overlays
    estimate runs (Fig. 5c style) with the corrected analytic genie
    bound; `--ood` builds the cross-profile overlay from the standard
    results layout."""
    import argparse

    p = argparse.ArgumentParser(description="Result plotting")
    p.add_argument("--compare", nargs="+", type=str, default=None,
                   help="results npz files to overlay")
    p.add_argument("--labels", nargs="+", type=str, default=None)
    p.add_argument("--bound", action="store_true",
                   help="overlay the corrected analytic genie bound "
                        "(chanstats, ray_coupling=random)")
    p.add_argument("--bound_profile", type=str, default="CDL-C")
    p.add_argument("--bound_coupling", type=str, default="random",
                   choices=["random", "fixed"],
                   help="ray-coupling ensemble for the --bound curve "
                        "(match the ensemble the results were run on; "
                        "the committed fixed-ensemble fig5c uses 'fixed')")
    p.add_argument("--ood", action="store_true",
                   help="overlay train-CDL-C_test-* oracle-stop curves")
    p.add_argument("--flagship", action="store_true",
                   help="one-ensemble all-methods Fig. 5c figure + table "
                        "from the standard round-4 artifact paths")
    p.add_argument("--pilot_axis", action="store_true",
                   help="per-pilot-density (alpha 1.0/0.8/0.6) blind vs "
                        "known-SNR two-panel figure + stop tables "
                        "(plot_ood_results.py style) from the round-5 "
                        "fixed-ensemble artifact paths")
    p.add_argument("--results_dir", type=str, default="results/score")
    p.add_argument("--suffix", type=str, default="results.npz",
                   help="per-profile results file name for --ood")
    p.add_argument("--output", type=str, required=True)
    args = p.parse_args(argv)

    plt = _pyplot()

    if not any((args.ood, args.compare, args.flagship, args.pilot_axis)):
        p.error("pass --compare <results.npz...>, --ood, --flagship, or "
                "--pilot_axis (nothing to plot)")

    if args.flagship:
        plot_flagship(args.output, bound_coupling=args.bound_coupling,
                      bound_profile=args.bound_profile)
        return

    if args.pilot_axis:
        plot_pilot_axis(args.output)
        return

    if args.ood:
        by_prof = {}
        for prof in ("CDL-C", "CDL-A", "CDL-B", "CDL-D"):
            f = os.path.join(args.results_dir,
                             f"train-CDL-C_test-{prof}", args.suffix)
            if os.path.exists(f):
                by_prof[prof] = EstimationResults.load(f)
        plot_ood_comparison(by_prof, args.output)
        print(f"saved {args.output} ({len(by_prof)} profiles)")
        return

    plt.rcParams["font.size"] = 14
    plt.figure(figsize=(10, 8))
    labels = args.labels or [os.path.basename(f) for f in args.compare]
    snr = None
    for f, lab in zip(args.compare, labels):
        res = EstimationResults.load(f)
        snr = res.snr_range
        plt.plot(snr, res.best_nmse_db()[0, 0], linewidth=3, label=lab)
    if args.bound and snr is not None:
        from .chanstats import lmmse_bound_db

        b = lmmse_bound_db(args.bound_profile, np.asarray(snr),
                           num_pilot_draws=2,
                           ray_coupling=args.bound_coupling)
        plt.plot(snr, b, "k--", linewidth=2,
                 label=f"genie bound ({args.bound_coupling} coupling)")
    plt.grid()
    plt.legend()
    plt.xlabel("SNR [dB]")
    plt.ylabel("NMSE [dB]")
    plt.tight_layout()
    _ensure_dir(args.output)
    plt.savefig(args.output, dpi=300, bbox_inches="tight")
    plt.close()
    print(f"saved {args.output}")


if __name__ == "__main__":
    main()
