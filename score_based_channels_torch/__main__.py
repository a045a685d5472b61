"""CLI: `python -m score_based_channels_torch <command> [args]`.

Every command of the JAX package, beside the reference scripts they mirror
(each runs on the card by default, `--device cpu` for the plain PyTorch
path; `generate-data`, `chanstats` and `plots` are host computations and
take no device):
  train-score    train_score.py — DSM+EMA score-model training on CDL data
  estimate       test_score.py — annealed-Langevin SNR sweep (incl. OOD)
  tune           tune_hparams_score.py — (alpha, beta, stop) grid search
  train-ldamp    train_ldamp.py — per-SNR LDAMP training
  eval-ldamp     test_ldamp.py — LDAMP NMSE sweep
  train-wgan     train_wgan.py — WGAN prior training
  eval-wgan      test_wgan.py — latent-inversion estimation
  ls             test_ml.py — regularized LS baseline
  lmmse          (extension) — exact LMMSE baseline / warm start
  lasso          test_l1Fourier_lifted.py — lifted-Fourier FISTA baseline
  mmse           test_mmse.py — posterior-averaging approximate MMSE
  amp            matlab/test_em_gm_amp.m — EM-GM-AMP compressed sensing
  link           test_end_to_end.m + testPackets.m: LDPC-coded BER/BLER
                 with estimated vs ideal CSI from `estimate --save_channels`
  generate-data  matlab/generate_data.m — CDL data set files (on the host;
                 --backend auto|torch|native)
  chanstats      generator statistics vs the TR 38.901 analytic tables
  plots          test_score.py:177-189 + plot_ood_results.py: NMSE curves,
                 OOD overlays, the all-methods and pilot-density figures
"""

import sys


def main() -> None:
    if len(sys.argv) < 2:
        print(__doc__)
        raise SystemExit(2)
    cmd, argv = sys.argv[1], sys.argv[2:]
    if cmd == "train-score":
        from .train.score import main as m
    elif cmd == "estimate":
        from .eval.estimate import main as m
    elif cmd == "tune":
        from .eval.tune import main as m
    elif cmd == "train-ldamp":
        from .train.ldamp import main as m
    elif cmd == "eval-ldamp":
        from .eval.ldamp import main as m
    elif cmd == "train-wgan":
        from .train.wgan import main as m
    elif cmd == "eval-wgan":
        from .eval.wgan import main as m
    elif cmd == "ls":
        from .baselines.ls import main as m
    elif cmd == "lmmse":
        from .baselines.lmmse import main as m
    elif cmd == "lasso":
        from .baselines.lasso import main as m
    elif cmd == "mmse":
        from .baselines.mmse import main as m
    elif cmd == "amp":
        from .baselines.amp import main as m
    elif cmd == "link":
        from .comms.link import main as m
    elif cmd == "generate-data":
        from .data.generate import main as m
    elif cmd == "chanstats":
        from .eval.chanstats import main as m
    elif cmd == "plots":
        from .eval.plots import main as m
    else:
        print(__doc__)
        raise SystemExit(f"unknown command: {cmd}")
    m(argv)


if __name__ == "__main__":
    main()
