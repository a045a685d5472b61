"""CLI: `python -m score_based_channels_torch <command> [args]`.

Commands ported so far (each runs on the card by default, `--device cpu`
for the plain PyTorch path where it uses a device):
  train-score    train_score.py — DSM+EMA score-model training on CDL data
  estimate       test_score.py — annealed-Langevin SNR sweep (incl. OOD)
  link           test_end_to_end.m + testPackets.m: LDPC-coded BER/BLER
                 with estimated vs ideal CSI from `estimate --save_channels`
  generate-data  matlab/generate_data.m — CDL data set files (on the host)
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
    elif cmd == "link":
        from .comms.link import main as m
    elif cmd == "generate-data":
        from .data.generate import main as m
    else:
        print(__doc__)
        raise SystemExit(f"unknown or not yet ported command: {cmd}")
    m(argv)


if __name__ == "__main__":
    main()
