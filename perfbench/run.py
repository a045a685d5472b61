"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the cell's cards. The
last line of standard output is one JSON object (`correct`, `attempted`,
`failed`, `metrics`, `device`, with --trace 1 `breakdown`, and last the
`checks`: each number compared with the reference beside its limit);
the last lines of standard error repeat the checks. --trace 0 reports
the cell's end-to-end metrics, --trace 1 its per-layer metrics, read
from a profiled unit run after the window.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from .harness import run

    return run(args.workload, args.seed, args.seconds, bool(args.trace),
               T_START)


if __name__ == "__main__":
    sys.exit(main())
