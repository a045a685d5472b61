"""The readings that the comparison's limits are set from, on the card:
for each seed, a cell's set-up and `--units` units of its work, then the
numbers compared for the program against the reference, for the control
(the reference in the precision below the configuration's: "fp8" for a
bfloat16 network, "tf32" for float32; the cell's "control") against the
reference, and for each fault the cell's driver names (`faults()`: for a
training cell half the batch left out, for LDAMP also its staircase left
out or one step late), the reference so broken, against the reference.
One JSON line a seed goes to --out.

    python3 -m perfbench.calibrate --workload <cell> --seeds 11 12 13 [--units 2] [--faults 3] [--out file]

(--faults k: the faults on the first k seeds only; all by default)

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .harness import driver_module, load_json, set_cache_dirs


def readings(cell_name: str, seed: int, units: int,
             faults: bool = True) -> dict:
    cell = load_json("workloads", cell_name)
    config = load_json("configs", cell["config"])
    drv = driver_module(cell["driver"]).Driver(config, cell, seed, "cuda")
    t0 = time.perf_counter()
    drv.setup()
    for _ in range(units):
        drv.unit()
    drv.release()
    out = {"cell": cell_name, "seed": seed,
           "program_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    ref = drv.reference()
    out["reference_s"] = time.perf_counter() - t0
    out["program"] = drv.readings(drv.program(), ref)
    out["control"] = drv.readings(drv.reference(control=cell["control"]),
                                  ref)
    named = drv.faults() if faults and hasattr(drv, "faults") else {}
    for name, kw in named.items():
        out[name] = drv.readings(drv.reference(**kw), ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--units", type=int, default=1)
    p.add_argument("--faults", type=int, default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    set_cache_dirs()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    for i, seed in enumerate(args.seeds):
        line = json.dumps(readings(args.workload, seed, args.units,
                                   args.faults is None or i < args.faults))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
