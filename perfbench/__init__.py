"""The benchmark of the PyTorch/CUDA port (`score_based_channels_torch`).

One run is one cell (a configuration under a traffic mix) run once:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, cell, entry point or
per-layer metric is a file of its own, found by its name:
`configs/<config>.json`, `workloads/<cell>.json`, `drivers/<driver>.py`,
`metrics/<metric>.py`; the plain references are in `reference/`. The
harness imports the port (the system under test) and nothing of the JAX
package; `reference/` imports nothing of the port.
"""
