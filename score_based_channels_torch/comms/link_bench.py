"""The link's receiver graph against the eager receiver on the card, at
the `link` command's full width (256 packets, Nr 16, Nt 64, 4 streams,
25 iterations, the 9-SNR grid; i.i.d. Rayleigh channels and estimates at
-10 dB NMSE, as chip_smoke.py's link phase makes them):

    python -m score_based_channels_torch.comms.link_bench [--pairs 10]

For each detector it prints
  - ms per receiver call over one sweep each way, the card synchronised
    around every call (the graph's first call runs eagerly, its second
    captures and replays);
  - whole `run_link_simulation` sweeps in `--pairs` pairs, the order of
    the two ways alternating: each way's quartiles in ms, packets/s at
    the medians, and the pairs the graph won.
It needs a card and prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import time

import numpy as np
import torch

from .. import _graph, cplx
from .._device import resolve_device
from . import link
from .ldpc import make_wifi_ldpc

SNRS = np.arange(-10, 12.5, 2.5)


def channels(packets: int, seed: int = 3):
    """(H, H_est) complex64 (packets, 16, 64): unit-power i.i.d. Rayleigh
    channels and estimates at -10 dB NMSE."""
    rng = np.random.default_rng(seed)
    shape = (packets, 16, 64)
    cn = lambda: (rng.standard_normal(shape) + 1j * rng.standard_normal(
        shape)) / np.sqrt(2)
    H = cn().astype(np.complex64)
    return H, (H + np.sqrt(0.1) * cn()).astype(np.complex64)


def call_ms(H, H_est, detector: str, graph: bool, dev) -> list:
    """ms of each receiver call over one sweep (the card synchronised
    around each call), through one receiver as `run_link_simulation`
    keeps it: through its graph, or (graph False) under `_graph.eager()`."""
    from ..eval.estimate import derive_seed

    code = make_wifi_ldpc()
    Ht, He = cplx.from_complex(H).to(dev), cplx.from_complex(H_est).to(dev)
    rx = link.LinkReceiver(code, H.shape[0], H.shape[1], detector=detector,
                           device=dev)
    inner, ms = rx.replayer, []

    def timed():
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        inner()
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)

    rx.replayer = timed
    with contextlib.nullcontext() if graph else _graph.eager():
        for i, snr in enumerate(SNRS):
            gen = torch.Generator(device=dev).manual_seed(derive_seed(0, i))
            link.simulate_packets(gen, Ht, He, float(snr), code,
                                  detector=detector, receiver=rx)
    return ms


def sweep_pairs(H, H_est, detector: str, pairs: int, dev) -> dict:
    """Seconds of whole sweeps, each way, in `pairs` pairs whose order
    alternates (after one warm sweep each way)."""
    def sweep():
        link.run_link_simulation(H, H_est, snr_range=SNRS,
                                 detector=detector, device=dev)

    def eager():
        with _graph.eager():
            sweep()

    secs = {"eager": [], "graph": []}
    ways = {"eager": eager, "graph": sweep}
    eager()
    sweep()
    for i in range(pairs):
        for way in (("eager", "graph") if i % 2 == 0 else ("graph", "eager")):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            ways[way]()
            torch.cuda.synchronize(dev)
            secs[way].append(time.perf_counter() - t0)
    return secs


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--packets", type=int, default=256)
    p.add_argument("--detectors", nargs="+", default=["ml", "kbest",
                                                      "zf-sic"])
    args = p.parse_args(argv)
    dev = resolve_device(None)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"# {card}; torch {torch.__version__}")
    H, H_est = channels(args.packets)
    n_pk = args.packets * len(SNRS)
    for det in args.detectors:
        for way in ("eager", "graph"):
            ms = call_ms(H, H_est, det, way == "graph", dev)
            print(f"{det} {way}: receiver ms a call, first {ms[0]:.2f}, "
                  f"second {ms[1]:.2f}, the other {len(ms) - 2} median "
                  f"{np.median(ms[2:]):.2f} (range {min(ms[2:]):.2f}-"
                  f"{max(ms[2:]):.2f})", flush=True)
        secs = sweep_pairs(H, H_est, det, args.pairs, dev)
        q = {k: np.percentile(np.array(v) * 1e3, [25, 50, 75])
             for k, v in secs.items()}
        wins = sum(g < e for g, e in zip(secs["graph"], secs["eager"]))
        print(f"{det} sweeps, {args.pairs} pairs: " + "; ".join(
            f"{k} median {v[1]:.1f} ms (quartiles {v[0]:.1f}-{v[2]:.1f}), "
            f"{n_pk / v[1] * 1e3:.1f} packets/s" for k, v in q.items())
            + f"; the graph faster in {wins} of {args.pairs}", flush=True)


if __name__ == "__main__":
    main()
