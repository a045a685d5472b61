"""The `estimate` sweep: `eval/estimate.py::run_snr_sweep`, one whole sweep
a unit (every channel of the cell at every SNR, one chunk of rows through
`langevin_chunked` and its `PosteriorRunner`), as `run_estimation` runs
each (spacing, pilot fraction) of the `estimate` command.

Traffic (the cell's "traffic"): dtype (the network's), stride (every
stride-th noise level, alpha scaled by it), channels, snr_db, chunk,
check_rows (rows compared with the reference after the window), warm_stride
(the set-up's short sweep). Each sweep draws its pilots, initial states,
measurement noise and Langevin noise from (seed, sweep index); the
channels are one validation set made in set-up (`channels.py`), which the
program reads from a channel file and the reference normalises itself.

The comparison: `check_rows` rows drawn from the seed out of every sweep
of the window are run again by the reference (`reference/langevin.py`
with `reference/ncsnv2.py`, float32, TF32 off, the same weights and
draws); each row's estimate and NMSE trace are held against it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import common as rc
from ..reference import langevin, ncsnv2
from ..trace import span
from ..weights import make_weights
from .common import datasets, hermitian_c2, port_config


class Driver:
    def __init__(self, config: dict, cell: dict, seed: int, device):
        self.config, self.cell, self.seed = config, cell, seed
        self.t = cell["traffic"]
        self.dev = torch.device(device)
        self.dtype = getattr(torch, self.t["dtype"])
        # (sweep seed, nmse (S, steps, C), estimates (S, C, Nt, Nr))
        self.sweeps = []
        self.attempted = self.failed = 0

    # ---- set-up -------------------------------------------------------
    def setup(self) -> None:
        from score_based_channels_torch.models.ncsnv2 import NCSNv2Deepest
        from score_based_channels_torch.eval.estimate import (
            score_fn_from_params)

        cfg = self.cfg = port_config(self.config)
        d = self.config["data"]
        with span("data"):
            self.train_raw, self.val_raw, _, self.val_ds = datasets(
                self.config, cfg, self.seed, d["num_pilots"])
        with span("weights"):
            self.weights = make_weights(
                ncsnv2.param_specs(cfg.model.ngf, cfg.data.channels),
                self.seed, self.dev,
                served=None if self.dtype == torch.float32 else self.dtype)
            model = NCSNv2Deepest(cfg.model, cfg.data.channels).to(self.dev)
            model.load_state_dict(self.weights)
            self.score_fn = score_fn_from_params(
                model, None if self.dtype == torch.float32 else self.dtype)
        self.snr = np.asarray(self.t["snr_db"], np.float64)
        with span("warm-up"):  # the cell's shapes, a short schedule
            self._sweep(rc.derive_seed(self.seed, 5), self.t["warm_stride"])
        self.sweeps.clear()

    def _sweep(self, seed: int, stride: int):
        from score_based_channels_torch.eval.estimate import run_snr_sweep

        nmse, est = run_snr_sweep(
            self.score_fn, self.cfg, self.val_ds, self.snr, seed,
            num_channels=self.t["channels"], chunk_size=self.t["chunk"],
            level_stride=stride, init="noise", return_estimates=True,
            device=self.dev)
        return nmse, est

    # ---- the window ---------------------------------------------------
    def levels(self, stride: int) -> int:
        s = self.config["sigmas"]
        return langevin.strided_sigmas(s["sigma_begin"], s["sigma_rate"],
                                       s["num_classes"], stride)[0].shape[0]

    def unit(self) -> dict:
        seed = rc.derive_seed(self.seed, 3, len(self.sweeps))
        with span("sweep"):
            nmse, est = self._sweep(seed, self.t["stride"])
        rows = est.shape[0] * est.shape[1]
        self.sweeps.append((seed, nmse, est))
        self.attempted += rows
        self.failed += int((~np.isfinite(est.reshape(rows, -1))).any(1).sum())
        forwards = self.levels(self.t["stride"]) * \
            self.config["sampling"]["steps_each"]
        return {"done": rows, "model": "ncsnv2_deepest",
                "dtype": self.t["dtype"],
                "forward": {self.t["chunk"]: forwards}}

    def release(self) -> None:
        self.score_fn = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the comparison -----------------------------------------------
    def sample(self):
        """(sweep index, row) pairs drawn from the seed, `check_rows` of
        them (fewer when the window has fewer rows)."""
        rows = self.t["channels"] * len(self.snr)
        total = rows * len(self.sweeps)
        rng = np.random.default_rng(rc.derive_seed(self.seed, 4))
        pick = rng.choice(total, size=min(self.t["check_rows"], total),
                          replace=False)
        return sorted((int(p) // rows, int(p) % rows) for p in pick)

    def program(self) -> dict:
        """The program's final states and NMSE traces of the sampled rows
        (host tensors: (n, Nt, Nr, 2), (steps, n))."""
        C = self.t["channels"]
        xs, ts = [], []
        for k, r in self.sample():
            _, nmse, est = self.sweeps[k]
            s, c = divmod(r, C)
            xs.append(rc.to_c2(est[s, c]))
            ts.append(torch.from_numpy(nmse[s, :, c]))
        return {"x": torch.stack(xs), "trace": torch.stack(ts, dim=1)}

    def reference(self, control: str = None) -> dict:
        """The reference's final states and traces of the sampled rows;
        `control` "fp8" or "tf32" computes them in that lower precision."""
        cfg, C = self.config, self.t["channels"]
        oracle = hermitian_c2(self.val_raw[:C], self.train_raw)
        picks = self.sample()
        groups = []
        for k in sorted({k for k, _ in picks}):
            seed = self.sweeps[k][0]
            inputs = langevin.sweep_inputs(oracle, self.snr, seed,
                                           cfg["data"]["num_pilots"])
            groups.append((inputs, [r for kk, r in picks if kk == k], seed))
        s = cfg["sigmas"]
        sig, scale = langevin.strided_sigmas(
            s["sigma_begin"], s["sigma_rate"], s["num_classes"],
            self.t["stride"])
        W = {k: v.to(self.dev) for k, v in self.weights.items()}
        net = ncsnv2.NCSNv2Deepest(
            W, cfg["model"]["ngf"],
            quant=rc.fp8 if control == "fp8" else rc.identity)
        smp = cfg["sampling"]
        with rc.precision(control == "tf32"):
            out = langevin.posterior_sweeps(
                net, groups, sig, smp["alpha_step"] * scale,
                smp["beta_noise"], smp["steps_each"], self.t["chunk"],
                self.dev)
        return {"x": out["x"].cpu(), "trace": out["trace"].cpu()}

    @staticmethod
    def readings(got: dict, ref: dict) -> dict:
        """The numbers compared: the worst row's estimate error relative
        to the reference's estimate, and the worst gap in dB between the
        NMSE traces over every step of every row."""
        x, rx = got["x"], ref["x"]
        d = (x - rx).flatten(1).norm(dim=1) / rx.flatten(1).norm(dim=1)
        db = (10 * torch.log10(got["trace"].double())
              - 10 * torch.log10(ref["trace"].double())).abs()
        return {"estimate_gap": float(d.max()),
                "nmse_trace_gap_db": float(db.max())}

    def check(self) -> list:
        r = self.readings(self.program(), self.reference())
        lim = self.cell["limits"]
        return [(k, r[k], lim[k]) for k in lim]
