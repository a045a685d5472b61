"""LDAMP training: `train/ldamp.py::train_ldamp_snr`'s loop, an epoch a
unit: the epoch's steps through one `LDAMPStepRunner` (one captured step
replayed for each, the batch made on the host by the data set's
`sample_batch` and staged through pinned buffers), the epoch's losses
read back. At the recipe (200 training channels, batch 128) an epoch is
one step.

Set-up makes the training set (`channels.py`, read by the program from a
channel file) and the weights from the seed, builds the model, the
staircase Adam and the runner once, and drives them by the runner's own
call through the steps the reference follows (`reference/ldamp.py`):
the first three, and on past the staircase's first drop (x0.1 after
`decay_epochs` epochs) by two steps, 18 at the recipe. The window goes
on from there with the same objects; each step does the same work
whatever its rate.

The numbers compared: each of the first three steps' MSE and NMSE
relative to the reference's (later steps' losses drift apart with the
parameters: 6.2e-3 at worst over 18 steps, too near the faults); the
first gradient, from Adam's first moment after one
step; the change of the parameters over the first three steps, and over
the two steps after the drop (the decayed rate's row of the optimizer's
table and the step it starts at); the worst leaf, against the
reference's leaf norm or the median leaf's.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..reference import common as rc
from ..reference import ldamp as ref_ldamp
from ..trace import span
from ..weights import make_weights
from .common import (
    moving_leaves, port_config, program_dataset, raw_channels, worst,
    worst_leaf_gap,
)

FIRST = 3  # the first steps, whose losses and change are compared


class Driver:
    def __init__(self, config: dict, cell: dict, seed: int, device):
        self.config, self.cell, self.seed = config, cell, seed
        self.t = cell["traffic"]
        self.dev = torch.device(device)
        self.bseed = rc.derive_seed(seed, 7)
        self.attempted = self.failed = 0
        self.stack = contextlib.ExitStack()

    def setup(self) -> None:
        from score_based_channels_torch.models.ldamp import LDAMP
        from score_based_channels_torch.train.ldamp import (
            LDAMPStepRunner, LDAMPTrainConfig, make_ldamp_optimizer)
        from score_based_channels_torch.train.score import matmul_precision

        m, tr, d = (self.config[k] for k in ("model", "training", "data"))
        cfg = port_config(self.config)
        self.tc = LDAMPTrainConfig(
            alpha=d["pilot_alpha"], max_unrolls=m["unrolls"],
            chans=m["chans"], num_pools=m["num_pools"],
            shared_nets=m["shared_nets"], lr=tr["lr"],
            batch_size=tr["batch_size"], decay_epochs=tr["decay_epochs"],
            decay_gamma=tr["decay_gamma"])
        snr = self.t["snr_db"]
        self.noise_std = 10 ** (-snr / 20.0) * np.sqrt(d["num_tx"])
        with span("data"):
            data = dataclasses.replace(cfg.data,
                                       noise_std=float(self.noise_std),
                                       num_pilots=d["num_pilots"])
            self.raw = raw_channels(self.config, self.seed, 1)
            self.ds = program_dataset(
                self.raw, data, rc.derive_seed(self.seed, 8) % 2**31,
                "global")
        self.bs = min(self.tc.batch_size, len(self.ds))
        self.per_epoch = max(1, len(self.ds) // self.bs)
        # the first step at the decayed rate, and the steps followed
        self.drop = max(1, len(self.ds) // tr["batch_size"]) * \
            tr["decay_epochs"]
        self.marks = sorted({1, FIRST, self.drop, self.drop + 2})
        with span("weights"):
            self.weights = make_weights(
                ref_ldamp.param_specs(m["unrolls"], m["chans"],
                                      m["num_pools"]), self.seed, self.dev)
            model = LDAMP(max_unrolls=m["unrolls"],
                          shared_nets=m["shared_nets"], chans=m["chans"],
                          num_pools=m["num_pools"]).to(self.dev)
            model.load_state_dict(self.weights)
        self.stack.enter_context(matmul_precision("highest"))
        opt = make_ldamp_optimizer(model, self.tc,
                                   max(1, len(self.ds) // self.tc.batch_size))
        self.model, self.opt = model, opt
        self.runner = LDAMPStepRunner(model, opt,
                                      torch.Generator(device=self.dev),
                                      self.per_epoch, self.t["updates"])
        self.step = 0
        with span("first steps"):
            self.losses, self.snaps = [], {}
            for mark in self.marks:  # an epoch a call, as the window runs
                while self.step < mark:
                    self.losses += self._steps(
                        min(self.per_epoch, mark - self.step))
                self.snaps[mark] = {k: v.detach().clone()
                                    for k, v in model.named_parameters()}
                if mark == 1:
                    self.g1 = {k: (mu / (1.0 - tr["beta1"])).detach().clone()
                               for k, mu in zip(opt.names,
                                                opt.moments["mu"])}

    def _batch(self, s: int):
        from score_based_channels_torch.train.ldamp import ldamp_batch

        return ldamp_batch(self.ds, rc.generator(self.bseed, 1, s), self.bs,
                           "cpu")

    def _steps(self, n: int) -> list:
        steps = range(self.step, self.step + n)
        rows = self.runner.run((self._batch(s) for s in steps),
                               [rc.derive_seed(self.bseed, 2, s)
                                for s in steps])
        self.step += n
        return rows.cpu().numpy().tolist()

    def unit(self) -> dict:
        with span("epoch"):
            rows = self._steps(self.per_epoch)
        self.attempted += len(rows)
        self.failed += int((~np.isfinite(np.asarray(rows))).any(1).sum())
        return {"done": len(rows), "model": "ldamp_unet", "dtype": "float32",
                "unrolled": {self.bs: len(rows)},
                "unrolls": self.tc.max_unrolls}

    def release(self) -> None:
        self.runner = self.model = self.opt = None
        self.stack.close()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the comparison -----------------------------------------------
    @staticmethod
    def _changes(snaps: dict, p0: dict, drop: int) -> dict:
        return dict(
            change={k: v - p0[k] for k, v in snaps[FIRST].items()},
            decay_change={k: v - snaps[drop][k]
                          for k, v in snaps[drop + 2].items()})

    def program(self) -> dict:
        """What the program's followed steps gave."""
        return dict(losses=self.losses, g1=self.g1,
                    **self._changes(self.snaps, self.weights, self.drop))

    def faults(self) -> dict:
        """The faults the reference can be put to (`reference`'s keywords):
        half of each batch left out of the loss; the staircase left out;
        its drop one step late."""
        return {"half_batch": {"half": True}, "no_decay": {"decay": (1.0, 0)},
                "late_decay": {"decay": (None, 1)}}

    def reference(self, control: str = None, half: bool = False,
                  decay=(None, 0)) -> dict:
        """The reference's followed steps; `control` "tf32" computes them
        in TF32; `half` takes each loss over half the batch and `decay`
        (a factor in place of the configuration's, a delay in steps)
        moves the staircase: faults the comparison must catch."""
        tf32 = control == "tf32"
        d, tr = self.config["data"], self.config["training"]
        amp = self.noise_std / np.sqrt(2.0)
        steps = self.marks[-1]
        batches = []
        for s in range(steps):
            b = ref_ldamp.batch(self.raw, rc.generator(self.bseed, 1, s),
                                self.bs, d["num_pilots"], amp)
            batches.append({k: v.to(self.dev) for k, v in b.items()})
        gens = [rc.generator(self.bseed, 2, s, device=self.dev)
                for s in range(steps)]
        gamma = np.float32(tr["decay_gamma"] if decay[0] is None
                           else decay[0])
        per = self.drop + decay[1]
        lr = lambda t: float(np.float32(tr["lr"])  # noqa: E731
                             * gamma ** np.float32(t // per))
        with rc.precision(tf32):
            losses, g1, snaps = ref_ldamp.train_steps(
                self.weights, batches, gens, lr, tr["eps"],
                self.config["model"]["unrolls"], half=half, keep=self.marks)
        return dict(losses=losses, g1=g1,
                    **self._changes(snaps, self.weights, self.drop))

    @staticmethod
    def readings(got: dict, ref: dict) -> dict:
        keep = moving_leaves(ref["g1"])
        rel = worst(abs(a - b) / abs(b) for pa, pb in
                    zip(got["losses"][:FIRST], ref["losses"][:FIRST])
                    for a, b in zip(pa, pb))
        return {
            "loss_gap": rel,
            "grad_gap": worst_leaf_gap(got["g1"], ref["g1"], keep),
            "change_gap": worst_leaf_gap(got["change"], ref["change"],
                                         keep),
            "decay_change_gap": worst_leaf_gap(
                got["decay_change"], ref["decay_change"], keep),
        }

    def check(self) -> list:
        r = self.readings(self.program(), self.reference())
        lim = self.cell["limits"]
        return [(k, r[k], lim[k]) for k in lim]
