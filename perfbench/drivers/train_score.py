"""`train-score`: `ScoreTrainer`'s DSM steps through its `TrainChunkRunner`
as `ScoreTrainer.train` runs them: a unit is one chunk of
`log_every_steps` steps (one captured step replayed for each, the batch
gathered on the card from the staged training set, each step's levels
and noise from its seed), the chunk's losses read back, and the EMA
network's validation loss.

Set-up makes the data sets and the weights from the seed, builds the
trainer's state and runner once, and drives them through the first three
steps by the runner's own call (step 0 eager, step 1 captured): these
are the steps the reference follows (`reference/dsm.py`), with the
validation loss after them. The window goes on from step 3 with the same
objects.

The numbers compared (the worst over their parts): each step's loss and
the validation loss, relative to the reference's; the first gradient,
taken from Adam's first moment after one step (mu = 0.1 g), by its worst
leaf and by its lower-quartile leaf; the change of the parameters and of
the EMA over the three steps. A leaf's norm is held against the
reference's leaf norm or the median leaf's, whichever is larger.

The network's 5x5 max pools make the gradient jump where two inputs of a
window are equal to rounding: any two float32 computations, the
reference's own against float64 included, send such a gradient to
different inputs on a row or two of some batches, which moves the leaves
of one level by up to a few percent for that row. The worst-leaf numbers
carry those jumps; the lower-quartile leaf does not, and it is the one
that a precision lost everywhere (TF32) moves.
"""

from __future__ import annotations

import contextlib

import torch

from ..reference import common as rc
from ..reference import dsm, ncsnv2
from ..trace import span
from ..weights import make_weights
from .common import (
    datasets, hermitian_c2, moving_leaves, port_config, quartile_leaf_gap,
    worst, worst_leaf_gap,
)

FIRST = 3  # the steps the reference follows


class Driver:
    def __init__(self, config: dict, cell: dict, seed: int, device):
        self.config, self.cell, self.seed = config, cell, seed
        self.t = cell["traffic"]
        self.dev = torch.device(device)
        self.rng = rc.derive_seed(seed, 6)
        self.attempted = self.failed = 0
        self.stack = contextlib.ExitStack()

    def setup(self) -> None:
        from score_based_channels_torch.diffusion.ema import ema_init
        from score_based_channels_torch.models.ncsnv2 import NCSNv2Deepest
        from score_based_channels_torch.train.score import (
            ScoreTrainer, ScoreTrainState, TrainChunkRunner, make_optimizer,
            matmul_precision)

        cfg = self.cfg = port_config(self.config)
        self.batch = cfg.training.batch_size
        self.chunk = cfg.training.log_every_steps
        with span("data"):
            self.train_raw, self.val_raw, train_ds, val_ds = datasets(
                self.config, cfg, self.seed,
                self.config["data"]["num_pilots"])
            self.x_all = train_ds.network_input().to(self.dev)
            self.x_val = val_ds.network_input().to(self.dev)
        self.n = self.x_all.shape[0]
        self.per_epoch = self.n // self.batch
        with span("weights"):
            self.weights = make_weights(
                ncsnv2.param_specs(cfg.model.ngf, cfg.data.channels),
                self.seed, self.dev)
            model = NCSNv2Deepest(cfg.model, cfg.data.channels).to(self.dev)
            model.load_state_dict(self.weights)
            state = ScoreTrainState(model=model, ema=ema_init(model),
                                    opt=make_optimizer(model, cfg.optim),
                                    step=0)
        self.stack.enter_context(
            matmul_precision(cfg.training.matmul_precision))
        self.trainer = ScoreTrainer(cfg, device=self.dev)
        self.gen = torch.Generator(device=self.dev)
        self.state = state
        self.runner = TrainChunkRunner(
            self.trainer.update, state, self.x_all, self.batch, self.chunk,
            self.gen, self.t["updates"])
        self.perm_epoch, self.perm = -1, None
        with span("first steps"):
            p0 = self._params(model)
            e0 = self._params(state.ema)
            self.losses = self._run(0, 1)
            self.g1 = {k: m / (1.0 - cfg.optim.beta1) for k, m in
                       zip(state.opt.names, state.opt.moments["mu"])}
            self.g1 = {k: v.detach().clone() for k, v in self.g1.items()}
            self.losses += self._run(1, FIRST - 1)
            self.change = {k: v - p0[k] for k, v in
                           self._params(model).items()}
            self.ema_change = {k: v - e0[k] for k, v in
                               self._params(state.ema).items()}
            self.val = self._validate(FIRST)
        self.done = FIRST

    @staticmethod
    def _params(model) -> dict:
        return {k: v.detach().clone() for k, v in model.named_parameters()}

    def _indices(self, steps) -> torch.Tensor:
        idx = []
        for s in steps:
            epoch, i = divmod(s, self.per_epoch)
            if epoch != self.perm_epoch:
                self.perm = torch.randperm(self.n, generator=rc.generator(
                    self.rng, 1, epoch))
                self.perm_epoch = epoch
            idx.append(self.perm[i * self.batch:(i + 1) * self.batch])
        return torch.stack(idx)

    def _run(self, start: int, n: int) -> list:
        steps = range(start, start + n)
        losses = self.runner.run(self._indices(steps),
                                 [rc.derive_seed(self.rng, 2, s)
                                  for s in steps])
        return losses.cpu().tolist()

    def _validate(self, done: int) -> float:
        self.gen.manual_seed(rc.derive_seed(self.rng, 3, done))
        return float(self.trainer.eval_loss(self.state.ema, self.x_val,
                                            self.gen))

    def unit(self) -> dict:
        with span("chunk"):
            losses = self._run(self.done, self.chunk)
        self.done += self.chunk
        with span("validation"):
            v = self._validate(self.done)
        self.attempted += len(losses)
        self.failed += sum(not (x == x and abs(x) < float("inf"))
                           for x in losses + [v])
        return {"done": len(losses), "model": "ncsnv2_deepest",
                "dtype": "float32", "train": {self.batch: len(losses)},
                "forward": {self.x_val.shape[0]: 1}}

    def release(self) -> None:
        self.runner = self.state = self.trainer = None
        self.x_all = None
        self.stack.close()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the comparison -----------------------------------------------
    def program(self) -> dict:
        """What the program's first steps gave."""
        return dict(losses=self.losses, val=self.val, g1=self.g1,
                    change=self.change, ema_change=self.ema_change)

    def faults(self) -> dict:
        """The fault the reference can be put to: half of each batch left
        out of the loss."""
        return {"half_batch": {"half": True}}

    def reference(self, control: str = None, half: bool = False) -> dict:
        """The reference's first steps; `control` "tf32" computes them in
        TF32; `half` takes each loss over half the batch (a fault)."""
        tf32 = control == "tf32"
        cfg = self.config
        tr = self.train_raw
        x_all = hermitian_c2(tr, tr).to(self.dev)
        x_val = hermitian_c2(self.val_raw, tr).to(self.dev)
        s = cfg["sigmas"]
        sig = rc.geometric_sigmas(s["sigma_begin"], s["sigma_rate"],
                                  s["num_classes"]).to(self.dev)
        idx = self._ref_indices(range(FIRST))
        xs = [x_all[i.to(self.dev)] for i in idx]
        gens = [rc.generator(self.rng, 2, k, device=self.dev)
                for k in range(FIRST)]
        t = cfg["training"]
        with rc.precision(tf32):
            losses, g1, p3, e3 = dsm.train_steps(
                self.weights, xs, gens, sig, t["lr"], t["eps"],
                t["ema_rate"], cfg["model"]["ngf"], half=half)
            with torch.no_grad():
                val = float(dsm.dsm_loss(
                    e3, x_val, sig, rc.generator(self.rng, 3, FIRST,
                                                 device=self.dev),
                    cfg["model"]["ngf"], half=half))
        return dict(losses=losses, val=val, g1=g1,
                    change={k: v - self.weights[k] for k, v in p3.items()},
                    ema_change={k: v - self.weights[k]
                                for k, v in e3.items()})

    def _ref_indices(self, steps):
        """The rows of each step, from the epochs' permutations (the same
        seeds as the program's, drawn again)."""
        out = []
        for s in steps:
            epoch, i = divmod(s, self.per_epoch)
            perm = torch.randperm(self.n, generator=rc.generator(
                self.rng, 1, epoch))
            out.append(perm[i * self.batch:(i + 1) * self.batch])
        return out

    @staticmethod
    def readings(got: dict, ref: dict) -> dict:
        keep = moving_leaves(ref["g1"])
        pairs = zip(got["losses"] + [got["val"]], ref["losses"] + [ref["val"]])
        rel = worst(abs(a - b) / abs(b) for a, b in pairs)
        return {
            "loss_gap": rel,
            "grad_gap": worst_leaf_gap(got["g1"], ref["g1"], keep),
            "grad_quartile_gap": quartile_leaf_gap(got["g1"], ref["g1"],
                                                   keep),
            "change_gap": worst_leaf_gap(got["change"], ref["change"],
                                         keep),
            "ema_change_gap": worst_leaf_gap(got["ema_change"],
                                             ref["ema_change"], keep),
        }

    def check(self) -> list:
        r = self.readings(self.program(), self.reference())
        lim = self.cell["limits"]
        return [(k, r[k], lim[k]) for k in lim]
