"""DSM training on images: `ScoreTrainer`'s update driven by its
`TrainChunkRunner`, as `ScoreTrainer.train` runs it, on a staged image set
(NCSNv2-Deepest at its published FFHQ widths: ngf 128, 256x256x3,
float32 with TF32 off). A unit is one chunk of `chunk` steps (one captured
step replayed for each; each step's batch gathered on the card from the
staged images by the epochs' permutations, its levels and noise from its
seed), the chunk's losses read back.

Traffic (the cell's "traffic"): images (the staged training set),
held_out (images of the EMA's loss), chunk (steps a unit), updates (the
steps the runner's optimizer table holds), block (rows the reference
takes at once). The images are uniform in [0, 1) from the seed, made on
the card; the weights are random from the seed.

Set-up makes the images and the weights, builds the state and the
runner once, and drives them through the first three steps by the
runner's own call (step 0 eager, step 1 captured), then takes the EMA's
loss on the held-out images: what the reference follows
(`reference/dsm_blocked.py`). The window goes on from step 3 with the
same objects.

The numbers compared are `train_score`'s (the first steps' losses and
the EMA's loss, the first gradient by its worst and its lower-quartile
leaf, the change of the parameters and of the EMA over the three steps),
after `release()`.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..reference import common as rc
from ..reference import dsm_blocked, ncsnv2
from ..trace import span
from ..weights import make_weights
from .train_score import FIRST
from .train_score import Driver as _ScoreDriver

ROUTES = ("conv2d_taps", "conv2d_taps.f32_wide",
          "conv2d_taps.f32_wide.dgrad", "instance_norm_plus",
          "instance_norm_plus.two_pass")


def sigma_rate(model: dict) -> float:
    """The geometric rate from sigma_begin to sigma_end over num_classes
    levels (the port's model config and the reference take the rate)."""
    return (model["sigma_end"] / model["sigma_begin"]) ** (
        1.0 / (model["num_classes"] - 1))


def port_config(cfg: dict, chunk: int):
    """The port's `Config` of an image training configuration file."""
    from score_based_channels_torch.config import default_score_config

    c = default_score_config("CDL-C")
    m, t = cfg["model"], cfg["training"]
    model = dataclasses.replace(
        c.model, arch=m["arch"], ngf=m["ngf"], nonlinearity=m["nonlinearity"],
        normalization=m["normalization"], sigma_dist=m["sigma_dist"],
        sigma_begin=float(m["sigma_begin"]), sigma_rate=sigma_rate(m),
        num_classes=m["num_classes"], ema_rate=t["ema_rate"])
    optim = dataclasses.replace(c.optim, **{k: t[k] for k in (
        "optimizer", "lr", "beta1", "beta2", "eps", "weight_decay",
        "amsgrad")})
    training = dataclasses.replace(
        c.training, batch_size=t["batch_size"],
        anneal_power=float(t["anneal_power"]), log_every_steps=chunk,
        matmul_precision="highest")
    data = dataclasses.replace(c.data, channels=cfg["data"]["channels"])
    return c.replace(model=model, optim=optim, training=training, data=data)


class Driver:
    def __init__(self, config: dict, cell: dict, seed: int, device):
        self.config, self.cell, self.seed = config, cell, seed
        self.t = cell["traffic"]
        self.dev = torch.device(device)
        self.rng = rc.derive_seed(seed, 6)
        m, d = config["model"], config["data"]
        self.ngf, self.C = m["ngf"], d["channels"]
        self.size = d["image_size"]
        self.attempted = self.failed = 0
        self.stack = contextlib.ExitStack()

    def images(self):
        """(training images, held-out images), (N, S, S, C) on the card,
        made from the seed."""
        n, held = self.t["images"], self.t["held_out"]
        g = rc.generator(self.seed, 1, device=self.dev)
        x = torch.rand((n + held, self.size, self.size, self.C), generator=g,
                       device=self.dev)
        return x[:n].clone(), x[n:].clone()

    def setup(self) -> None:
        from score_based_channels_torch.diffusion.ema import ema_init
        from score_based_channels_torch.models.ncsnv2 import NCSNv2Deepest
        from score_based_channels_torch.train.score import (
            ScoreTrainer, ScoreTrainState, TrainChunkRunner, make_optimizer,
            matmul_precision)

        cfg = self.cfg = port_config(self.config, self.t["chunk"])
        self.batch = cfg.training.batch_size
        self.chunk = self.t["chunk"]
        with span("data"):
            self.x_all, self.x_val = self.images()
        self.n = self.x_all.shape[0]
        self.per_epoch = self.n // self.batch
        with span("weights"):
            self.weights = make_weights(ncsnv2.param_specs(self.ngf, self.C),
                                        self.seed, self.dev)
            model = NCSNv2Deepest(cfg.model, self.C).to(self.dev)
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
        host = lambda m: {k: v.detach().to("cpu", copy=True) for k, v in
                          m.named_parameters()}
        with span("first steps"):
            p0, e0 = host(model), host(state.ema)
            self.losses = self._run(0, 1)
            self.g1 = {k: (m / (1.0 - cfg.optim.beta1)).cpu() for k, m in
                       zip(state.opt.names, state.opt.moments["mu"])}
            self.losses += self._run(1, FIRST - 1)
            self.change = {k: v - p0[k] for k, v in host(model).items()}
            self.ema_change = {k: v - e0[k] for k, v in
                               host(state.ema).items()}
            del p0, e0
            self.val = self._validate(FIRST)
        self.done = FIRST

    _indices = _ScoreDriver._indices
    _run = _ScoreDriver._run
    _validate = _ScoreDriver._validate
    _ref_indices = _ScoreDriver._ref_indices
    readings = staticmethod(_ScoreDriver.readings)
    program = _ScoreDriver.program
    faults = _ScoreDriver.faults
    check = _ScoreDriver.check

    def unit(self) -> dict:
        from score_based_channels_torch import kernels

        before = kernels.counts()
        with span("chunk"):
            losses = self._run(self.done, self.chunk)
        after = kernels.counts()
        self.done += self.chunk
        self.attempted += len(losses)
        self.failed += sum(not (x == x and abs(x) < float("inf"))
                           for x in losses)
        return {"done": len(losses), "model": "ncsnv2_deepest_ffhq256",
                "dtype": "float32", "train": {self.batch: len(losses)},
                "launches": {k: after[k]["launches"] - before[k]["launches"]
                             for k in ROUTES if k in after}}

    def release(self) -> None:
        self.runner = self.state = self.trainer = None
        self.x_all = self.x_val = None
        self.stack.close()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the comparison -----------------------------------------------
    def reference(self, control: str = None, half: bool = False) -> dict:
        """The reference's first steps and the EMA's loss after them, in
        blocks of `block` rows; `control` "tf32" computes them in TF32;
        `half` takes each loss over half the batch (a fault)."""
        m, t = self.config["model"], self.config["training"]
        x_all, x_val = self.images()
        sig = rc.geometric_sigmas(float(m["sigma_begin"]), sigma_rate(m),
                                  m["num_classes"]).to(self.dev)
        xs = [x_all[i.to(self.dev)] for i in self._ref_indices(range(FIRST))]
        del x_all
        gens = [rc.generator(self.rng, 2, k, device=self.dev)
                for k in range(FIRST)]
        blk = self.t["block"]
        with rc.precision(control == "tf32"):
            losses, g1, p3, e3 = dsm_blocked.train_steps(
                self.weights, xs, gens, sig, t["lr"], t["beta1"], t["beta2"],
                t["eps"], t["ema_rate"], self.ngf, blk, half=half)
            with torch.no_grad():
                val, _ = dsm_blocked.loss_and_grad(
                    e3, x_val, sig, rc.generator(self.rng, 3, FIRST,
                                                 device=self.dev),
                    self.ngf, blk, half=half, grad=False)
        host = lambda d: {k: v.cpu() for k, v in d.items()}
        w = host(self.weights)
        return dict(losses=losses, val=float(val), g1=host(g1),
                    change={k: v.cpu() - w[k] for k, v in p3.items()},
                    ema_change={k: v.cpu() - w[k] for k, v in e3.items()})
